"""Tasks: preprocessing/collation/corpora/metrics per task type.

Translation, language modeling and dialogue are ported so far; the other
pasero_tpu tasks are listed in ROADMAP.md."""

from .task import Corpus, InferenceCorpus, Task
from .translation import (InferenceParallelCorpus, ParallelCorpus,
                          TranslationTask)
from .language_modeling import (InferenceMonolingualCorpus,
                                LanguageModelingTask, MonolingualCorpus)
from .dialogue import DialogueTask
