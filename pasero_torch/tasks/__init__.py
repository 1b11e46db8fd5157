"""Tasks: preprocessing/collation/corpora/metrics per task type.

Translation, language modeling, dialogue and speech translation are ported
so far; the other pasero_tpu tasks are listed in ROADMAP.md."""

from .task import Corpus, InferenceCorpus, Task
from .translation import (InferenceParallelCorpus, ParallelCorpus,
                          TranslationTask)
from .language_modeling import (InferenceMonolingualCorpus,
                                LanguageModelingTask, MonolingualCorpus)
from .speech_translation import SpeechCorpus, SpeechTranslationTask
from .dialogue import DialogueTask
