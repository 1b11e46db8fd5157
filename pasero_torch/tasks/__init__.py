"""Tasks: preprocessing/collation/corpora/metrics per task type.

Only translation is ported so far; the other pasero_tpu tasks are listed in
ROADMAP.md."""

from .task import Corpus, InferenceCorpus, Task
from .translation import (InferenceParallelCorpus, ParallelCorpus,
                          TranslationTask)
