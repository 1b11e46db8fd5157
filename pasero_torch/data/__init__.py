"""Host-side data pipeline: files, batching, the line index and samplers
(pasero_tpu/data)."""

from .batching import (bucket_length, build_batches, length_buckets,
                       pad_to_bucket)
from .files import File, JSONLFile, NumpyFile
from .line_index import LineIndex
from .samplers import CorpusSampler, LineReader, LineSampler
