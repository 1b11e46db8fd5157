"""Host-side data pipeline: files and batching (the line index and samplers
of pasero_tpu/data come with the training slice)."""

from .batching import (bucket_length, build_batches, length_buckets,
                       pad_to_bucket)
from .files import File, JSONLFile, NumpyFile
