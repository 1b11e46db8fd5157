# Copy of pasero_tpu/data/batching.py, verbatim.
"""Batch construction: token-budget batching + TPU shape bucketing.

``build_batches`` reproduces the reference semantics (pasero/utils.py:783-844):
padding-aware token budget, ``batch_size_multiple`` and ``lines_per_batch``.

On top of it, ``pad_to_bucket`` snaps padded sequence lengths to a geometric
bucket ladder and row counts to a multiple, so the jitted train/decode step
sees a small closed set of shapes — XLA compiles each bucket once instead of
recompiling on every free-form batch (SURVEY.md §7 'bucketing replaces
free-form build_batches').
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np


def build_batches(indices, size_fn: Callable, batch_size: int,
                  batch_size_multiple: Optional[int] = None,
                  max_lines: Optional[int] = None) -> list[list[int]]:
    """Group indices into batches with padded-size <= batch_size."""
    batch_size_multiple = batch_size_multiple or 1
    batches: list[list[int]] = []
    batch: list[int] = []
    lengths: list[int] = []
    max_len = 0
    for idx in indices:
        size = size_fn(idx)
        if size > batch_size:  # cannot fit even alone
            continue
        lengths.append(size)
        max_len = max(max_len, size)
        if (max_lines and len(batch) >= max_lines) or \
                max_len * (len(batch) + 1) > batch_size:
            keep = max(batch_size_multiple * (len(batch) // batch_size_multiple),
                       len(batch) % batch_size_multiple)
            batches.append(batch[:keep])
            batch = batch[keep:]
            lengths = lengths[keep:]
            max_len = max(lengths) if lengths else 0
        batch.append(idx)
    if batch:
        batches.append(batch)
    return batches


def length_buckets(max_len: int, min_len: int = 16, factor: float = 1.3,
                   multiple: int = 1) -> list[int]:
    """Geometric ladder of padded lengths ending exactly at max_len.

    `multiple` rounds every rung up (context parallelism needs the padded
    sequence length divisible by the 'seq' mesh axis)."""
    def up(x):
        return int(math.ceil(x / multiple)) * multiple
    top = up(max_len)
    buckets = [up(min(min_len, max_len))]
    while buckets[-1] < top:
        buckets.append(min(top, up(max(buckets[-1] + 1,
                                       int(math.ceil(buckets[-1] * factor))))))
    return buckets


def bucket_length(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def pad_to_bucket(arrays: list[np.ndarray], buckets: Sequence[int],
                  pad_value: int, rows_multiple: int = 8,
                  dtype=np.int32) -> tuple[np.ndarray, np.ndarray]:
    """Stack variable-length 1-D (or 2-D feature) arrays into a padded batch
    whose time dim is a bucket size and row count a multiple of rows_multiple.

    Returns (batch, mask) with mask True at real positions. Padded rows are
    entirely False in the mask (lockstep dummy rows, harmless to the loss).
    """
    n = len(arrays)
    rows = max(rows_multiple, int(math.ceil(n / rows_multiple)) * rows_multiple)
    max_len = max(a.shape[0] for a in arrays)
    time = bucket_length(max_len, buckets)
    feature_dims = arrays[0].shape[1:] if arrays[0].ndim > 1 else ()
    batch = np.full((rows, time) + feature_dims, pad_value,
                    dtype=arrays[0].dtype if feature_dims else dtype)
    mask = np.zeros((rows, time), dtype=bool)
    for i, a in enumerate(arrays):
        batch[i, :a.shape[0]] = a
        mask[i, :a.shape[0]] = True
    return batch, mask
