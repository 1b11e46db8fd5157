"""Additive positional encodings: sinusoidal and learned.

PyTorch counterpart of pasero_tpu/models/positional.py:21-62. RoPE, ALiBi and
T5 relative buckets come with the decoder-only slice (ROADMAP.md, A.8).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def sinusoidal_table(max_len: int, dim: int, shift: int = 2) -> np.ndarray:
    """fairseq-style sinusoidal embeddings (half sin, half cos), with positions
    shifted by ``shift`` (pasero positional_encoding_shift, default 2)."""
    half = dim // 2
    freq = np.exp(np.arange(half) * -(math.log(10000.0) / max(half - 1, 1)))
    positions = np.arange(shift, max_len + shift)[:, None] * freq[None, :]
    table = np.concatenate([np.sin(positions), np.cos(positions)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((max_len, 1))], axis=1)
    return table.astype(np.float32)


class PositionalEmbedding(nn.Module):
    """Sinusoidal (fixed) or learned positions added to embeddings.

    Positions are clipped to the table as in pasero_tpu: sinusoidal rows
    already carry the shift, learned rows are indexed at ``position + shift``.
    """

    def __init__(self, kind: str, max_len: int, dim: int, shift: int = 2):
        super().__init__()
        self.kind, self.max_len, self.shift = kind, max_len, shift
        if kind == "sinusoidal":
            self.register_buffer("table", torch.from_numpy(
                sinusoidal_table(max_len + shift, dim, shift)),
                persistent=False)
        elif kind == "learned":
            self.embedding = nn.Parameter(
                torch.randn(max_len + shift, dim) * dim ** -0.5)
        else:
            raise ValueError(kind)

    def forward(self, x, positions):
        """x: (B, S, D); positions: (B, S) integer absolute positions."""
        if self.kind == "sinusoidal":
            pe = self.table[positions.clamp(0, self.max_len - 1)]
        else:
            pe = self.embedding[(positions + self.shift).clamp(
                0, self.max_len + self.shift - 1)]
        return x + pe.to(x.dtype)
