"""Positional encodings: sinusoidal and learned (added to the embeddings) and
RoPE (rotating queries and keys).

PyTorch counterpart of pasero_tpu/models/positional.py:21-89. ALiBi and T5
relative buckets come with later slices (ROADMAP.md, A.8).
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


def rope_frequencies(head_dim: int, base: float = 10000.0) -> np.ndarray:
    return 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10000.0) -> torch.Tensor:
    """Rotate-half rotary embedding (pasero_tpu/models/positional.py:71):
    cos/sin of cat(freqs, freqs) and rotate(x) = [-x2, x1], computed in
    float32 and cast back to x's type.

    x: (B, H, S, D); positions: (B, S) absolute positions."""
    head_dim = x.shape[-1]
    freqs = torch.from_numpy(rope_frequencies(head_dim, base).astype(
        np.float32)).to(x.device)
    angles = positions[:, None, :, None].float() * freqs     # (B, 1, S, D/2)
    angles = torch.cat([angles, angles], dim=-1)             # (B, 1, S, D)
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x32 * torch.cos(angles) + rotated * torch.sin(angles)).to(x.dtype)
