"""Positional encodings: sinusoidal and learned (added to the embeddings),
RoPE (rotating queries and keys) and ALiBi (an additive attention bias).

PyTorch counterpart of pasero_tpu/models/positional.py:21-122. T5 relative
buckets come with a later slice (ROADMAP.md, A.8).
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


# -- ALiBi --------------------------------------------------------------------

def alibi_slopes(num_heads: int, max_bias: int = 8) -> np.ndarray:
    """Geometric head slopes (pasero_tpu/models/positional.py:94):
    slope_h = 2^(-max_bias * (h + 1) / num_heads)."""
    return np.asarray([2 ** (-max_bias * (h + 1) / num_heads)
                       for h in range(num_heads)], dtype=np.float32)


def alibi_bias(num_heads: int, q_positions: torch.Tensor,
               k_positions: torch.Tensor, max_bias: int = 8,
               causal: bool = True) -> torch.Tensor:
    """Additive float32 attention bias (B, H, Sq, Sk) = -slope * |k - q|
    (pasero_tpu/models/positional.py:101), symmetric: the causal mask removes
    the future side.

    Non-causal (encoder) self-attention breaks the symmetry with the
    half-head trick: the first half of the heads sees only the left context
    (k <= q), the second half only the strict right context (k > q); the
    other side gets -1e9."""
    slopes = torch.from_numpy(alibi_slopes(num_heads, max_bias)).to(
        q_positions.device)
    rel = (k_positions[:, None, None, :]
           - q_positions[:, None, :, None]).float()        # (B, 1, Sq, Sk)
    bias = -rel.abs() * slopes[None, :, None, None]
    if not causal:
        left = torch.arange(num_heads, device=rel.device)[None, :, None, None] \
            < num_heads // 2
        future = rel > 0
        bias = bias.masked_fill(torch.where(left, future, ~future), -1e9)
    return bias
