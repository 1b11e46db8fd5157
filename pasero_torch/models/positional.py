"""Positional encodings: sinusoidal and learned (added to the embeddings),
RoPE (rotating queries and keys), ALiBi (an additive attention bias) and
T5's learned relative-position buckets.

PyTorch counterpart of pasero_tpu/models/positional.py.
"""

from __future__ import annotations

import functools
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
    other side gets -1e9.

    Its rows lie a multiple of four floats apart (padded past Sk), so that
    the flash kernels read them by TMA at every key length."""
    slopes = torch.from_numpy(alibi_slopes(num_heads, max_bias)).to(
        q_positions.device)
    rel = (k_positions[:, None, None, :]
           - q_positions[:, None, :, None]).float()        # (B, 1, Sq, Sk)
    B, _, Sq, Sk = rel.shape
    bias = torch.empty(B, num_heads, Sq, -(-Sk // 4) * 4,
                       device=rel.device)[..., :Sk]
    torch.mul(rel.abs(), -slopes[None, :, None, None], out=bias)
    if not causal:
        left = torch.arange(num_heads, device=rel.device)[None, :, None, None] \
            < num_heads // 2
        future = rel > 0
        bias.masked_fill_(torch.where(left, future, ~future), -1e9)
    return bias


# -- T5 relative position buckets --------------------------------------------

def t5_bucket(relative_position: np.ndarray, bidirectional: bool,
              num_buckets: int = 32, max_distance: int = 128) -> np.ndarray:
    """T5 bucket ids (int32) of relative positions q - k
    (pasero_tpu/models/positional.py:125), in numpy on the host: the log is
    taken in float32 with JAX's constants (the ``+ 1e-6`` and the Python
    double ``log(max_distance / max_exact)`` rounded to float32), so the
    bucket boundaries fall where JAX's do."""
    n = -np.asarray(relative_position, dtype=np.int32)
    ret = np.zeros_like(n)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).astype(np.int32) * num_buckets
        n = np.abs(n)
    else:
        n = np.maximum(n, 0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    with np.errstate(divide="ignore"):
        log_ratio = np.log(n.astype(np.float32) / np.float32(max_exact)
                           + np.float32(1e-6)) \
            / np.float32(math.log(max_distance / max_exact))
    val_large = max_exact + (log_ratio * np.float32(num_buckets - max_exact)
                             ).astype(np.int32)
    val_large = np.minimum(val_large, num_buckets - 1)
    return (ret + np.where(is_small, n, val_large)).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _distance_buckets(Sq: int, Sk: int, bidirectional: bool,
                      num_buckets: int, max_distance: int,
                      device: str) -> torch.Tensor:
    d = np.arange(-(Sq - 1), Sk, dtype=np.int32)       # k - q
    return torch.from_numpy(t5_bucket(-d, bidirectional, num_buckets,
                                      max_distance)).to(device)


def t5_distance_buckets(Sq: int, Sk: int, bidirectional: bool,
                        num_buckets: int, max_distance: int,
                        device=None) -> torch.Tensor:
    """The bucket of every key-query distance of an (Sq, Sk) attention:
    int32 of length Sq + Sk - 1 whose entry k - q + Sq - 1 is the bucket of
    query slot q and key slot k. O(S), computed once per key on the host and
    kept on ``device`` (callers must not write to it); the plain path, the
    materialized bias and the flash kernels all read it, so no
    transcendental runs on the device."""
    return _distance_buckets(Sq, Sk, bool(bidirectional), num_buckets,
                             max_distance, str(torch.device(device or "cpu")))


def t5_bias_from_table(table: torch.Tensor, q_positions: torch.Tensor,
                       k_positions: torch.Tensor, bidirectional: bool,
                       num_buckets: int = 32,
                       max_distance: int = 128) -> torch.Tensor:
    """The float32 bias (B, H, Sq, Sk) = table[bucket(q - k)] of positions
    (B, Sq) and (B, Sk) (pasero_tpu/models/positional.py:173). Distances
    are clipped to +-max_distance first: every bucket saturates there (its
    last bucket of each side), so the clip changes no bucket and one index
    of 2 max_distance + 1 entries serves any positions."""
    M = max_distance
    index = t5_distance_buckets(M + 1, M + 1, bidirectional, num_buckets, M,
                                table.device)
    d = (k_positions[:, None, :] - q_positions[:, :, None]).clamp(-M, M) + M
    bias = table.float()[index[d].long()]                  # (B, Sq, Sk, H)
    return bias.permute(0, 3, 1, 2)


class T5RelativeBias(nn.Module):
    """The learned (num_buckets, H) relative-position table, shared by the
    layers of a stack (pasero_tpu/models/positional.py:145); its parameter
    is ``rel_embedding``, float32, as the flax module's."""

    def __init__(self, num_heads: int, bidirectional: bool,
                 num_buckets: int = 32, max_distance: int = 128):
        super().__init__()
        self.bidirectional = bidirectional
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.rel_embedding = nn.Parameter(
            torch.randn(num_buckets, num_heads) * 0.02)

    def forward(self, q_positions, k_positions):
        """The materialized bias (B, H, Sq, Sk) of the positions."""
        return t5_bias_from_table(self.rel_embedding, q_positions,
                                  k_positions, self.bidirectional,
                                  self.num_buckets, self.max_distance)

    def rel_table(self):
        """The table with its bucketing constants, as the flash kernels
        take it (``ops.flash_attention.T5Bias``)."""
        from ..ops.flash_attention import T5Bias
        return T5Bias(self.rel_embedding, self.bidirectional,
                      self.num_buckets, self.max_distance)
