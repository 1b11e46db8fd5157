"""Multi-head attention with grouped K/V heads, RoPE, additive biases
(ALiBi), T5's relative-position table, sliding windows, a fixed-size KV
cache and lineage beam attention.

PyTorch counterpart of pasero_tpu/models/attention.py. As there:

- the self-attention cache is a fixed-size (B, H, L, D) buffer written at a
  running slot index; prompts are LEFT-padded, so every row writes the same
  slot, and the caller's kv mask marks left-pad slots invalid;
- masks are boolean (True = attend) and biases additive float32, added to
  the scaled scores before the mask; causality and the sliding window come
  from positions on the plain path, from slot indices in the flash kernels;
- a T5 table (``T5Bias``) reaches the flash kernels as it is, which bucket
  slot distances themselves; every other path materializes the bias from
  the call's positions (pasero_tpu/models/attention.py:186-201);
- attention scores, their softmax and the tied logits are float32 products
  of ``dtype`` operands (flax's ``preferred_element_type=float32``);
- ``kernel`` picks the full forward's attention: 'xla' (the plain path),
  'flash' (ops/flash_attention.py: the CUDA kernels on the card, their plain
  version on the CPU) or 'auto', with JAX's rule (flash for grouped K/V
  heads without a bias from Sq * Sk >= 1024^2, for any heads from 4096^2,
  never under live attention dropout or at decode).

The cache lives in ``KVCache`` objects that the caller creates and passes,
and is updated in place: each single-token write goes through the
``cache_slot_write_`` kernel, a multi-token prompt block is a slice copy.
The cross-attention K/V are computed once, on the first decode call, and
kept.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import not_ported
from ..ops.cache_update import cache_slot_write_
from ..ops.flash_attention import T5Bias, flash_attention
from .modules import Dropout, Linear
from .positional import apply_rope, t5_bias_from_table

NEG_INF = -1e9  # large finite value: safe for padded rows (softmax of all -1e9 is uniform, masked later)


class KVCache:
    """Decode-time K/V of one attention layer.

    Self-attention (``length > 0``): zero-filled (B, H, length, D) buffers
    written at ``index``. Cross-attention (``length == 0``): ``key``/``value``
    stay None until the first decode call stores the encoder's K/V.
    """

    def __init__(self, batch: int, heads: int, head_dim: int, length: int,
                 dtype: torch.dtype, device):
        self.length = length
        self.index = 0
        self.key = self.value = None
        if length > 0:
            shape = (batch, heads, length, head_dim)
            self.key = torch.zeros(shape, dtype=dtype, device=device)
            self.value = torch.zeros(shape, dtype=dtype, device=device)


def lineage_attention(q, k_cache, v_cache, lineage, mask=None, bias=None,
                      scale=1.0):
    """Beam-search decode attention without cache reordering
    (pasero_tpu/models/attention.py:38).

    Cache rows stay where they were written; ``lineage[b, k, s]`` names the
    physical row (within sentence b's K-row block) that holds logical beam
    k's key/value at slot s. Scores are computed against all K physical rows
    and the lineage is selected on the float32 score matrix: slot (p, l) is
    attendable by logical beam k iff ``lineage[b, k, l] == p`` (and the kv
    mask allows l), and one softmax runs over the joint (p, l) axes.

    q: (B*K, H, 1, D); k_cache/v_cache: (B*K, H, L, D);
    lineage: (B, K, L) integer; mask: bool (B*K, 1, 1, L);
    bias: float (B*K, H|1, 1, L). Returns (B*K, H, 1, D).
    """
    B, K, L = lineage.shape
    H, D = q.shape[1], q.shape[-1]
    kb = k_cache.reshape(B, K, H, L, D)          # physical rows p == dim 1
    vb = v_cache.reshape(B, K, H, L, D)
    qb = q.reshape(B, K, H, D).transpose(1, 2)[:, None]      # (B, 1, H, K, D)
    # scores[b, p, h, k, l]
    scores = torch.matmul(qb.float(), kb.float().transpose(-1, -2)) * scale
    if bias is not None:
        # the bias depends on the slot l only, not on the physical row
        bias_t = bias.reshape(B, K, bias.shape[1], L).transpose(1, 2)
        scores = scores + bias_t[:, None].float()
    # (B, P, K, L) True where physical row p holds beam k's slot l
    sel = lineage[:, None] == torch.arange(K, device=lineage.device)[
        None, :, None, None]
    if mask is not None:
        sel = sel & mask.reshape(B, K, L)[:, None]     # per logical beam k
    scores = scores.masked_fill(~sel[:, :, None], NEG_INF)
    m = scores.amax(dim=(1, 4), keepdim=True)
    e = torch.exp(scores - m)
    weights = e / e.sum(dim=(1, 4), keepdim=True)
    # per-physical-row partial outputs, then a reduction over p: weights of
    # non-selected (p, l) are exactly zero, so the sum is exact
    out_p = torch.matmul(weights.to(vb.dtype), vb)            # (B, P, H, K, D)
    out = out_p.sum(dim=1).transpose(1, 2)                    # (B, K, H, D)
    return out.reshape(B * K, H, 1, D)


def dot_product_attention(q, k, v, mask=None, bias=None, scale=1.0,
                          dropout=None):
    """Plain attention (pasero_tpu/models/attention.py:101).
    q: (B, H, Sq, D), k/v: (B, H, Sk, D); mask: bool (B, 1|H, Sq, Sk),
    True = attend; bias: float (B|1, H|1, Sq, Sk); ``dropout``: a
    ``Dropout`` on the float32 weights."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    if dropout is not None:
        weights = dropout(weights)
    return torch.matmul(weights.to(v.dtype), v)


class MultiheadAttention(nn.Module):
    """Multi-head attention (pasero_tpu/models/attention.py:122) with
    grouped K/V heads (``kv_heads``), RoPE on self-attention (``rope_base``),
    an additive bias (ALiBi) or T5's table, a sliding window, the kernel
    choice, and the decode caches of ``_update_cache`` (:317)."""

    def __init__(self, embed_dim: int, num_heads: int, use_bias: bool = True,
                 key_bias: bool = True, scale_attn: bool = True,
                 max_qkv: Optional[float] = None, causal: bool = False,
                 cross_attention: bool = False,
                 dtype: torch.dtype = torch.bfloat16, dropout: float = 0.0,
                 kv_heads: Optional[int] = None,
                 rope_base: Optional[float] = None,
                 sliding_window: Optional[int] = None, kernel: str = "auto"):
        super().__init__()
        if kernel == "ring":
            raise not_ported("ring attention (--attention-kernel ring)",
                             "A.12 parallelism")
        if kernel not in ("auto", "xla", "flash"):
            raise ValueError(f"unknown attention kernel {kernel!r}")
        self.num_heads = num_heads
        self.kv_heads = kv_heads or num_heads
        self.head_dim = embed_dim // num_heads
        self.scale = self.head_dim ** -0.5 if scale_attn else 1.0
        self.max_qkv = max_qkv
        self.causal = causal
        self.cross_attention = cross_attention
        self.rope_base = rope_base
        self.sliding_window = sliding_window
        self.kernel = kernel
        inner = num_heads * self.head_dim
        kv_inner = self.kv_heads * self.head_dim
        self.q_proj = Linear(embed_dim, inner, use_bias=use_bias, dtype=dtype)
        self.k_proj = Linear(embed_dim, kv_inner,
                             use_bias=use_bias and key_bias, dtype=dtype)
        self.v_proj = Linear(embed_dim, kv_inner, use_bias=use_bias,
                             dtype=dtype)
        self.out_proj = Linear(inner, embed_dim, use_bias=use_bias, dtype=dtype)
        self.dropout = Dropout(dropout)     # on the attention weights

    def _heads(self, x, heads: int):
        B, S = x.shape[:2]
        out = x.reshape(B, S, heads, self.head_dim).transpose(1, 2)
        if self.max_qkv is not None:   # MPT-style stability clamp
            out = out.clamp(-self.max_qkv, self.max_qkv)
        return out

    def use_flash(self, Sq: int, Sk: int, decode: bool,
                  biased: bool = False) -> bool:
        """JAX's choice (pasero_tpu/models/attention.py:256-284): flash
        never runs at decode or under live attention dropout; grouped K/V
        heads take it from 1024^2 scores only without a bias (a T5 table
        counts as one)."""
        dropout_live = self.training and self.dropout.rate > 0
        kernel = self.kernel
        if kernel == "auto":
            long_seq = Sq * Sk >= 4096 * 4096
            gqa_win = (self.kv_heads < self.num_heads and not biased
                       and Sq * Sk >= 1024 * 1024)
            kernel = "flash" if (long_seq or gqa_win) and not dropout_live \
                else "xla"
        return kernel == "flash" and not decode and not dropout_live

    def forward(self, x_q, x_kv=None, mask=None, positions=None,
                cache: Optional[KVCache] = None, beam_lineage=None, bias=None):
        """x_q: (B, Sq, E); x_kv: (B, Sk, E) for cross-attention; mask: bool
        (B, 1, Sq|1, Sk|L), True = attend; positions: (B, Sq) absolute
        positions; cache: this layer's KVCache at decode time;
        beam_lineage: (B0, K, L) for lineage beam attention; bias: float32
        (B|1, H|1, Sq, Sk|L), added to the scaled scores, or a T5Bias in a
        full forward (the decoder materializes T5's bias over the cache)."""
        B, Sq = x_q.shape[:2]
        q = self._heads(self.q_proj(x_q), self.num_heads)
        if positions is None:
            positions = torch.arange(Sq, device=x_q.device).expand(B, Sq)
        rope = self.rope_base is not None and not self.cross_attention
        if rope:
            q = apply_rope(q, positions, self.rope_base)
        if self.cross_attention and cache is not None and cache.key is not None:
            k, v = cache.key, cache.value          # stored on the first call
        else:
            x_kv = x_q if x_kv is None else x_kv
            k = self._heads(self.k_proj(x_kv), self.kv_heads)
            v = self._heads(self.v_proj(x_kv), self.kv_heads)
            if rope:
                k = apply_rope(k, positions, self.rope_base)
            if cache is not None:
                if self.cross_attention:
                    cache.key, cache.value = k, v
                else:
                    k, v, mask = self._update_cache(cache, k, v, positions,
                                                    mask, self.sliding_window)

        t5 = bias if isinstance(bias, T5Bias) else None
        if t5 is not None and (cache is not None or self.cross_attention):
            raise ValueError("a T5 table takes a full self-attention forward")
        if self.use_flash(Sq, k.shape[2], cache is not None, bias is not None):
            # GQA-sized K/V go in as they are; causality and the window come
            # from slot indices inside the kernels, so only the key mask of
            # ``mask`` is used
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), mask=mask,
                                  bias=None if t5 else bias,
                                  scale=self.scale, causal=self.causal,
                                  window=self.sliding_window, t5_bias=t5)
        else:
            if t5 is not None:
                bias = t5_bias_from_table(t5.table, positions, positions,
                                          t5.bidirectional, t5.num_buckets,
                                          t5.max_distance)
            if self.causal and cache is None:
                causal = (positions[:, None, None, :]
                          <= positions[:, None, :, None])
                if self.sliding_window:
                    causal &= (positions[:, None, :, None]
                               - positions[:, None, None, :]
                               ) < self.sliding_window
                mask = causal if mask is None else (mask & causal)
            if self.kv_heads != self.num_heads:
                group = self.num_heads // self.kv_heads
                k = k.repeat_interleave(group, dim=1)
                v = v.repeat_interleave(group, dim=1)
            if beam_lineage is not None and cache is not None \
                    and not self.cross_attention:
                out = lineage_attention(q, k, v, beam_lineage, mask=mask,
                                        bias=bias, scale=self.scale)
            else:
                out = dot_product_attention(q, k, v, mask=mask, bias=bias,
                                            scale=self.scale,
                                            dropout=self.dropout)
        out = out.transpose(1, 2).reshape(B, Sq, self.num_heads * self.head_dim)
        return self.out_proj(out)

    @staticmethod
    def _update_cache(cache: KVCache, k, v, positions, mask, window=None):
        """Write the current K/V at the cache index, attend over [0, index+Sk).

        A single token goes through the slot-write kernel; a multi-token
        (prompt) block is a slice copy."""
        Sk = k.shape[2]
        i, L = cache.index, cache.length
        if i + Sk > L:
            raise IndexError(f"cache of {L} slots cannot take {Sk} more "
                             f"tokens at slot {i}")
        if Sk == 1:
            cache_slot_write_(cache.key, cache.value, k, v, i)
        else:
            cache.key[:, :, i:i + Sk] = k
            cache.value[:, :, i:i + Sk] = v
        cache.index = i + Sk
        # callers size their kv mask for the tokens they will decode; pad it
        # to the cache length, the `valid` written-slot mask gates the rest
        if mask is not None and mask.shape[-1] < L:
            pad = mask.new_ones(mask.shape[:-1] + (L - mask.shape[-1],))
            mask = torch.cat([mask, pad], dim=-1)
        slots = torch.arange(L, device=k.device)
        valid = slots[None, :] < (i + Sk)                          # (1, L)
        kv_pos = positions[:, -1:] - (i + Sk - 1) + slots[None]    # (B, L)
        causal = kv_pos[:, None, None, :] <= positions[:, None, :, None]
        attend = causal & valid[:, None, None, :]
        if window:
            attend &= (positions[:, None, :, None] - kv_pos[:, None, None, :]
                       ) < window
        mask = attend if mask is None else (mask & attend)
        return cache.key, cache.value, mask
