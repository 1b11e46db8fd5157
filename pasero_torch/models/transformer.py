"""Transformer encoder-decoder and decoder-only models.

PyTorch counterpart of pasero_tpu/models/transformer.py (encoder and decoder
layers and stacks, ``Transformer.encode``/``decode_step``, the full forward
with the logits head, and the training forward whose loss comes from the
fused cross-entropy head). Attribute names follow the flax module names
(``encoder.layers_0.self_attn.q_proj``, ``shared_embed``,
``decoder.layers_2.cross_attn_norm``), so checkpoints map across
mechanically (checkpoints.params_to_state_dict). A decoder-only model
(``model_type == "decoder"``) has no encoder and no cross-attention, as the
JAX model's (:682, :201).

Covered: token and speech-feature sources (a ``ConvolutionSubsampler``
in front of the encoder), post-norm and pre-norm, sinusoidal, learned,
rotary, ALiBi, T5 or no positions, LayerNorm and RMSNorm, tied and untied heads, relu, gelu and the
gated swiglu/geglu FFNs, grouped K/V heads, sliding windows, the attention
kernel choice (``cfg.attention_kernel``), and residual, attention,
activation and embedding dropout at the places the flax layers put them
(live in training mode only). Other options raise NotImplementedError
naming the ROADMAP.md item that brings them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import not_ported
from ..config import TransformerConfig, register_model
from ..ops.fused_ce import fused_cross_entropy, fused_head_argmax
from ..ops.quantize import QTensor
from .attention import KVCache, MultiheadAttention
from .modules import (ConvolutionSubsampler, Dropout, Embedding, FeedForward,
                      Linear, make_norm)
from .positional import PositionalEmbedding, T5RelativeBias, alibi_bias


def check_supported(cfg) -> None:
    """Raise NotImplementedError for configuration options that later slices
    of the port bring (ROADMAP.md, queue A)."""
    def todo(what, item):
        raise not_ported(what, item)

    for side in ("encoder", "decoder"):
        pe = getattr(cfg, f"{side}_positional_encoding")
        if pe not in ("sinusoidal", "learned", "rotary", "alibi", "t5",
                      "none"):
            todo(f"{pe} positions", "A.8 decoder-only")
    if cfg.parallel_attention:
        todo("parallel attention", "A.8 decoder-only")
    if getattr(cfg, "attention_kernel", None) == "ring":
        todo("ring attention (--attention-kernel ring)", "A.12 parallelism")
    if hasattr(cfg, "encoder_expert_count"):
        todo("mixture-of-experts layers", "A.10 MoE, adapters and hybrid")
    if hasattr(cfg, "encoder_adapter_dim"):
        todo("adapters", "A.10 MoE, adapters and hybrid")
    if hasattr(cfg, "decoder_hidden_size"):
        todo("the LSTM hybrid decoder", "A.10 MoE, adapters and hybrid")
    if cfg.lora_rank:
        todo("LoRA", "A.10 MoE, adapters and hybrid")
    if cfg.checkpoint_activations:
        todo("activation checkpointing", "A.8 decoder-only")


def positions_from_mask(pad_mask: torch.Tensor, shift: int = 0) -> torch.Tensor:
    """Position ids that skip padding: cumsum over non-pad tokens - 1.

    Works for both left- and right-padded batches; padded slots get position
    of the previous real token (they are masked out of attention anyway).
    """
    pos = torch.cumsum(pad_mask.to(torch.int32), dim=1) - 1
    return pos.clamp(min=0) + shift


def scale_embed(x, cfg):
    # the scale is rounded to the activation type first, as JAX's weak
    # typing of a Python scalar does
    return x * torch.tensor(cfg.embed_dim ** 0.5, dtype=x.dtype)


class _Layer(nn.Module):
    """Shared pieces of the encoder and decoder layers."""

    def _norms(self, cfg, dtype):
        E = cfg.embed_dim
        self.self_attn_norm = make_norm(cfg, E, dtype)
        if not cfg.shared_norm:
            self.ffn_norm = make_norm(cfg, E, dtype)

    @property
    def norm2(self):
        return self.self_attn_norm if self.cfg.shared_norm else self.ffn_norm

    def _finish(self, x):
        if self.cfg.check_inf:   # T5 half-precision guard
            x = torch.nan_to_num(x, nan=0.0, posinf=6e4, neginf=-6e4)
        return x


def rope_base(cfg, side: str):
    return (cfg.rope_base
            if getattr(cfg, f"{side}_positional_encoding") == "rotary" else None)


class TransformerEncoderLayer(_Layer):
    def __init__(self, cfg, kernel: str = "xla", dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.self_attn = MultiheadAttention(
            cfg.embed_dim, cfg.encoder_attention_heads, use_bias=cfg.has_bias,
            key_bias=cfg.attention_key_bias, scale_attn=cfg.scale_attn,
            max_qkv=cfg.max_qkv, causal=False, dtype=dtype,
            dropout=cfg.attention_dropout,
            rope_base=rope_base(cfg, "encoder"), kernel=kernel)
        self._norms(cfg, dtype)
        self.ffn = FeedForward(cfg.embed_dim, cfg.encoder_ffn_dim,
                               cfg.activation_fn, cfg.has_bias, dtype,
                               dropout=cfg.activation_dropout)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, mask=None, positions=None, bias=None):
        prenorm = self.cfg.encoder_prenorm
        residual = x
        h = self.self_attn_norm(x) if prenorm else x
        x = residual + self.dropout(self.self_attn(h, mask=mask,
                                                   positions=positions,
                                                   bias=bias))
        if not prenorm:
            x = self.self_attn_norm(x)
        residual = x
        h = self.norm2(x) if prenorm else x
        x = residual + self.dropout(self.ffn(h))
        if not prenorm:
            x = self.norm2(x)
        return self._finish(x)


class TransformerDecoderLayer(_Layer):
    def __init__(self, cfg, has_cross_attention: bool = True,
                 kernel: str = "xla", dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        E, H = cfg.embed_dim, cfg.decoder_attention_heads
        common = dict(use_bias=cfg.has_bias, key_bias=cfg.attention_key_bias,
                      scale_attn=cfg.scale_attn, max_qkv=cfg.max_qkv,
                      dtype=dtype, dropout=cfg.attention_dropout,
                      kernel=kernel)
        self.self_attn = MultiheadAttention(
            E, H, causal=True, kv_heads=cfg.attention_heads_kv,
            rope_base=rope_base(cfg, "decoder"),
            sliding_window=cfg.sliding_window, **common)
        self._norms(cfg, dtype)
        if has_cross_attention:
            self.cross_attn_norm = make_norm(cfg, E, dtype)
            self.cross_attn = MultiheadAttention(E, H, cross_attention=True,
                                                 **common)
        self.ffn = FeedForward(E, cfg.decoder_ffn_dim, cfg.activation_fn,
                               cfg.has_bias, dtype,
                               dropout=cfg.activation_dropout)
        self.dropout = Dropout(cfg.decoder_dropout
                               if cfg.decoder_dropout is not None
                               else cfg.dropout)

    def forward(self, x, encoder_out=None, self_mask=None, cross_mask=None,
                positions=None, cache=None, beam_lineage=None, self_bias=None):
        prenorm = self.cfg.decoder_prenorm
        self_cache, cross_cache = cache if cache is not None else (None, None)
        residual = x
        h = self.self_attn_norm(x) if prenorm else x
        x = residual + self.dropout(self.self_attn(
            h, mask=self_mask, positions=positions, cache=self_cache,
            beam_lineage=beam_lineage, bias=self_bias))
        if not prenorm:
            x = self.self_attn_norm(x)

        if hasattr(self, "cross_attn"):
            residual = x
            h = self.cross_attn_norm(x) if prenorm else x
            x = residual + self.dropout(self.cross_attn(
                h, x_kv=encoder_out, mask=cross_mask, cache=cross_cache))
            if not prenorm:
                x = self.cross_attn_norm(x)

        residual = x
        h = self.norm2(x) if prenorm else x
        x = residual + self.dropout(self.ffn(h))
        if not prenorm:
            x = self.norm2(x)
        return self._finish(x)


class _Stack(nn.Module):
    """Token embedding (own or shared), positions and the layer list."""

    def _embeddings(self, cfg, vocab_size, shared_embed, max_len, pe, dtype):
        """``vocab_size`` None: no token table (a speech encoder)."""
        if shared_embed is None and vocab_size is not None:
            self.embed_tokens = Embedding(vocab_size, cfg.embed_dim, dtype)
        else:
            # owned (and saved) by the Transformer as `shared_embed`; kept
            # out of this module's parameters so it is stored once
            object.__setattr__(self, "_shared_embed", shared_embed)
        if pe in ("sinusoidal", "learned"):
            self.embed_positions = PositionalEmbedding(
                pe, max_len, cfg.embed_dim, cfg.positional_encoding_shift)
        self.embed_dropout = Dropout(cfg.embed_dropout
                                     if cfg.embed_dropout is not None
                                     else cfg.dropout)

    @property
    def embed(self) -> Embedding:
        shared = self.__dict__.get("_shared_embed")
        return shared if shared is not None else self.embed_tokens

    def _embed(self, tokens, positions, prenorm_embed):
        return self._embed_features(self.embed(tokens), positions,
                                    prenorm_embed)

    def _embed_features(self, x, positions, prenorm_embed):
        """Scale, positions, norm and dropout of embedded inputs."""
        if self.cfg.scale_embed:
            x = scale_embed(x, self.cfg)
        if hasattr(self, "embed_positions"):
            x = self.embed_positions(x, positions)
        if prenorm_embed:
            x = self.embed_norm(x)
        return self.embed_dropout(x)


class TransformerEncoder(_Stack):
    """Token embeddings, or with ``cfg.input_dim`` speech features through
    the convolution subsampler (pasero_tpu/models/transformer.py:249-262):
    a speech encoder has no token table."""

    def __init__(self, cfg, vocab_size: int, shared_embed=None,
                 kernel: str = "xla", dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self._embeddings(cfg, None if cfg.input_dim else vocab_size,
                         shared_embed, cfg.encoder_max_len,
                         cfg.encoder_positional_encoding, dtype)
        if cfg.input_dim:
            kernels = cfg.conv_kernel_sizes or []
            self.subsampler = ConvolutionSubsampler(
                cfg.input_dim,
                cfg.conv_channels or cfg.conv_input_dim or cfg.input_dim,
                kernels, cfg.conv_strides or [2] * len(kernels),
                activation=cfg.conv_activation or "glu",
                out_dim=cfg.embed_dim, in_proj_dim=cfg.conv_input_dim,
                dtype=dtype)
        if cfg.encoder_embed_norm:
            self.embed_norm = make_norm(cfg, cfg.embed_dim, dtype)
        self.num_layers = cfg.encoder_layers
        for i in range(cfg.encoder_layers):
            self.add_module(f"layers_{i}",
                            TransformerEncoderLayer(cfg, kernel, dtype))
        if cfg.encoder_prenorm:
            self.final_norm = make_norm(cfg, cfg.embed_dim, dtype)
        if cfg.encoder_positional_encoding == "t5":
            # one table for every layer (pasero_tpu/models/transformer.py:293)
            self.t5_bias = T5RelativeBias(cfg.encoder_attention_heads,
                                          bidirectional=True)

    def layers(self):
        return [getattr(self, f"layers_{i}") for i in range(self.num_layers)]

    def forward(self, src_tokens, src_mask=None):
        """src_tokens: (B, S) int ids or (B, T, F) float features;
        src_mask: bool (B, S) True at real tokens or frames. Returns
        (encoder_out (B, S', E), its mask): for features, S' and the mask
        follow the subsampled lengths."""
        cfg = self.cfg
        if src_tokens.dim() == 3:
            B, T = src_tokens.shape[:2]
            lengths = (src_mask.sum(dim=1) if src_mask is not None
                       else torch.full((B,), T, device=src_tokens.device))
            x, lengths = self.subsampler(src_tokens, lengths)
            S = x.shape[1]
            src_mask = (torch.arange(S, device=x.device)[None, :]
                        < lengths[:, None])
            positions = positions_from_mask(src_mask)
            x = self._embed_features(x, positions, cfg.encoder_embed_norm)
        else:
            if src_mask is None:
                src_mask = src_tokens != cfg.padding_idx
            positions = positions_from_mask(src_mask)
            x = self._embed(src_tokens, positions, cfg.encoder_embed_norm)
        attn_mask = src_mask[:, None, None, :]
        # one ALiBi bias or T5 table for every layer (transformer.py:288-301)
        bias = None
        if cfg.encoder_positional_encoding == "alibi":
            bias = alibi_bias(cfg.encoder_attention_heads, positions,
                              positions, cfg.alibi_max_bias, causal=False)
        elif cfg.encoder_positional_encoding == "t5":
            bias = self.t5_bias.rel_table()
        for layer in self.layers():
            x = layer(x, mask=attn_mask, positions=positions, bias=bias)
        if self.cfg.encoder_prenorm:
            x = self.final_norm(x)
        return x, src_mask


class TransformerDecoder(_Stack):
    def __init__(self, cfg, vocab_size: int, shared_embed=None,
                 has_encoder: bool = True, kernel: str = "xla",
                 dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self._embeddings(cfg, vocab_size, shared_embed, cfg.decoder_max_len,
                         cfg.decoder_positional_encoding, dtype)
        if cfg.decoder_embed_norm:
            self.embed_norm = make_norm(cfg, cfg.embed_dim, dtype)
        self.num_layers = cfg.decoder_layers
        for i in range(cfg.decoder_layers):
            self.add_module(f"layers_{i}", TransformerDecoderLayer(
                cfg, has_encoder, kernel, dtype))
        if cfg.decoder_prenorm:
            self.final_norm = make_norm(cfg, cfg.embed_dim, dtype)
        if not cfg.tied_output_projection:
            self.output_projection = Linear(cfg.embed_dim, vocab_size,
                                            use_bias=False, dtype=dtype)
        if cfg.decoder_positional_encoding == "t5":
            self.t5_bias = T5RelativeBias(cfg.decoder_attention_heads,
                                          bidirectional=False)
        self._argmax_head = None    # (key, compute-type copy of the head)

    def layers(self):
        return [getattr(self, f"layers_{i}") for i in range(self.num_layers)]

    def _self_bias(self, positions, cache):
        """The relative-position bias of one decoder call, shared by every
        layer (pasero_tpu/models/transformer.py:410-440): the causal ALiBi
        bias (B, H, T, T or L), or T5's table in a full forward and its bias
        materialized over the cache at decode. In a full forward the keys
        are the query positions. At decode, cache slot j holds position
        pos_last - (step + T - 1) + j, where the step is the self-attention
        caches' write index before this call: JAX keeps it as a separate
        ``bias_step``; deriving it from the index keeps the two from
        drifting apart, also when speculative decoding rewinds or a beam
        step moves on."""
        pe = self.cfg.decoder_positional_encoding
        if pe == "t5" and cache is None:
            return self.t5_bias.rel_table()
        kv_pos = positions
        if cache is not None:
            self_cache = cache[0][0]
            T = positions.shape[1]
            slots = torch.arange(self_cache.length, device=positions.device)
            kv_pos = positions[:, -1:] - (self_cache.index + T - 1) + slots
        if pe == "t5":
            return self.t5_bias(positions, kv_pos)
        return alibi_bias(self.cfg.decoder_attention_heads, positions, kv_pos,
                          self.cfg.alibi_max_bias, causal=True)

    def argmax_head_weight(self):
        """The (V, E) head of ``fused_head_argmax``: an int8 QTensor as it
        is; a float head rounded to the compute type, kept while the weight
        is unchanged, so the cast is made once per decode and not at every
        decoder call (JAX casts it in the decode program, and XLA hoists the
        cast out of the decode loop)."""
        weight = (self.embed.embedding if self.cfg.tied_output_projection
                  else self.output_projection.weight)
        if isinstance(weight, QTensor):
            return weight
        # an inference tensor has no version counter (and is not updated in
        # place outside inference mode)
        version = None if weight.is_inference() else weight._version
        key = (weight.data_ptr(), version, weight.device, self.dtype)
        if self._argmax_head is None or self._argmax_head[0] != key:
            self._argmax_head = (key, weight.detach().to(self.dtype))
        return self._argmax_head[1]

    def forward(self, tokens, encoder_out=None, encoder_mask=None,
                tgt_mask=None, positions=None, cache=None, self_kv_mask=None,
                beam_lineage=None, ce_targets=None, ce_weights=None,
                head: str = "logits"):
        """tokens: (B, T) decoder input ids. Returns float32 logits (B, T, V).

        cache: the per-layer (self, cross) KVCache pairs of
        Transformer.make_cache at decode time; self_kv_mask: (B, L) bool —
        validity of KV-cache slots (False at left-pad prompt slots).

        ce_targets/ce_weights (B, T): the training head — instead of logits,
        return (loss_sum, nll_sum, weight_sum) from the fused cross-entropy
        (``ce_impl`` "auto"/"flash": the CUDA kernels on the card, their
        plain version on the CPU) or ``chunked_cross_entropy`` ("chunked"),
        without the (B, T, V) float32 logits.

        head="argmax": (tokens, logprobs) of shape (B, T) from the fused
        greedy head (``fused_head_argmax``) instead of logits
        (pasero_tpu/models/transformer.py:525-545)."""
        cfg = self.cfg
        if tgt_mask is None:
            tgt_mask = tokens != cfg.padding_idx
        if positions is None:
            positions = positions_from_mask(tgt_mask)
        x = self._embed(tokens, positions, cfg.decoder_embed_norm)
        if cache is not None:
            # causal structure comes from positions in the cache update; the
            # caller only masks out invalid (left-pad) cache slots
            self_mask = (self_kv_mask[:, None, None, :]
                         if self_kv_mask is not None else None)
        else:
            self_mask = tgt_mask[:, None, None, :]
        cross_mask = (encoder_mask[:, None, None, :]
                      if encoder_mask is not None else None)
        self_bias = None
        if cfg.decoder_positional_encoding in ("alibi", "t5"):
            self_bias = self._self_bias(positions, cache)
        for i, layer in enumerate(self.layers()):
            x = layer(x, encoder_out=encoder_out, self_mask=self_mask,
                      cross_mask=cross_mask, positions=positions,
                      cache=cache[i] if cache is not None else None,
                      beam_lineage=beam_lineage, self_bias=self_bias)
        if cfg.decoder_prenorm:
            x = self.final_norm(x)
        if ce_targets is not None:
            # the head weight in its stored (V, E) layout: the tied table or
            # the output projection (pasero_tpu/models/transformer.py:499-523)
            weight = (self.embed.embedding if cfg.tied_output_projection
                      else self.output_projection.weight)
            ls = cfg.label_smoothing or 0.0
            if getattr(cfg, "ce_impl", "auto") in ("auto", "flash"):
                B, T, E = x.shape
                return fused_cross_entropy(x.reshape(B * T, E), weight,
                                           ce_targets.reshape(-1),
                                           ce_weights.reshape(-1), ls)
            return chunked_cross_entropy(
                x, weight, ce_targets, ce_weights, label_smoothing=ls,
                num_chunks=getattr(cfg, "ce_chunks", 8) or 8)
        if head == "argmax":
            B, T, E = x.shape
            tok, lp = fused_head_argmax(x.reshape(B * T, E),
                                        self.argmax_head_weight())
            return tok.reshape(B, T), lp.reshape(B, T)
        if cfg.tied_output_projection:
            return self.embed.attend(x)
        return self.output_projection(x).float()


def _ce_terms(logits, targets, label_smoothing: float):
    """Per-token (loss, nll) of float32 logits (B, T, V)."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = lse - tgt
    if label_smoothing > 0:
        smooth = lse - logits.mean(dim=-1)
        return (1.0 - label_smoothing) * nll + label_smoothing * smooth, nll
    return nll, nll


def cross_entropy_loss(logits, targets, weights, label_smoothing=0.0):
    """Summed CE with label smoothing (pasero_tpu/models/transformer.py:625);
    normalization by the token count happens in the trainer.

    logits: (B, T, V); targets: (B, T) int; weights: (B, T) float.
    Returns (loss_sum, nll_sum, weight_sum)."""
    loss, nll = _ce_terms(logits.float(), targets, label_smoothing)
    return (loss * weights).sum(), (nll * weights).sum(), weights.sum()


def chunked_cross_entropy(x, weight, targets, weights, label_smoothing=0.0,
                          num_chunks=8):
    """CE over vocabulary logits computed in sequence chunks
    (pasero_tpu/models/transformer.py:566): each chunk runs under
    ``torch.utils.checkpoint``, so its float32 logits are recomputed in the
    backward instead of kept.

    x: (B, T, E) post-norm activations; weight: (V, E) head weight;
    targets (B, T) int; weights (B, T) float.
    Returns (loss_sum, nll_sum, weight_sum)."""
    T = x.shape[1]
    num_chunks = max(1, min(num_chunks, T))
    Tc = -(-T // num_chunks)
    weights = weights.float()
    kernel = weight.to(x.dtype).float()

    def chunk_stats(xc, tc, wc, kernel):
        logits = torch.matmul(xc.float(), kernel.t())
        loss, nll = _ce_terms(logits, tc, label_smoothing)
        return (loss * wc).sum(), (nll * wc).sum()

    loss_sum = nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for t0 in range(0, T, Tc):
        sl = slice(t0, t0 + Tc)
        loss_c, nll_c = checkpoint(chunk_stats, x[:, sl], targets[:, sl],
                                   weights[:, sl], kernel, use_reentrant=False)
        loss_sum = loss_sum + loss_c
        nll_sum = nll_sum + nll_c
    return loss_sum, nll_sum, weights.sum()


@register_model("transformer", TransformerConfig)
class Transformer(nn.Module):
    """Encoder-decoder model, encode -> decode, or decoder-only model
    (pasero_tpu/models/transformer.py:650). Parameters are float32; compute
    runs in ``dtype``. ``kernel`` (default ``cfg.attention_kernel``) picks
    every attention layer's implementation, as in JAX (:680)."""

    supports_beam_lineage = True
    # decode_step(head="argmax"): the fused greedy head (fused_head_argmax)
    supports_fused_head = True

    def __init__(self, cfg, src_vocab_size: int,
                 tgt_vocab_size: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 kernel: Optional[str] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        kernel = kernel or getattr(cfg, "attention_kernel", None) or "xla"
        tgt_vocab = tgt_vocab_size or src_vocab_size
        self.is_encoder_decoder = cfg.model_type != "decoder"
        shared = None
        # a speech encoder has no token table to share (transformer.py:683)
        if (self.is_encoder_decoder and cfg.shared_embeddings
                and not cfg.input_dim and src_vocab_size == tgt_vocab):
            shared = self.shared_embed = Embedding(tgt_vocab, cfg.embed_dim,
                                                   dtype)
        if self.is_encoder_decoder:
            self.encoder = TransformerEncoder(cfg, src_vocab_size, shared,
                                              kernel, dtype)
        self.decoder = TransformerDecoder(cfg, tgt_vocab, shared,
                                          self.is_encoder_decoder, kernel,
                                          dtype)
        # decoder calls with one token per row: each writes every layer's
        # self-attention cache through one cache_slot_write_ launch
        self.single_token_calls = 0

    def set_dropout_generator(self, generator) -> None:
        """The ``torch.Generator`` every dropout of the model draws from."""
        for module in self.modules():
            if isinstance(module, Dropout):
                module.generator = generator

    def make_cache(self, batch: int, self_cache_len: int) -> list:
        """Empty decode state: one (self, cross) KVCache pair per decoder
        layer, on the model's device, in its compute dtype."""
        cfg = self.cfg
        H = cfg.decoder_attention_heads
        D = cfg.embed_dim // H
        Hkv = cfg.attention_heads_kv or H
        device = self.decoder.embed.embedding.device
        return [(KVCache(batch, Hkv, D, self_cache_len, self.dtype, device),
                 KVCache(batch, H, D, 0, self.dtype, device))
                for _ in range(cfg.decoder_layers)]

    def encode(self, src_tokens, src_mask=None):
        return self.encoder(src_tokens, src_mask=src_mask)

    def decode_step(self, tokens, cache, encoder_out=None, encoder_mask=None,
                    positions=None, tgt_mask=None, self_kv_mask=None,
                    beam_lineage=None, head: str = "logits"):
        """One incremental decoder call, updating ``cache`` in place.
        ``encoder_out`` is needed on the first call only (it fills the
        cross-attention caches). beam_lineage (B0, K, L): lineage beam
        attention, see attention.lineage_attention. head="argmax": return
        (tokens, logprobs) (B, T) of the fused greedy head instead of
        (B, T, V) logits (pasero_tpu/models/transformer.py:707-720)."""
        if tokens.shape[1] == 1:
            self.single_token_calls += 1
        return self.decoder(tokens, encoder_out=encoder_out,
                            encoder_mask=encoder_mask, tgt_mask=tgt_mask,
                            positions=positions, cache=cache,
                            self_kv_mask=self_kv_mask,
                            beam_lineage=beam_lineage, head=head)

    def forward(self, src_tokens, decoder_input, src_mask=None, targets=None,
                prompt_mask=None, loss_weights=None):
        """Full teacher-forced forward (pasero_tpu/models/transformer.py:727);
        a decoder-only model takes ``src_tokens=None``.

        Without ``targets``: {"logits": (B, T, V) f32}. With them (B, T):
        {"loss_sum", "nll_sum", "num_tokens"}, the loss weighted by
        ``loss_weights`` (default: the non-pad mask) and by ``prompt_loss``
        at ``prompt_mask`` positions; with ``fused_ce`` (the default) the
        logits come out of the fused cross-entropy head and never exist."""
        cfg = self.cfg
        encoder_out = encoder_mask = None
        if self.is_encoder_decoder:
            encoder_out, encoder_mask = self.encode(src_tokens, src_mask)
        kwargs = dict(encoder_out=encoder_out, encoder_mask=encoder_mask)
        if targets is None:
            return {"logits": self.decoder(decoder_input, **kwargs)}
        pad_mask = (targets != cfg.padding_idx).float()
        weights = loss_weights if loss_weights is not None else pad_mask
        if prompt_mask is not None and cfg.prompt_loss != 1.0:
            weights = weights * torch.where(prompt_mask, cfg.prompt_loss, 1.0)
        if getattr(cfg, "fused_ce", True):
            loss_sum, nll_sum, _ = self.decoder(
                decoder_input, ce_targets=targets, ce_weights=weights,
                **kwargs)
            return {"loss_sum": loss_sum, "nll_sum": nll_sum,
                    "num_tokens": pad_mask.sum()}
        logits = self.decoder(decoder_input, **kwargs)
        loss_sum, nll_sum, _ = cross_entropy_loss(
            logits, targets, weights, cfg.label_smoothing or 0.0)
        return {"logits": logits, "loss_sum": loss_sum, "nll_sum": nll_sum,
                "num_tokens": pad_mask.sum()}
