"""Core NN modules: linear, embeddings, norms, FFN, the speech frontend.

PyTorch counterparts of pasero_tpu/models/modules.py. Parameters are float32;
compute runs in ``dtype`` (bfloat16 by default), and each product is rounded
where the flax module rounds it, so the two packages agree on the same
weights. Normalization statistics are always float32. Attribute names follow
the flax names (``weight`` stands for flax's ``kernel``/``scale``, see
checkpoints.params_to_state_dict).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import not_ported
from ..ops.quantize import (QTensor, embedding_lookup, int8_matmul,
                            int8_matmul_t)


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: ``where(keep, x / (1 - rate), 0)`` with
    ``keep ~ Bernoulli(1 - rate)``, live only in training mode. The random
    bits come from ``generator`` (a ``torch.Generator`` the trainer seeds from
    ``cfg.seed``, set by ``Transformer.set_dropout_generator``); they are not
    JAX's bits, so parity tests run with dropout 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate or 0.0
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate <= 0.0:
            return x
        return dropout(x, self.rate, self.generator)


def dropout(x, rate: float, generator=None):
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


class Linear(nn.Module):
    """Dense layer (pasero_tpu/models/modules.py:34). ``weight`` is (out, in),
    the transpose of flax's (in, out) ``kernel``. The product is rounded to
    ``dtype`` before the bias is added, as flax's ``preferred_element_type``
    does. After ``quantize_params`` the weight is an int8 ``QTensor`` and the
    product is ``int8_matmul`` (inference only)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None
        self.dtype = dtype
        # flax's lecun_normal: a normal truncated at two standard deviations,
        # rescaled to variance 1 / fan_in
        std = in_features ** -0.5 / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std)

    def forward(self, x):
        if isinstance(self.weight, QTensor):
            y = int8_matmul(x.to(self.dtype), self.weight, out_dtype=self.dtype)
        else:
            y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Embedding(nn.Module):
    """Token embedding with a tied output projection
    (pasero_tpu/models/modules.py:90). After ``quantize_params`` the table is
    a row-quantized ``QTensor``: lookups dequantize the gathered rows and the
    tied head is ``int8_matmul_t``."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.randn(num_embeddings, features) * features ** -0.5)
        self.dtype = dtype

    def forward(self, ids):
        if isinstance(self.embedding, QTensor):
            return embedding_lookup(self.embedding, ids, self.dtype)
        return F.embedding(ids, self.embedding).to(self.dtype)

    def attend(self, x):
        """Output projection with tied weights; float32 logits of
        ``dtype`` operands (flax: ``preferred_element_type=float32``)."""
        if isinstance(self.embedding, QTensor):
            return int8_matmul_t(x.to(self.dtype), self.embedding,
                                 out_dtype=torch.float32)
        w = self.embedding.to(self.dtype).float()
        return torch.matmul(x.to(self.dtype).float(), w.t())


class LayerNorm(nn.Module):
    """LayerNorm with optional bias and float32 statistics
    (pasero_tpu/models/modules.py:142)."""

    def __init__(self, dim: int, epsilon: float = 1e-5, use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None
        self.epsilon = epsilon
        self.dtype = dtype

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.epsilon) * self.weight
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


class RMSNorm(nn.Module):
    """RMS normalization computed in float32 and cast to ``dtype``
    (pasero_tpu/models/modules.py:125); ``weight`` is flax's ``scale``."""

    def __init__(self, dim: int, epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.epsilon = epsilon
        self.dtype = dtype

    def forward(self, x):
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.epsilon) * self.weight).to(self.dtype)


def make_norm(cfg, dim: int, dtype: torch.dtype) -> nn.Module:
    if cfg.rms_norm:
        return RMSNorm(dim, epsilon=cfg.norm_eps, dtype=dtype)
    return LayerNorm(dim, epsilon=cfg.norm_eps, use_bias=cfg.norm_bias,
                     dtype=dtype)


# gelu_tanh's constants rounded to each floating type, as JAX's weak typing
# rounds them to the operand's
_GELU_CONSTANTS = {
    dtype: tuple(torch.tensor(c, dtype=dtype).item()
                 for c in (0.044715, math.sqrt(2 / math.pi)))
    for dtype in (torch.float16, torch.bfloat16, torch.float32, torch.float64)}


def gelu_tanh(x):
    """``jax.nn.gelu(x, approximate=True)`` operation by operation in x's
    type, rounding where JAX rounds: 0.5 (1 + tanh(sqrt(2 / pi) (x + 0.044715
    x^3))) x, the constants rounded to x's type first.
    ``F.gelu(approximate="tanh")`` rounds once at the end, which moves
    bfloat16 activations by an ulp and flips near-tied tokens."""
    cube, root = _GELU_CONSTANTS[x.dtype]
    inner = (x + x * x * x * cube) * root
    return x * ((torch.tanh(inner) + 1.0) * 0.5)


ACTIVATIONS = {
    "relu": F.relu,
    # exact (erf) gelu; 'gelu_tanh' is the approximation
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_tanh": gelu_tanh,
}


# the gate's activation; geglu takes jax.nn.gelu's default, the tanh form
GATES = {"swiglu": F.silu, "geglu": gelu_tanh}


class FeedForward(nn.Module):
    """fc1 -> activation -> dropout -> fc2, or with swiglu/geglu the gated
    ``act(gate(x)) * fc1(x)`` -> dropout -> fc2
    (pasero_tpu/models/modules.py:183)."""

    def __init__(self, embed_dim: int, ffn_dim: int, activation: str = "relu",
                 use_bias: bool = True, dtype: torch.dtype = torch.bfloat16,
                 dropout: float = 0.0):
        super().__init__()
        if activation not in ACTIVATIONS and activation not in GATES:
            raise not_ported(f"activation {activation!r}", "A.8 decoder-only")
        self.fc1 = Linear(embed_dim, ffn_dim, use_bias=use_bias, dtype=dtype)
        if activation in GATES:
            self.gate = Linear(embed_dim, ffn_dim, use_bias=use_bias,
                               dtype=dtype)
        self.fc2 = Linear(ffn_dim, embed_dim, use_bias=use_bias, dtype=dtype)
        self.activation = GATES.get(activation) or ACTIVATIONS[activation]
        self.dropout = Dropout(dropout)

    def forward(self, x):
        if hasattr(self, "gate"):
            h = self.activation(self.gate(x)) * self.fc1(x)
        else:
            h = self.activation(self.fc1(x))
        return self.fc2(self.dropout(h))


class Conv1d(nn.Module):
    """flax's ``nn.Conv`` over (B, T, C) inputs with symmetric padding
    ``k // 2``: ``weight`` is (out, in, k), the transpose of flax's
    (k, in, out) ``kernel``. As with ``Linear``, the product is rounded to
    ``dtype`` before the bias is added."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.stride = stride
        self.dtype = dtype
        # flax's lecun_normal over the fan-in k * in
        std = (in_channels * kernel_size) ** -0.5 / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std)

    def forward(self, x):
        k = self.weight.shape[-1]
        y = F.conv1d(x.to(self.dtype).transpose(1, 2),
                     self.weight.to(self.dtype), stride=self.stride,
                     padding=k // 2)
        return y.transpose(1, 2) + self.bias.to(self.dtype)


class ConvolutionSubsampler(nn.Module):
    """1-D conv stack subsampling speech features before the encoder
    (pasero_tpu/models/modules.py:240). ``forward(x, lengths)`` takes (B, T,
    F) features and their lengths and returns (features, new lengths): the
    features cast to ``dtype``, an optional ``in_proj`` with relu, each
    convolution followed by glu (which halves the channels) or exact gelu,
    and an optional ``out_proj``. ``F.conv1d`` is a library call, as JAX
    leaves the convolution to XLA."""

    def __init__(self, in_dim: int, channels: int, kernel_sizes, strides=None,
                 activation: str = "glu", out_dim=None, in_proj_dim=None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if activation not in ("glu", "gelu"):
            raise ValueError(f"unknown subsampler activation {activation!r}")
        self.activation = activation
        self.dtype = dtype
        self.kernel_sizes = list(kernel_sizes)
        self.strides = list(strides or []) or [2] * len(self.kernel_sizes)
        dim = in_dim
        if in_proj_dim is not None and in_proj_dim != in_dim:
            self.in_proj = Linear(in_dim, in_proj_dim, dtype=dtype)
            dim = in_proj_dim
        width = channels * (2 if activation == "glu" else 1)
        for i, (k, s) in enumerate(zip(self.kernel_sizes, self.strides)):
            self.add_module(f"conv{i}", Conv1d(dim, width, k, s, dtype))
            dim = channels
        if out_dim is not None and dim != out_dim:
            self.out_proj = Linear(dim, out_dim, dtype=dtype)

    def forward(self, x, lengths):
        x = x.to(self.dtype)
        if hasattr(self, "in_proj"):
            x = F.relu(self.in_proj(x))
        for i, (k, s) in enumerate(zip(self.kernel_sizes, self.strides)):
            x = getattr(self, f"conv{i}")(x)
            if self.activation == "glu":
                a, b = x.chunk(2, dim=-1)
                x = a * torch.sigmoid(b)
            else:
                x = F.gelu(x, approximate="none")
            lengths = (lengths + 2 * (k // 2) - k) // s + 1
        if hasattr(self, "out_proj"):
            x = self.out_proj(x)
        return x, lengths
