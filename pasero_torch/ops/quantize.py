"""Weight-only int8 quantization for inference.

Port of pasero_tpu/ops/quantize.py. Decoding a large model with a small batch
is bound by the bytes of weights it reads at every decoder call; storing the
large matrices as int8 with one float32 scale per output channel halves them
against bfloat16. ``--quantize int8`` (TextGenerator, ``cli.decode``) turns it
on after the checkpoint is loaded; training never sees a QTensor.

Layout. The port's ``Linear.weight`` is (out, in), the transpose of flax's
(in, out) kernel, and the token table is (vocab, embed). So every int8 weight
here is stored (N, K) with one scale per row N: a column-quantized flax kernel
becomes a row-quantized (out, in) weight, and the row-quantized table already
is one. One product, ``y = (x . q^T) * scale``, then serves both of JAX's
orientations (``int8_matmul`` and ``int8_matmul_t``). Quantization is JAX's,
bit for bit after that transpose: symmetric round-to-nearest-even over +-127
of the row's absmax (floored at 1e-8) / 127.

The product: CPU tensors take ``int8_matmul_plain``; CUDA tensors launch a
hand-written kernel of ``csrc/int8_matmul.cu`` (the port of the Pallas
``_int8_matmul_2d``; decode rows, M <= 80, take its decode kernel, which
splits K over a thread-block cluster, and more rows its prompt kernel),
which reads the weight from device memory as int8 and converts it to
bfloat16 on the chip, so no bfloat16 copy of a weight ever exists in device
memory. A CUDA tensor never takes the plain version:
the kernel launches or the wrapper raises. Its launches are counted in
``int8_matmul.launches``. The TPU kernel pads both dims to 128; the CUDA
kernel masks the ragged edge instead.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import cuda_build

# parameters whose consumers understand QTensor (pasero_tpu/ops/quantize.py
# :150-154): the Linear layers of attention and FFN and the token table
LINEAR_MODULES = frozenset({
    "q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2", "gate",
    "output_projection", "down", "up", "in_proj",
})
EMBED_MODULES = frozenset({"embed_tokens"})


class QTensor:
    """An int8 weight ``q`` (N, K), its float32 per-row scale (N,), and its
    logical shape (N, K): the dequantized weight is ``q * scale[:, None]``.
    It takes the place of a float weight in ``Linear.weight`` or
    ``Embedding.embedding``."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        if q.dtype != torch.int8 or q.dim() != 2:
            raise TypeError(f"q must be a 2D int8 tensor, got {q.dtype} "
                            f"{tuple(q.shape)}")
        if scale.dtype != torch.float32 or tuple(scale.shape) != q.shape[:1]:
            raise TypeError(f"scale must be float32 of shape {tuple(q.shape[:1])},"
                            f" got {scale.dtype} {tuple(scale.shape)}")
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return self.q.shape

    @property
    def device(self):
        return self.q.device

    def __repr__(self):
        return (f"QTensor(q={tuple(self.q.shape)} int8, "
                f"scale={tuple(self.scale.shape)})")


def quantize(w: torch.Tensor) -> QTensor:
    """Symmetric int8 quantization of a 2D weight, one scale per row: JAX's
    ``quantize(w.T, axis=0)`` transposed for an (out, in) weight, and JAX's
    ``quantize(w, axis=1)`` for a (vocab, embed) table."""
    w = w.detach().float()
    absmax = w.abs().amax(dim=1)
    scale = absmax.clamp(min=1e-8) / 127.0
    q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return QTensor(q, scale)


def dequantize(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    return (t.q.float() * t.scale[:, None]).to(dtype)


def _weights(model):
    """(module, attribute, value) of every weight the QTensor-aware modules
    read: Linear layers' ``weight`` and token tables' ``embedding``, each
    module once."""
    from ..models.modules import Embedding, Linear
    for name, module in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(module, Linear) and leaf in LINEAR_MODULES:
            yield module, "weight", module.weight
        elif isinstance(module, Embedding) and leaf in EMBED_MODULES:
            yield module, "embedding", module.embedding


def quantize_params(model, min_size: int = None) -> int:
    """Replace, in place, the float weights of the QTensor-aware modules that
    have at least ``min_size`` elements (default $PASERO_QUANTIZE_MIN_SIZE or
    1 << 16) by QTensors, by JAX's name rule (pasero_tpu/ops/quantize.py:157):
    the Linear layers named in LINEAR_MODULES and the ``embed_tokens``
    tables. Returns how many were quantized. The last load step of inference."""
    if min_size is None:
        min_size = int(os.environ.get("PASERO_QUANTIZE_MIN_SIZE", 1 << 16))
    chosen = [(module, attr, value) for module, attr, value in _weights(model)
              if isinstance(value, torch.Tensor) and value.dim() == 2
              and value.numel() >= min_size and value.is_floating_point()]
    for module, attr, value in chosen:
        qt = quantize(value)
        delattr(module, attr)
        setattr(module, attr, qt)
    return len(chosen)


def quantized_bytes(model) -> tuple:
    """(bytes of int8 weights and their scales, bytes of float parameters)."""
    qb = sum(v.q.numel() + 4 * v.scale.numel()
             for _, _, v in _weights(model) if isinstance(v, QTensor))
    fb = sum(p.numel() * p.element_size() for p in model.parameters())
    return qb, fb


def int8_matmul_plain(x, q, scale, out_dtype):
    """``(x . q^T) * scale`` as the kernel computes it: float32 sums of
    products of x (in its type) and the exact int8 values, rounded once to
    ``out_dtype``. x (M, K), q (N, K) int8, scale (N,) float32."""
    y = torch.matmul(x.float(), q.float().t()) * scale
    return y.to(out_dtype)


def _library():
    lib = cuda_build.load("int8_matmul")
    fn = lib.int8_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.int8_matmul_error_string.argtypes = [ctypes.c_int]
        lib.int8_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _int8_matmul_cuda(x, q, scale, out_dtype):
    """One launch of the int8 GEMM kernel on (M, K) bfloat16 x: the decode
    kernel for M <= 80, the prompt kernel above."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the int8 kernel takes bfloat16 x, got {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the int8 kernel writes bfloat16 or float32, got "
                        f"{out_dtype}")
    M, K = x.shape
    N = q.shape[0]
    if K % 16:
        raise ValueError(f"the int8 kernel takes K a multiple of 16, got {K}")
    if q.device != x.device or scale.device != x.device:
        raise ValueError(f"x lies on {x.device}, the weight on {q.device}")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    x, q, scale = (cuda_build.aligned(a) for a in (x, q, scale))
    lib = _library()
    with torch.cuda.device(x.device):
        status = lib.int8_matmul(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            M, N, K, int(out_dtype == torch.float32),
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("int8_matmul kernel failed: "
                           + lib.int8_matmul_error_string(status).decode())
    int8_matmul.launches += 1
    return out


def int8_matmul(x, t: QTensor, out_dtype=None):
    """``x @ dequantize(t).T`` with the weight read as int8.

    x: (..., K); t.q: (N, K) int8 with one scale per row. Returns (..., N) in
    ``out_dtype`` (default x's type). On CUDA tensors one launch of the
    kernel (bfloat16 x, K a multiple of 16, anything else raises); on CPU
    tensors the plain version. Inference only (no gradient)."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[1] != t.q.shape[1]:
        raise ValueError(f"x has {x2.shape[1]} features, the weight "
                         f"{tuple(t.q.shape)}")
    if x2.device.type == "cpu":
        out = int8_matmul_plain(x2, t.q, t.scale, out_dtype)
    elif x2.device.type == "cuda":
        out = _int8_matmul_cuda(x2, t.q, t.scale, out_dtype)
    else:
        raise ValueError(f"no int8 kernel for device {x2.device}")
    return out.reshape(lead + (t.q.shape[0],))


int8_matmul.launches = 0


def int8_matmul_t(x, t: QTensor, out_dtype=None):
    """The tied head's product with a row-quantized (V, E) table,
    ``x @ dequantize(t).T`` (pasero_tpu/ops/quantize.py:305). In the port's
    layout it is the same product as ``int8_matmul``."""
    return int8_matmul(x, t, out_dtype)


def embedding_lookup(t: QTensor, ids, dtype):
    """Rows of a row-quantized (V, E) table, dequantized in ``dtype``:
    ``q[ids] * scale[ids]``, both rounded to ``dtype`` first, as JAX does."""
    rows = t.q[ids].to(dtype)
    return rows * t.scale[ids][..., None].to(dtype)
