"""Fused cross-entropy: the vocabulary head's loss without materialized logits.

Port of the training half of pasero_tpu/ops/fused_ce.py
(``fused_cross_entropy``, a ``jax.custom_vjp`` over the Pallas ``_fwd``,
``_bwd_matmuls`` and ``_bwd_split``). ``fused_cross_entropy`` is a
``torch.autograd.Function``: on CUDA tensors its forward launches
``fused_ce_fwd`` and its backward ``fused_ce_bwd`` (the dx and dW kernels of
``csrc/fused_ce.cu``); CPU tensors take ``fused_cross_entropy_plain``. A CUDA
tensor never takes the plain version: the kernels launch or the wrapper
raises.

The head weight is passed in its stored (V, E) layout (``Embedding.embedding``
or ``Linear.weight``), the transpose of JAX's (E, V) ``kernel`` argument; the
kernels read it as it is and the wrapper makes only the cast to x's type, as
JAX does.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _stats(lse, tgt, suml, weights, vocab: int, label_smoothing: float):
    """(loss_sum, nll_sum, weight_sum) from the per-row statistics
    (pasero_tpu/ops/fused_ce.py:490-501)."""
    w = weights.float()
    nll = lse - tgt
    if label_smoothing > 0:
        loss = ((1.0 - label_smoothing) * nll
                + label_smoothing * (lse - suml / vocab))
    else:
        loss = nll
    return (loss * w).sum(), (nll * w).sum(), w.sum()


def fused_cross_entropy_plain(x, weight, targets, weights,
                              label_smoothing: float = 0.0):
    """The same function in plain PyTorch, differentiable by autograd:
    float32 logits of operands in x's type, then logsumexp, the target gather
    and the logits sum."""
    logits = torch.matmul(x.float(), weight.to(x.dtype).float().t())
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long()[:, None])[:, 0]
    return _stats(lse, tgt, logits.sum(-1), weights, weight.shape[0],
                  label_smoothing)


def _check(x, weight, targets, weights) -> None:
    if x.dim() != 2 or weight.dim() != 2 or x.shape[1] != weight.shape[1]:
        raise ValueError(f"x must be (N, E) and weight (V, E), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    N = x.shape[0]
    if tuple(targets.shape) != (N,) or tuple(weights.shape) != (N,):
        raise ValueError(f"targets and weights must be ({N},), got "
                         f"{tuple(targets.shape)} and {tuple(weights.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if not weight.is_floating_point():
        raise TypeError(f"weight must be floating point, got {weight.dtype}")
    if targets.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"targets must be int32 or int64, got {targets.dtype}")
    devices = {t.device for t in (x, weight, targets, weights)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def _library():
    lib = cuda_build.load("fused_ce")
    if lib.fused_ce_fwd.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.fused_ce_fwd.argtypes = [ptr] * 6 + [i64] * 3 + [ctypes.c_int, ptr]
        for fn in (lib.fused_ce_bwd_dx, lib.fused_ce_bwd_dw):
            fn.argtypes = [ptr] * 8 + [i64] * 3 + [ctypes.c_int, ptr]
        for fn in (lib.fused_ce_fwd, lib.fused_ce_bwd_dx, lib.fused_ce_bwd_dw):
            fn.restype = ctypes.c_int
        lib.fused_ce_error_string.argtypes = [ctypes.c_int]
        lib.fused_ce_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} kernel failed: "
                           + lib.fused_ce_error_string(status).decode())


def _cuda_inputs(x, w, targets):
    if x.device.type != "cuda":
        raise ValueError(f"no fused-CE kernel for device {x.device}")
    if w.dtype != x.dtype:
        raise TypeError(f"weight must be cast to x's type {x.dtype}, got "
                        f"{w.dtype}")
    return x.contiguous(), w.contiguous(), targets.to(torch.int32).contiguous()


def fused_ce_fwd(x, w, targets):
    """Per-row (lse, target logit, logits sum) of ``x @ w.T`` in float32,
    from one launch of the forward kernel. x (N, E) and w (V, E) of one type
    (bfloat16 or float32) on the card; targets (N,) int."""
    x, w, t = _cuda_inputs(x, w, targets)
    N, E = x.shape
    V = w.shape[0]
    out = torch.empty((3, N), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.fused_ce_fwd(
            x.data_ptr(), w.data_ptr(), t.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), N, E, V, _DTYPES[x.dtype],
            stream)
    _raise_on(lib, status, "fused_ce_fwd")
    fused_ce_fwd.launches += 1
    return out[0], out[1], out[2]


fused_ce_fwd.launches = 0


def fused_ce_bwd(x, w, targets, lse, c1, c2, c3):
    """(dx (N, E) in x's type, dW (V, E) float32) for
    dlogits = c1 * softmax - c2 * onehot(targets) - c3, from one launch each
    of the dx and dW kernels (one count in ``fused_ce_bwd.launches``)."""
    x, w, t = _cuda_inputs(x, w, targets)
    N, E = x.shape
    V = w.shape[0]
    vecs = [v.float().contiguous() for v in (lse, c1, c2, c3)]
    dx = torch.empty_like(x)
    # every element of dW is written when there are rows to reduce over
    dw = (torch.empty if N else torch.zeros)((V, E), dtype=torch.float32,
                                             device=x.device)
    lib = _library()
    args = [x.data_ptr(), w.data_ptr(), t.data_ptr()] + \
        [v.data_ptr() for v in vecs]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.fused_ce_bwd_dx(*args, dx.data_ptr(), N, E, V,
                                     _DTYPES[x.dtype], stream)
        _raise_on(lib, status, "fused_ce_bwd_dx")
        status = lib.fused_ce_bwd_dw(*args, dw.data_ptr(), N, E, V,
                                     _DTYPES[x.dtype], stream)
        _raise_on(lib, status, "fused_ce_bwd_dw")
    fused_ce_bwd.launches += 1
    return dx, dw


fused_ce_bwd.launches = 0


class _FusedCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, targets, weights, label_smoothing):
        w = weight.to(x.dtype)
        lse, tgt, suml = fused_ce_fwd(x, w, targets)
        out = _stats(lse, tgt, suml, weights, weight.shape[0],
                     label_smoothing)
        ctx.save_for_backward(x, w, targets, weights, lse)
        ctx.label_smoothing = label_smoothing
        ctx.weight_dtype = weight.dtype
        ctx.mark_non_differentiable(out[2])
        return out

    @staticmethod
    def backward(ctx, gl, gn, _):
        # loss_row = w[(1-ls)(lse-tgt) + ls(lse - suml/V)], nll_row = w(lse-tgt):
        # dlogits = w[(a+b) softmax - a onehot - b/V], a = gl(1-ls) + gn,
        # b = gl ls (pasero_tpu/ops/fused_ce.py:504-518)
        x, w, targets, weights, lse = ctx.saved_tensors
        ls = ctx.label_smoothing
        V = w.shape[0]
        wt = weights.float()
        a = gl * (1.0 - ls) + gn
        b = gl * ls
        dx, dw = fused_ce_bwd(x, w, targets, lse, wt * (a + b), wt * a,
                              wt * (b / V))
        return dx, dw.to(ctx.weight_dtype), None, None, None


def fused_cross_entropy(x, weight, targets, weights,
                        label_smoothing: float = 0.0):
    """Summed label-smoothed CE over ``x @ weight.T`` logits.

    x: (N, E) activations (bfloat16 or float32); weight: (V, E) head weight;
    targets: (N,) int; weights: (N,) float (0 masks a row). Returns
    ``(loss_sum, nll_sum, weight_sum)``, the ``cross_entropy_loss`` contract.
    On the card the (N, V) logits never reach device memory in either
    direction; CPU tensors take ``fused_cross_entropy_plain``.
    """
    _check(x, weight, targets, weights)
    if x.device.type == "cpu":
        return fused_cross_entropy_plain(x, weight, targets, weights,
                                         label_smoothing)
    return _FusedCrossEntropy.apply(x, weight, targets, weights,
                                    float(label_smoothing))
