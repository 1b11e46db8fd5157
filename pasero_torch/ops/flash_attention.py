"""Flash attention for grouped K/V heads: forward and backward without the
(Sq, Sk) score matrix in memory.

Port of the bias-free path of pasero_tpu/ops/flash_attention.py (the public
``flash_attention`` :1566 and its ``jax.custom_vjp`` :1548-1563, over the
group-packed Pallas ``_fwd_packed`` :342 and ``_bwd_packed`` :1086).
``flash_attention`` is a ``torch.autograd.Function`` that returns ``out``
and keeps ``lse`` for its backward. On CUDA tensors its forward launches
``flash_fwd`` and its backward ``flash_bwd`` (``flash_bwd_dq``, then
``flash_bwd_dkv``: the three kernels of ``csrc/flash_attention.cu``, each
wrapper counting its launches); CPU tensors take ``flash_fwd_plain`` and
``flash_bwd_plain``. A CUDA tensor never takes the plain version: the kernels
launch or the wrapper raises.

The contract is JAX's: q (B, H, Sq, D) and k/v (B, Hkv, Sk, D), query head h
reading K/V head h // (H // Hkv); a boolean mask is reduced to a key mask by
``any`` over the queries; causality and the sliding window come from slot
indices; a padded key gets the -1e30 of ``_pad_penalty`` (its probability is
exactly 0); ``delta = sum(dO * out)`` is taken in float32 over the rounded
output. A row that sees no key gives out = 0 and lse = -1e30 (JAX's
``l == 0`` guard). The kernels round P to v's type before P.V and dS to q's
type before dS.K and dS^T.Q, as the Pallas kernels do; the plain versions
compute everything in float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)


def key_mask(mask, B: int, Sq: int, Sk: int):
    """(B, Sk) bool key mask of a boolean mask broadcastable to
    (B, 1|H, Sq, Sk): a key is kept if any query may attend it (head 0),
    which is exact for padding and causal masks (flash_attention.py:1587-1595)."""
    if mask is None:
        return None
    m = mask.expand(B, mask.shape[1], Sq, Sk)
    return m[:, 0].any(dim=-2)


def visible(kv_mask, Sq: int, causal: bool, window: Optional[int]):
    """(B, 1, Sq, Sk) bool: key j is visible from query row i (slot indices)."""
    Sk = kv_mask.shape[-1]
    ok = kv_mask[:, None, None, :]
    i = torch.arange(Sq, device=kv_mask.device)[:, None]
    j = torch.arange(Sk, device=kv_mask.device)[None, :]
    if causal:
        ok = ok & (j <= i)
    if window is not None:
        ok = ok & (i - j < window)
    return ok


def _grouped(x, group: int):
    """(B, Hkv, S, D) float32 repeated to (B, H, S, D), like ``jnp.repeat``."""
    return x.float().repeat_interleave(group, dim=1)


def flash_fwd_plain(q, k, v, kv_mask, scale: float, causal: bool,
                    window: Optional[int]):
    """The forward in plain PyTorch, in float32: (out in q's type,
    lse (B, H, Sq) float32)."""
    group = q.shape[1] // k.shape[1]
    ok = visible(kv_mask, q.shape[2], causal, window)
    s = torch.matmul(q.float(), _grouped(k, group).transpose(-1, -2)) * scale
    s = s.masked_fill(~ok, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~ok, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    empty = l == 0
    l = torch.where(empty, 1.0, l)
    out = torch.matmul(p, _grouped(v, group)) / l
    lse = torch.where(empty, NEG_INF, m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def flash_bwd_plain(q, k, v, kv_mask, out, lse, do, scale: float,
                    causal: bool, window: Optional[int]):
    """The backward in plain PyTorch, in float32: (dq, dk, dv) in the types
    of q, k and v, dk and dv summed over each K/V head's query heads."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    ok = visible(kv_mask, Sq, causal, window)
    qf, dof = q.float(), do.float()
    kf, vf = _grouped(k, group), _grouped(v, group)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~ok, 0.0)
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dk = dk.reshape(B, Hkv, group, Sk, D).sum(dim=2)
    dv = dv.reshape(B, Hkv, group, Sk, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _library():
    lib = cuda_build.load("flash_attention")
    if lib.flash_fwd.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dims = [i32] * 6 + [f32, i32, i32, ptr]   # B H Hkv Sq Sk D, scale ...
        lib.flash_fwd.argtypes = [ptr] * 6 + dims
        lib.flash_bwd_dq.argtypes = [ptr] * 9 + dims
        lib.flash_bwd_dkv.argtypes = [ptr] * 9 + dims
        for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} kernel failed: "
                           + lib.flash_error_string(status).decode())


def _operand(x):
    """Contiguous and 16-byte aligned, as the kernels' copies need."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _cuda_args(q, k, v, kv_mask, window):
    """Checked kernel operands and the launch's dimensions."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the flash kernels take bfloat16, got {name} "
                            f"{x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} lies on {x.device}, q on {q.device}")
    B, H, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"the flash kernels take head dims {HEAD_DIMS}, "
                         f"got {D}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    mask = kv_mask.to(device=q.device, dtype=torch.uint8).contiguous()
    return (_operand(q), _operand(k), _operand(v), mask,
            (B, H, Hkv, Sq, Sk, D))


def flash_fwd(q, k, v, kv_mask, scale: float, causal: bool,
              window: Optional[int]):
    """(out (B, H, Sq, D) bfloat16, lse (B, H, Sq) float32) from one launch
    of the forward kernel."""
    q, k, v, mask, dims = _cuda_args(q, k, v, kv_mask, window)
    out = torch.empty_like(q)
    lse = torch.empty(dims[:2] + dims[3:4], dtype=torch.float32,
                      device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               mask.data_ptr(), out.data_ptr(), lse.data_ptr(),
                               *dims, float(scale), int(causal), window or 0,
                               stream)
    _raise_on(lib, status, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_bwd_dq(q, k, v, kv_mask, out, lse, do, scale: float,
                 causal: bool, window: Optional[int]):
    """(dq bfloat16, delta (B, H, Sq) float32) from one launch of the dq
    kernel, which also computes delta = sum(dO * out) for the dk/dv kernel."""
    q, k, v, mask, dims = _cuda_args(q, k, v, kv_mask, window)
    if out.dtype != torch.bfloat16 or do.dtype != torch.bfloat16:
        raise TypeError(f"out and dO must be bfloat16, got {out.dtype} and "
                        f"{do.dtype}")
    out, do = _operand(out), _operand(do)
    lse = lse.float().contiguous()
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    lib = _library()
    with torch.cuda.device(q.device):
        status = lib.flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), *dims, float(scale), int(causal), window or 0,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, status, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq, delta


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, kv_mask, do, lse, delta, scale: float,
                  causal: bool, window: Optional[int]):
    """(dk, dv) in bfloat16 at K/V-head width from one launch of the dk/dv
    kernel, given the dq kernel's delta."""
    q, k, v, mask, dims = _cuda_args(q, k, v, kv_mask, window)
    if do.dtype != torch.bfloat16:
        raise TypeError(f"dO must be bfloat16, got {do.dtype}")
    do = _operand(do)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _library()
    with torch.cuda.device(q.device):
        status = lib.flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *dims, float(scale), int(causal), window or 0,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, status, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd(q, k, v, kv_mask, out, lse, do, scale: float, causal: bool,
              window: Optional[int]):
    """(dq, dk, dv) in bfloat16: the dq kernel, then the dk/dv kernel."""
    dq, delta = flash_bwd_dq(q, k, v, kv_mask, out, lse, do, scale, causal,
                             window)
    dk, dv = flash_bwd_dkv(q, k, v, kv_mask, do, lse, delta, scale, causal,
                           window)
    return dq, dk, dv


def _route(x, kernel, plain):
    if x.device.type == "cuda":
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"no flash-attention path for device {x.device}")


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale, causal, window):
        fwd = _route(q, flash_fwd, flash_fwd_plain)
        out, lse = fwd(q, k, v, kv_mask, scale, causal, window)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.args = (scale, causal, window)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        bwd = _route(q, flash_bwd, flash_bwd_plain)
        dq, dk, dv = bwd(q, k, v, kv_mask, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, mask=None, scale: float = 1.0,
                    causal: bool = False, window: Optional[int] = None):
    """Attention of q (B, H, Sq, D) over k/v (B, Hkv, Sk, D), H % Hkv == 0.

    mask: bool, broadcastable to (B, 1|H, Sq, Sk), True = attend; only its
    key validity is used (``key_mask``), and the causal and window structure
    is applied from slot indices. Returns out (B, H, Sq, D) in q's type.
    """
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not fit (B, H, Sq, D) and "
                         "(B, Hkv, Sk, D) with H % Hkv == 0")
    kv_mask = key_mask(mask, B, Sq, Sk)
    if kv_mask is None:
        kv_mask = torch.ones((B, Sk), dtype=torch.bool, device=q.device)
    return _FlashAttention.apply(q, k, v, kv_mask, float(scale), bool(causal),
                                 window)[0]
