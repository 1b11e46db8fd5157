"""Flash attention for grouped K/V heads, without a bias, with an additive
float32 bias or with T5's learned relative-position table: forward and
backward without the (Sq, Sk) score matrix in memory.

Port of pasero_tpu/ops/flash_attention.py (the public ``flash_attention``
:1566 and its ``jax.custom_vjp`` :1548-1563): the bias-free path over the
group-packed Pallas ``_fwd_packed`` :342 and ``_bwd_packed`` :1086, and the
dense-bias path (ALiBi) over ``_fwd`` :381, ``_bwd`` :1398 and
``_compute_dbias`` :1213, and the T5 path (``_flash_t5`` :1363) over the
streamed ``_fwd_stream`` :544, ``_bwd_stream`` :738 and ``_compute_demb``
:1318. ``flash_attention`` is a
``torch.autograd.Function`` that returns ``out`` and keeps ``lse`` for its
backward. On CUDA tensors its forward launches ``flash_fwd`` and its
backward ``flash_bwd_dq`` then ``flash_bwd_dkv`` (and ``flash_bwd_dbias``
for the bias's gradient; the T5 table's comes from the T5 dq kernel itself,
``flash_bwd_dq(..., table_grad=True)``, in both types): in bfloat16 the
wgmma kernels of
``csrc/flash_bwd.cu`` for the forward, dq (with demb) and dk/dv of every
bias kind, the kernel of ``csrc/flash_attention.cu`` for dbias; in float32
the kernels of ``csrc/flash_f32.cu`` for all of them. Each wrapper counts
its launches, those of a biased, a T5 or
a float32 kernel apart (``launch_counts`` names them ``flash_fwd_bias``,
``flash_fwd_t5``, ``flash_fwd_f32``, ``flash_fwd_t5_f32`` and so on). CPU
tensors take ``flash_fwd_plain``, ``flash_bwd_plain``, ``flash_dbias_plain``
and ``flash_demb_plain``. A CUDA tensor never takes the plain version: the
kernels launch or the wrapper raises.

The contract is JAX's: q (B, H, Sq, D) and k/v (B, Hkv, Sk, D), query head h
reading K/V head h // (H // Hkv); a boolean mask is reduced to a key mask by
``any`` over the queries; causality and the sliding window come from slot
indices; a padded key gets the -1e30 of ``_pad_penalty`` (its probability is
exactly 0); ``delta = sum(dO * out)`` is taken in float32 over the rounded
output. A row that sees no key gives out = 0 and lse = -1e30 (JAX's
``l == 0`` guard). The kernels take q, k and v all bfloat16 or all float32
and round P to v's type before P.V and dS to q's type before dS.K and
dS^T.Q, as the Pallas kernels do (so in float32 P and dS stay float32); the
plain versions compute everything in float32. The float32 kernels
(forward, dq, dk/dv and dbias) take the tensor cores with every operand (P
and dS too) split into two TF32 parts (``split_tf32``) and three products
of them, which keeps float32's accuracy where one TF32 product would keep
about three decimal digits.

The bias is float32 (b0, h0, Sq, Sk) with b0 in {1, B} and h0 in {1, H}
(JAX's ``_bias_rows`` :162): the kernels read the row of (b, h) through its
strides, so a shared bias is never broadcast to (B, H, Sq, Sk). It is added
to the scaled float32 score before the mask, in JAX's order, and the
softmax's max and lse stay in natural units, so a large finite bias (the
encoder ALiBi's -1e9) is an ordinary score, not a masked key: a row that
sees only -1e9 entries gets a softmax over them. dbias = P (dP - delta) in
float32, zero where masked, summed over the batch inside the kernel when
b0 = 1 and over the heads after it when h0 = 1.

The T5 bias (``T5Bias``: the (num_buckets, H) float32 table, the direction
and the bucketing constants) is never materialized on the flash path: the
kernels read the bucket of each key-query distance from the host-computed
index of ``models.positional.t5_distance_buckets`` (length Sq + Sk - 1, so
no transcendental runs on the card) and add table[bucket, h] to the score,
as a dense bias is added. Its gradient is dS summed by bucket per head,
(num_buckets, H) float32, with no (Sq, Sk) tensor. As in JAX the buckets
come from slot indices, which assumes right-padded rows (:92-97).

A deliberate difference from JAX: JAX's ``_bwd`` computes dbias for every
biased backward and the caller discards it when the bias is a constant
(ALiBi); here the dbias kernel runs only when the bias needs a gradient
(``ctx.needs_input_grad``), so ALiBi training launches it 0 times.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda_build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)   # the kernels' head dims; others are padded up


def padded_head_dim(D: int) -> int:
    """The smallest of ``HEAD_DIMS`` that is at least D; D itself past them
    (the kernels refuse it)."""
    return next((d for d in HEAD_DIMS if d >= D), D)


@dataclass(frozen=True, eq=False)
class T5Bias:
    """T5's relative-position bias as the kernels take it
    (pasero_tpu/ops/flash_attention.py:88): the learned (num_buckets, H)
    float32 table and its bucketing constants."""
    table: torch.Tensor
    bidirectional: bool = False
    num_buckets: int = 32
    max_distance: int = 128

    def index(self, Sq: int, Sk: int):
        """int32 (Sq + Sk - 1,): entry k - q + Sq - 1 is the bucket of query
        slot q and key slot k."""
        from ..models.positional import t5_distance_buckets
        return t5_distance_buckets(Sq, Sk, self.bidirectional,
                                   self.num_buckets, self.max_distance,
                                   self.table.device)

    @staticmethod
    def _by_slots(per_distance, Sq: int, Sk: int):
        """([H,] Sq, Sk) of a ([H,] Sq + Sk - 1) tensor by distance: entry
        (q, k) is entry k - q + Sq - 1, gathered a block of rows at a time,
        so no (Sq, Sk) index exists."""
        x = per_distance
        out = x.new_empty(x.shape[:-1] + (Sq, Sk))
        cols = torch.arange(Sk, device=x.device) + Sq - 1
        step = max(1, (1 << 24) // Sk)
        for q0 in range(0, Sq, step):
            rows = torch.arange(q0, min(Sq, q0 + step), device=x.device)
            out[..., q0:q0 + len(rows), :] = x[..., cols - rows[:, None]]
        return out

    def far_tiles(self, Sq: int, Sk: int):
        """The dq kernel's plan of tiles whose distances share the index's
        first or last bucket (``models.positional.t5_far_tiles``)."""
        from ..models.positional import t5_far_tiles
        return t5_far_tiles(Sq, Sk, self.bidirectional, self.num_buckets,
                            self.max_distance)

    def buckets(self, Sq: int, Sk: int):
        """(Sq, Sk) int32 bucket of every (query slot, key slot)."""
        return self._by_slots(self.index(Sq, Sk), Sq, Sk)

    def materialize(self, Sq: int, Sk: int):
        """The float32 bias (1, H, Sq, Sk) of slot indices."""
        per_distance = self.table.float().t()[:, self.index(Sq, Sk).long()]
        return self._by_slots(per_distance, Sq, Sk)[None]


def check_t5(t5: T5Bias, H: int) -> None:
    table = t5.table
    if table.dim() != 2 or tuple(table.shape) != (t5.num_buckets, H):
        raise ValueError(f"T5 table {tuple(table.shape)} is not "
                         f"({t5.num_buckets}, {H})")


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


def _scores(q, k, scale: float, bias):
    """float32 scaled scores (B, H, Sq, Sk), plus the bias (a tensor or a
    T5Bias, materialized from slot indices) in JAX's order."""
    group = q.shape[1] // k.shape[1]
    s = torch.matmul(q.float(), _grouped(k, group).transpose(-1, -2)) * scale
    if isinstance(bias, T5Bias):
        bias = bias.materialize(q.shape[2], k.shape[2])
    return s if bias is None else s + bias.float()


def flash_fwd_plain(q, k, v, kv_mask, scale: float, causal: bool,
                    window: Optional[int], bias=None):
    """The forward in plain PyTorch, in float32: (out in q's type,
    lse (B, H, Sq) float32); ``bias`` broadcasts to (B, H, Sq, Sk) or is
    a T5Bias."""
    group = q.shape[1] // k.shape[1]
    ok = visible(kv_mask, q.shape[2], causal, window)
    s = _scores(q, k, scale, bias).masked_fill(~ok, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~ok, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    empty = l == 0
    l = torch.where(empty, 1.0, l)
    out = torch.matmul(p, _grouped(v, group)) / l
    lse = torch.where(empty, NEG_INF, m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def _dscores(q, k, v, kv_mask, out, lse, do, scale, causal, window, bias):
    """(P, dS = P (dP - delta)) in float32, zero where masked."""
    group = q.shape[1] // k.shape[1]
    ok = visible(kv_mask, q.shape[2], causal, window)
    s = _scores(q, k, scale, bias)
    p = torch.exp(s - lse[..., None]).masked_fill(~ok, 0.0)
    dof = do.float()
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(dof, _grouped(v, group).transpose(-1, -2))
    return p, p * (dp - delta)


def flash_bwd_plain(q, k, v, kv_mask, out, lse, do, scale: float,
                    causal: bool, window: Optional[int], bias=None):
    """The backward in plain PyTorch, in float32: (dq, dk, dv) in the types
    of q, k and v, dk and dv summed over each K/V head's query heads."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    p, ds = _dscores(q, k, v, kv_mask, out, lse, do, scale, causal, window,
                     bias)
    qf, dof, kf = q.float(), do.float(), _grouped(k, group)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dk = dk.reshape(B, Hkv, group, Sk, D).sum(dim=2)
    dv = dv.reshape(B, Hkv, group, Sk, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def split_tf32(x):
    """(hi, lo) of float32 ``x`` as the float32 backward kernels split their
    operands for the tensor cores: hi = x rounded to TF32's 10 mantissa bits
    (to nearest, ties away from zero: cvt.rna.tf32.f32) and lo = x - hi
    rounded the same way, so a product a b is taken as hi_a hi_b + hi_a lo_b
    + lo_a hi_b. For tests: the kernels' arithmetic on the CPU."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(x.float())
    return hi, rna(x.float() - hi)


def flash_dbias_plain(q, k, v, kv_mask, out, lse, do, scale: float,
                      causal: bool, window: Optional[int], bias):
    """The bias's gradient in plain PyTorch: dS in float32, zero where
    masked, summed to the bias's own (b0, h0, Sq, Sk) shape."""
    _, ds = _dscores(q, k, v, kv_mask, out, lse, do, scale, causal, window,
                     bias)
    return _reduce_to(ds, bias.shape)


def flash_demb_plain(q, k, v, kv_mask, out, lse, do, scale: float,
                     causal: bool, window: Optional[int], t5: T5Bias):
    """The T5 table's gradient in plain PyTorch, (num_buckets, H) float32:
    dS in float32, zero where masked, summed by bucket per head (the sums
    taken in float64)."""
    _, ds = _dscores(q, k, v, kv_mask, out, lse, do, scale, causal, window,
                     t5)
    H, Sq, Sk = ds.shape[1:]
    buckets = t5.buckets(Sq, Sk).reshape(-1)
    demb = torch.zeros((H, t5.num_buckets), dtype=torch.float64,
                       device=ds.device)
    demb.index_add_(1, buckets, ds.double().sum(0).reshape(H, Sq * Sk))
    return demb.t().float()


def _reduce_to(ds, shape):
    """(B, H, Sq, Sk) summed over the axes that ``shape`` broadcasts."""
    if shape[0] == 1 and ds.shape[0] != 1:
        ds = ds.sum(dim=0, keepdim=True)
    if shape[1] == 1 and ds.shape[1] != 1:
        ds = ds.sum(dim=1, keepdim=True)
    return ds


# after the key mask: the bias pointer (None for none), the plane strides of
# its (batch, head) rows and the floats from one row to the next; the T5
# table and distance index (None for none) and the number of buckets, in
# ``_bias_args``'s order (dbias takes the first three)
_BIAS_TYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]


def _library():
    """``csrc/flash_attention.cu``: the bf16 dbias kernel."""
    lib = cuda_build.load("flash_attention")
    if lib.flash_bwd_dbias.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dims = [i32] * 6 + [f32, i32, i32, ptr]   # B H Hkv Sq Sk D, scale ...
        lib.flash_bwd_dbias.argtypes = [ptr] * 4 + _BIAS_TYPES[:3] + \
            [ptr] * 4 + dims
        lib.flash_bwd_dbias.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _set_types(lib, dbias: bool):
    """argtypes of the forward, dq and dk/dv entry points (each takes the
    bias operands in ``_bias_args``'s order; dq its demb operands after dq:
    the partial sums and the plan of far tiles); with ``dbias`` (the float32
    library) those of dbias."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i32] * 6 + [f32, i32, i32, ptr]   # B H Hkv Sq Sk D, scale ...
    entries = [lib.fwd, lib.bwd_dq, lib.bwd_dkv]
    lib.fwd.argtypes = [ptr] * 4 + _BIAS_TYPES + [ptr] * 2 + dims
    lib.bwd_dq.argtypes = [ptr] * 4 + _BIAS_TYPES + [ptr] * 6 + [i32] * 4 + \
        dims
    lib.bwd_dkv.argtypes = [ptr] * 4 + _BIAS_TYPES + [ptr] * 5 + dims
    if dbias:
        lib.bwd_dbias.argtypes = [ptr] * 4 + _BIAS_TYPES[:3] + [ptr] * 4 + dims
        entries.append(lib.bwd_dbias)
    for fn in entries:
        fn.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p


def _bwd_library():
    """``csrc/flash_bwd.cu``: the forward, dq (with T5's demb) and dk/dv
    kernels of every bias kind, in bfloat16."""
    lib = cuda_build.load("flash_bwd")
    if lib.bwd_dq.argtypes is None:
        _set_types(lib, False)
    return lib


def _f32_library():
    """``csrc/flash_f32.cu``: the float32 forward, dq (with T5's demb),
    dk/dv and dbias kernels of every bias kind."""
    lib = cuda_build.load("flash_f32")
    if lib.bwd_dq.argtypes is None:
        _set_types(lib, True)
    return lib


def _raise_on(lib, status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} kernel failed: "
                           + lib.flash_error_string(status).decode())


_operand = cuda_build.aligned


KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _cuda_args(q, k, v, kv_mask, window):
    """Checked kernel operands and the launch's dimensions: q, k and v all
    bfloat16 or all float32."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in KERNEL_DTYPES or x.dtype != q.dtype:
            raise TypeError(f"the flash kernels take q, k and v all bfloat16 "
                            f"or all float32, got {name} {x.dtype} beside q "
                            f"{q.dtype}")
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


def check_bias(bias, B: int, H: int, Sq: int, Sk: int) -> None:
    """A bias must be (b0, h0, Sq, Sk) with b0 in {1, B} and h0 in {1, H}."""
    if (bias.dim() != 4 or bias.shape[0] not in (1, B)
            or bias.shape[1] not in (1, H) or tuple(bias.shape[2:]) != (Sq, Sk)):
        raise ValueError(f"bias {tuple(bias.shape)} is not (1|{B}, 1|{H}, "
                         f"{Sq}, {Sk})")


def _t5_args(t5: T5Bias, q, dims):
    """The T5 table as float32 (num_buckets, H) on q's device, its distance
    index and the number of buckets."""
    _, H, _, Sq, Sk, _ = dims
    check_t5(t5, H)
    if t5.table.device != q.device:
        raise ValueError(f"T5 table lies on {t5.table.device}, q on "
                         f"{q.device}")
    return (_operand(t5.table.detach().float()), _operand(t5.index(Sq, Sk)),
            t5.num_buckets)


def _rows_apart(bias) -> Optional[int]:
    """The floats from one row of a float32 (b0, h0, Sq, Sk) bias to the
    next where the kernels can read it as it lies (unit-strided, 16-byte
    aligned rows, each (b, h) plane Sq of them apart), else None."""
    b0, h0, Sq, Sk = bias.shape
    ld = bias.stride(2) if Sq > 1 else Sk
    plane = Sq * ld
    if (bias.stride(3) != 1 and Sk > 1) or ld < Sk \
            or (h0 > 1 and bias.stride(1) != plane) \
            or (b0 > 1 and bias.stride(0) != h0 * plane) \
            or bias.data_ptr() % 16 != 0:
        return None
    return ld


def _bias_args(bias, q, dims):
    """The C operands of a bias: for a dense bias, float32 (b0 h0, Sq, Sk)
    rows on q's device, the plane strides of a batch and a head index (0
    where the bias is shared) and the floats from one row to the next (a
    bias whose rows are padded, as the model pads ALiBi's to a multiple of
    4 so that the kernels read it by TMA, is read as it lies; another one
    not laid out as rows is copied contiguous); for a T5Bias its table,
    distance index and number of buckets (``_t5_args``); the null operands
    of the other kind."""
    if bias is None:
        return None, 0, 0, 0, None, None, 0
    if isinstance(bias, T5Bias):
        return (None, 0, 0, 0) + _t5_args(bias, q, dims)
    B, H, _, Sq, Sk, _ = dims
    check_bias(bias, B, H, Sq, Sk)
    if bias.device != q.device:
        raise ValueError(f"bias lies on {bias.device}, q on {q.device}")
    b0, h0 = bias.shape[:2]
    rows = bias.float()
    ld = _rows_apart(rows)
    if ld is None:
        rows, ld = _operand(rows), Sk
    return (rows, (0 if b0 == 1 else h0), (0 if h0 == 1 else 1), ld, None,
            None, 0)


def _launch(name: str, device, *args, lib=None) -> None:
    """Call ``name`` of ``lib`` (flash_attention.cu's by default) on ``args``
    (tensors as their pointers) and the current stream of ``device``; raise
    on a failed launch."""
    lib = lib or _library()
    with torch.cuda.device(device):
        status = getattr(lib, name)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, status, name)


def _scalars(dims, scale, causal, window):
    return (*dims, float(scale), int(causal), window or 0)


def _count(wrapper, bias, dtype) -> None:
    """One launch more of ``wrapper``'s bias-free, biased or T5 kernel, its
    float32 instances counted apart."""
    end = "_f32" if dtype == torch.float32 else ""
    if bias is None:
        name = "launches"
    elif isinstance(bias, T5Bias):
        name = "t5_launches"
    else:
        name = "bias_launches"
    setattr(wrapper, name + end, getattr(wrapper, name + end) + 1)


def _count_own(wrapper, f32: bool) -> None:
    """One launch more of ``wrapper``'s only kernel (dbias), float32
    apart."""
    if f32:
        wrapper.launches_f32 += 1
    else:
        wrapper.launches += 1


def _flash_library(q):
    """The library of the forward, dq and dk/dv kernels of q's type."""
    return _f32_library() if q.dtype == torch.float32 else _bwd_library()


def flash_fwd(q, k, v, kv_mask, scale: float, causal: bool,
              window: Optional[int], bias=None):
    """(out (B, H, Sq, D) in q's type, lse (B, H, Sq) float32) from one
    launch of the forward kernel, biased when a float32 ``bias`` (b0, h0,
    Sq, Sk) is given (counted in ``bias_launches``), with the T5 table when
    it is a T5Bias (``t5_launches``), else bias-free (``launches``). In
    bfloat16 the wgmma kernel of csrc/flash_bwd.cu (its instance of the
    bias kind), in float32 csrc/flash_f32.cu's (counted in
    ``*_launches_f32``)."""
    q, k, v, mask, dims = _cuda_args(q, k, v, kv_mask, window)
    bias_ops = _bias_args(bias, q, dims)
    out = torch.empty_like(q)
    lse = torch.empty(dims[:2] + dims[3:4], dtype=torch.float32,
                      device=q.device)
    _launch("fwd", q.device, q, k, v, mask, *bias_ops, out, lse,
            *_scalars(dims, scale, causal, window), lib=_flash_library(q))
    _count(flash_fwd, bias, q.dtype)
    return out, lse


def _bwd_operands(q, out, do, lse):
    for name, x in (("out", out), ("dO", do)):
        if x is not None and x.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} as q is, got "
                            f"{x.dtype}")
    return (None if out is None else _operand(out), _operand(do),
            lse.float().contiguous())


def flash_bwd_dq(q, k, v, kv_mask, out, lse, do, scale: float,
                 causal: bool, window: Optional[int], bias=None,
                 table_grad: bool = False):
    """(dq in q's type, delta (B, H, Sq) float32) from one launch of the dq
    kernel (csrc/flash_bwd.cu's in bfloat16, csrc/flash_f32.cu's in
    float32), which also computes delta = sum(dO * out) for the dk/dv kernel
    and re-adds ``bias`` (the forward's) to the recomputed scores.

    With ``table_grad`` (a T5Bias ``bias``) the same launch also sums its
    float32 dS by bucket: the kernel writes one
    (num_buckets,) row of partial sums per (batch, head, 64-row query tile),
    without atomics, and a torch sum over the batches and query tiles
    follows, as JAX's grid sums them in order (flash_attention.py:1255-1318);
    it returns (dq, delta, the table's gradient (num_buckets, H) float32).
    Such a launch counts as a T5 dq launch and also in
    ``t5_demb_launches`` (``flash_bwd_dq_t5_demb`` in ``launch_counts``; in
    float32 ``t5_demb_launches_f32``, ``flash_bwd_dq_t5_demb_f32``)."""
    q, k, v, mask, dims = _cuda_args(q, k, v, kv_mask, window)
    bias_ops = _bias_args(bias, q, dims)
    out, do, lse = _bwd_operands(q, out, do, lse)
    if table_grad and not isinstance(bias, T5Bias):
        raise ValueError("the dq kernel sums the table's gradient of a "
                         "T5Bias only")
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    B, H, _, Sq, Sk, _ = dims
    partial, plan = None, (0, 0, 0, 0)
    if table_grad:
        partial = torch.empty((B, H, -(-Sq // 64), bias.num_buckets),
                              dtype=torch.float32, device=q.device)
        plan = bias.far_tiles(Sq, Sk)
    _launch("bwd_dq", q.device, q, k, v, mask, *bias_ops, out, do, lse, delta,
            dq, partial, *plan, *_scalars(dims, scale, causal, window),
            lib=_flash_library(q))
    _count(flash_bwd_dq, bias, q.dtype)
    if table_grad:
        name = "t5_demb_launches" + ("_f32" if q.dtype == torch.float32
                                     else "")
        setattr(flash_bwd_dq, name, getattr(flash_bwd_dq, name) + 1)
        return dq, delta, partial.sum(dim=(0, 2)).t()
    return dq, delta


def flash_bwd_dkv(q, k, v, kv_mask, do, lse, delta, scale: float,
                  causal: bool, window: Optional[int], bias=None):
    """(dk, dv) in k's type at K/V-head width from one launch of the dk/dv
    kernel (csrc/flash_bwd.cu's in bfloat16, csrc/flash_f32.cu's in
    float32), given the dq kernel's delta; with ``bias``, each query head of
    a group re-adds its own bias row (its own T5 table column)."""
    q, k, v, mask, dims = _cuda_args(q, k, v, kv_mask, window)
    bias_ops = _bias_args(bias, q, dims)
    _, do, lse = _bwd_operands(q, None, do, lse)
    delta = delta.float().contiguous()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("bwd_dkv", q.device, q, k, v, mask, *bias_ops, do, lse, delta, dk,
            dv, *_scalars(dims, scale, causal, window),
            lib=_flash_library(q))
    _count(flash_bwd_dkv, bias, q.dtype)
    return dk, dv


# the wrappers with a bias-free, a biased and a T5 kernel, each counted apart
_BY_KIND = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)


def flash_bwd_dbias(q, k, v, kv_mask, bias, do, lse, delta, scale: float,
                    causal: bool, window: Optional[int]):
    """The bias's gradient, float32 in the bias's own shape, from one launch
    of the dbias kernel (csrc/flash_attention.cu's in bfloat16,
    csrc/flash_f32.cu's in float32, counted in ``launches_f32``): dS = P
    (dP - delta), zero where masked, summed over the batch inside the kernel
    when b0 = 1; summed over the heads by a torch op after it when h0 = 1, as
    JAX does (flash_attention.py:1250-1251)."""
    q, k, v, mask, dims = _cuda_args(q, k, v, kv_mask, window)
    # the dbias kernels read contiguous rows (a learned bias lies so)
    rows, bs, hs = _bias_args(bias.contiguous(), q, dims)[:3]
    _, do, lse = _bwd_operands(q, None, do, lse)
    delta = delta.float().contiguous()
    B, H, _, Sq, Sk, _ = dims
    b0 = bias.shape[0]
    dbias = torch.empty((b0, H, Sq, Sk), dtype=torch.float32, device=q.device)
    f32 = q.dtype == torch.float32
    _launch("bwd_dbias" if f32 else "flash_bwd_dbias", q.device, q, k, v,
            mask, rows, bs, hs, do, lse, delta, dbias,
            *_scalars(dims, scale, causal, window),
            lib=_f32_library() if f32 else None)
    _count_own(flash_bwd_dbias, f32)
    return _reduce_to(dbias, bias.shape)


def flash_bwd_demb(q, k, v, kv_mask, t5: T5Bias, do, lse, delta,
                   scale: float, causal: bool, window: Optional[int]):
    """No kernel of its own: in both types the T5 dq kernel sums the table's
    gradient itself (``flash_bwd_dq(..., table_grad=True)``), so this
    refuses every call, and ``launch_counts`` keeps ``flash_bwd_demb`` and
    ``flash_bwd_demb_f32`` at 0."""
    raise TypeError("the T5 dq kernel sums the table's gradient: "
                    "flash_bwd_dq(..., table_grad=True)")


def launch_counts() -> dict:
    """The launches of each flash kernel by name; the biased and the T5
    instances of the forward, dq and dk/dv kernels count apart, as
    ``*_bias`` and ``*_t5``, and the float32 instances of every kernel as
    ``*_f32`` (``flash_fwd_f32``, ``flash_fwd_bias_f32``,
    ``flash_fwd_t5_f32``, ..., ``flash_bwd_demb_f32``). The T5 dq
    launches that also sum the table's gradient count again as
    ``flash_bwd_dq_t5_demb`` (``_f32`` in float32); ``flash_bwd_demb``
    has no kernel and stays 0 in both types."""
    counts = {}
    for end in ("", "_f32"):
        for kind, attr in (("", "launches"), ("_bias", "bias_launches"),
                           ("_t5", "t5_launches")):
            counts.update({fn.__name__ + kind + end: getattr(fn, attr + end)
                           for fn in _BY_KIND})
        counts["flash_bwd_dq_t5_demb" + end] = getattr(
            flash_bwd_dq, "t5_demb_launches" + end)
        for fn in (flash_bwd_dbias, flash_bwd_demb):
            counts[fn.__name__ + end] = getattr(fn, "launches" + end)
    return counts


def reset_launch_counts() -> None:
    for end in ("", "_f32"):
        for fn in _BY_KIND:
            for attr in ("launches", "bias_launches", "t5_launches"):
                setattr(fn, attr + end, 0)
        setattr(flash_bwd_dq, "t5_demb_launches" + end, 0)
        for fn in (flash_bwd_dbias, flash_bwd_demb):
            setattr(fn, "launches" + end, 0)


reset_launch_counts()


def flash_bwd(q, k, v, kv_mask, out, lse, do, scale: float, causal: bool,
              window: Optional[int], bias=None):
    """(dq, dk, dv) in q's type: the dq kernel, then the dk/dv kernel."""
    args = (scale, causal, window, bias)
    dq, delta = flash_bwd_dq(q, k, v, kv_mask, out, lse, do, *args)
    return (dq,) + flash_bwd_dkv(q, k, v, kv_mask, do, lse, delta, *args)


def _cuda_backward(q, k, v, kv_mask, out, lse, do, scale, causal, window,
                   bias, need_dbias: bool):
    """(dq, dk, dv, the bias's or the T5 table's gradient or None) from the
    kernels; the T5 dq kernel sums the table's gradient."""
    args = (scale, causal, window)
    if need_dbias and isinstance(bias, T5Bias):
        dq, delta, demb = flash_bwd_dq(q, k, v, kv_mask, out, lse, do, *args,
                                       bias, table_grad=True)
        dk, dv = flash_bwd_dkv(q, k, v, kv_mask, do, lse, delta, *args, bias)
        return dq, dk, dv, demb
    dq, delta = flash_bwd_dq(q, k, v, kv_mask, out, lse, do, *args, bias)
    dk, dv = flash_bwd_dkv(q, k, v, kv_mask, do, lse, delta, *args, bias)
    dbias = None
    if need_dbias:
        dbias = flash_bwd_dbias(q, k, v, kv_mask, bias, do, lse, delta, *args)
    return dq, dk, dv, dbias


def _plain_backward(q, k, v, kv_mask, out, lse, do, scale, causal, window,
                    bias, need_dbias: bool):
    grads = flash_bwd_plain(q, k, v, kv_mask, out, lse, do, scale, causal,
                            window, bias)
    dbias = None
    if need_dbias:
        grad = flash_demb_plain if isinstance(bias, T5Bias) else \
            flash_dbias_plain
        dbias = grad(q, k, v, kv_mask, out, lse, do, scale, causal, window,
                     bias)
    return grads + (dbias,)


def _route(x, kernel, plain):
    if x.device.type == "cuda":
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"no flash-attention path for device {x.device}")


class _FlashAttention(torch.autograd.Function):
    """``bias`` is a dense bias, or with ``t5`` (JAX's ``_flash_t5``
    custom VJP, :1363-1395) the T5 table, whose gradient the T5 dq kernel
    sums."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, bias, t5, scale, causal, window):
        fwd = _route(q, flash_fwd, flash_fwd_plain)
        full = T5Bias(bias, *t5) if t5 else bias
        out, lse = fwd(q, k, v, kv_mask, scale, causal, window, full)
        ctx.save_for_backward(q, k, v, kv_mask, bias, out, lse)
        ctx.args = (scale, causal, window)
        ctx.t5 = t5
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _):
        q, k, v, kv_mask, bias, out, lse = ctx.saved_tensors
        bwd = _route(q, _cuda_backward, _plain_backward)
        need_dbias = bias is not None and ctx.needs_input_grad[4]
        full = T5Bias(bias, *ctx.t5) if ctx.t5 else bias
        dq, dk, dv, dbias = bwd(q, k, v, kv_mask, out, lse, do, *ctx.args,
                                full, need_dbias)
        if dbias is not None:
            dbias = dbias.to(bias.dtype)
        return dq, dk, dv, None, dbias, None, None, None, None


def flash_attention(q, k, v, mask=None, bias=None, scale: float = 1.0,
                    causal: bool = False, window: Optional[int] = None,
                    t5_bias: Optional[T5Bias] = None):
    """Attention of q (B, H, Sq, D) over k/v (B, Hkv, Sk, D), H % Hkv == 0.

    mask: bool, broadcastable to (B, 1|H, Sq, Sk), True = attend; only its
    key validity is used (``key_mask``), and the causal and window structure
    is applied from slot indices. bias: float (1|B, 1|H, Sq, Sk), added to
    the scaled scores in float32; its gradient is computed when it requires
    one. t5_bias: T5's (num_buckets, H) table, turned into the bias inside
    the kernels from slot indices (right-padded rows), never with ``bias``;
    the table's gradient is computed when it requires one. Returns out (B,
    H, Sq, D) in q's type.

    A head dim that the kernels do not take is zero-padded to the next one
    (``padded_head_dim``) on every device, as JAX pads it
    (flash_attention.py:1597-1600): zero columns change neither the scores
    nor the output, the scale stays the caller's, and autograd slices the
    padding off dq, dk and dv.
    """
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not fit (B, H, Sq, D) and "
                         "(B, Hkv, Sk, D) with H % Hkv == 0")
    if bias is not None and t5_bias is not None:
        raise ValueError("flash_attention takes a bias or a T5 table, not "
                         "both")
    if bias is not None:
        check_bias(bias, B, H, Sq, Sk)
    t5 = None
    if t5_bias is not None:
        check_t5(t5_bias, H)
        bias = t5_bias.table
        t5 = (t5_bias.bidirectional, t5_bias.num_buckets,
              t5_bias.max_distance)
    kv_mask = key_mask(mask, B, Sq, Sk)
    if kv_mask is None:
        kv_mask = torch.ones((B, Sk), dtype=torch.bool, device=q.device)
    Dp = padded_head_dim(D)
    if Dp != D:
        q, k, v = (F.pad(x, (0, Dp - D)) for x in (q, k, v))
    out = _FlashAttention.apply(q, k, v, kv_mask, bias, t5, float(scale),
                                bool(causal), window)[0]
    return out[..., :D] if Dp != D else out
