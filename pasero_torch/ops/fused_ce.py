"""Fused vocabulary heads: the cross-entropy loss, and the greedy argmax,
without materialized logits.

Port of pasero_tpu/ops/fused_ce.py. The training half: ``fused_cross_entropy``
(a ``jax.custom_vjp`` over the Pallas ``_fwd``, ``_bwd_matmuls`` and
``_bwd_split`` there) is a ``torch.autograd.Function``: on CUDA tensors its
forward launches ``fused_ce_fwd`` (in bf16 a wgmma product whose epilogue
writes per-tile logsumexp partials, then their merge) and its backward
``fused_ce_bwd`` (three wgmma products per vocabulary chunk,
``csrc/fused_ce.cu``; float32 takes the same design's split-TF32 kernels
there, which ``--dtype float32`` training runs); CPU tensors take
``fused_cross_entropy_plain``, and
``fused_ce_fwd_plain`` and ``fused_ce_bwd_plain`` are the two wrappers' own
plain versions, in the kernels' order of operations. The decoding half:
``fused_head_argmax`` (the Pallas ``fused_head_argmax`` and
``_fused_head_argmax_q8``) launches the kernels of ``csrc/fused_head.cu``
on CUDA tensors, counted in
``fused_head_argmax.launches`` (a bfloat16 head) and
``fused_head_argmax_q8.launches`` (an int8 QTensor head); CPU tensors take
``fused_head_argmax_plain``. A CUDA tensor never takes a plain version: the
kernels launch or the wrapper raises.

The head weight is passed in its stored (V, E) layout (``Embedding.embedding``
or ``Linear.weight``), the transpose of JAX's (E, V) ``kernel`` argument; the
kernels read it as it is and the wrapper makes only the cast to x's type, as
JAX does.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .quantize import QTensor

NEG_INF = -1e30
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# vocabulary rows per chunk of the backward: its bf16 scratch holds N x CHUNK
CHUNK = 8192
# vocabulary columns per partial of the forward (its wgmma tile's width):
# bf16, float32
FWD_TILE = 256
F32_TILE = 128
# lanes of a warp of the forward's merge, each taking every 32nd partial
MERGE_LANES = 32


def bwd_chunk(vocab: int) -> int:
    """Vocabulary rows per chunk of the backward (and of the float32
    forward) at ``vocab`` rows: CHUNK, or the whole vocabulary rounded up to
    the kernels' 256-row tiles when it is smaller."""
    return min(CHUNK, -(-vocab // 256) * 256)


def fwd_tile(dtype) -> int:
    """Vocabulary columns per partial of the forward in ``dtype``."""
    return FWD_TILE if dtype == torch.bfloat16 else F32_TILE


def f32_bwd_scratch(N: int, E: int, chunk: int) -> int:
    """Floats of the float32 backward's scratch: dl (N x chunk), a chunk of
    W's hi and lo planes as stored and transposed (4 chunk E) and x's
    transposed planes (2 E x N rounded up to 4)."""
    return N * chunk + 4 * chunk * E + 2 * E * (-(-N // 4) * 4)


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
        lib.fused_ce_fwd.argtypes = [ptr] * 8 + [i64] * 4 + [ctypes.c_int, ptr]
        lib.fused_ce_bwd.argtypes = [ptr] * 11 + [i64] * 4 + [ctypes.c_int, ptr]
        for fn in (lib.fused_ce_fwd, lib.fused_ce_bwd):
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


def _operands(x, w):
    """x and w contiguous and 16-byte aligned for the kernels, with E
    padded by zero columns to 16-byte rows for TMA (a multiple of 8 in bf16,
    of 4 in float32)."""
    pad = (-x.shape[1]) % (8 if x.dtype == torch.bfloat16 else 4)
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        w = torch.nn.functional.pad(w, (0, pad))
    return cuda_build.aligned(x), cuda_build.aligned(w)


def _merge(m, l, mo, lo):
    mn = torch.maximum(m, mo)
    return mn, l * torch.exp(m - mn) + lo * torch.exp(mo - mn)


def fused_ce_fwd_plain(x, w, targets, tile: int | None = None):
    """``fused_ce_fwd`` in plain PyTorch with the kernels' order: float32
    logits of operands in x's type; per ``tile`` vocabulary columns (by
    default ``fwd_tile`` of x's type, the kernels' tile) a
    partial (max, sum of exp(logit - max), target logit, logits sum); each
    row's partials merged as the merge kernel does, lane i of MERGE_LANES
    taking partials i, i + MERGE_LANES, ... in order, then the lanes meeting
    in a butterfly. Returns (lse, target logit, logits sum), float32."""
    logits = torch.matmul(x.float(), w.to(x.dtype).float().t())
    return merged_stats_plain(logits, targets, tile or fwd_tile(x.dtype))


def merged_stats_plain(logits, targets, tile: int):
    """``fused_ce_fwd_plain``'s statistics of float32 ``logits`` (N, V):
    the partials of ``tile`` columns and their merge, in the kernels'
    order."""
    N, V = logits.shape
    rounds = -(-V // (tile * MERGE_LANES))
    cols = rounds * MERGE_LANES * tile
    pad = torch.nn.functional.pad
    # (N, rounds, lanes, tile): partial r * lanes + i is lane i's r-th
    s = pad(logits, (0, cols - V), value=float("-inf")).view(
        N, rounds, MERGE_LANES, tile)
    z = pad(logits, (0, cols - V)).view(N, rounds, MERGE_LANES, tile)
    hit = targets.long()[:, None] == torch.arange(cols, device=logits.device)
    pm = s.amax(-1).clamp_min(NEG_INF)   # an empty partial: max -1e30, sum 0
    pl = torch.exp(s - pm[..., None]).sum(-1)
    pt = (z * hit.view(z.shape)).sum(-1)
    ps = z.sum(-1)
    m = torch.full((N, MERGE_LANES), NEG_INF, device=logits.device)
    l, t, sm = torch.zeros_like(m), torch.zeros_like(m), torch.zeros_like(m)
    for r in range(rounds):
        m, l = _merge(m, l, pm[:, r], pl[:, r])
        t = t + pt[:, r]
        sm = sm + ps[:, r]
    lane = torch.arange(MERGE_LANES, device=logits.device)
    off = MERGE_LANES // 2
    while off:
        other = lane ^ off
        m, l = _merge(m, l, m[:, other], l[:, other])
        t = t + t[:, other]
        sm = sm + sm[:, other]
        off //= 2
    return m[:, 0] + torch.log(l[:, 0]), t[:, 0], sm[:, 0]


def fused_ce_fwd(x, w, targets):
    """Per-row (lse, target logit, logits sum) of ``x @ w.T`` in float32,
    from one call of the forward (one count in ``fused_ce_fwd.launches``).
    x (N, E) and w (V, E) of one type on the card; targets (N,) int.
    bfloat16 takes the wgmma kernel, whose epilogue writes a partial per row
    and 256-column vocabulary tile into an (N, ceil(V / 256), 4) float32
    scratch, and the kernel that merges them. float32 takes the split-TF32
    kernels: per vocabulary chunk W's hi and lo planes (a scratch of 2 x
    chunk x E floats), then the product with the same epilogue's partials
    of 128-column tiles, and the same merge; ``--dtype float32`` training
    runs them."""
    x, w, t = _cuda_inputs(x, w, targets)
    x, w = _operands(x, w)
    N, E = x.shape
    V = w.shape[0]
    chunk = bwd_chunk(V)
    out = torch.empty((3, N), dtype=torch.float32, device=x.device)
    part = torch.empty((N, -(-V // fwd_tile(x.dtype)), 4), dtype=torch.float32,
                       device=x.device)
    scratch = None
    if x.dtype == torch.float32:
        scratch = torch.empty(2 * chunk * E, dtype=torch.float32,
                              device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.fused_ce_fwd(
            x.data_ptr(), w.data_ptr(), t.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), part.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, N, E, V,
            chunk, _DTYPES[x.dtype], stream)
    _raise_on(lib, status, "fused_ce_fwd")
    fused_ce_fwd.launches += 1
    return out[0], out[1], out[2]


fused_ce_fwd.launches = 0


def _dlogits(x, w, targets, lse, c1, c2, c3, v0: int):
    """dl of vocabulary rows [v0, v0 + len(w)) in float32 (float64 for
    float64 x) from logits of x and the chunk w, rounded to x's type."""
    s = torch.matmul(x.to(w.dtype), w.t())
    dl = c1[:, None] * torch.exp(s - lse[:, None])
    hit = targets.long()[:, None] == torch.arange(v0, v0 + w.shape[0],
                                                  device=x.device)
    dl = torch.where(hit, dl - c2[:, None], dl) - c3[:, None]
    return dl.to(x.dtype).to(w.dtype)


def fused_ce_bwd_plain(x, w, targets, lse, c1, c2, c3, chunk: int = CHUNK):
    """``fused_ce_bwd`` in plain PyTorch with the kernels' arithmetic: per
    chunk of ``chunk`` vocabulary rows, dl rounded to x's type, float32
    products, dW's rows written, dx accumulated in float32 and cast to x's
    type at the end (the float32 kernels add dl's target terms apart). In
    float64 operands it computes in float64."""
    N, E = x.shape
    V = w.shape[0]
    w = w.to(x.dtype)
    wide = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(wide)
    vecs = [v.to(wide) for v in (lse, c1, c2, c3)]
    dx = torch.zeros((N, E), dtype=wide, device=x.device)
    dw = torch.empty((V, E), dtype=wide, device=x.device)
    for v0 in range(0, V, chunk):
        wc = w[v0:v0 + chunk].to(wide)
        dl = _dlogits(x, wc, targets, *vecs, v0)
        dx += torch.matmul(dl, wc)
        dw[v0:v0 + chunk] = torch.matmul(dl.t(), xf)
    return dx.to(x.dtype), dw


def fused_ce_bwd(x, w, targets, lse, c1, c2, c3):
    """(dx (N, E) in x's type, dW (V, E) float32) for
    dlogits = c1 * softmax - c2 * onehot(targets) - c3, from one call of the
    kernels (one count in ``fused_ce_bwd.launches``). bfloat16 takes three
    wgmma products per chunk of ``CHUNK`` vocabulary rows through an
    (N, CHUNK) bf16 scratch (narrower for a smaller V) and, past one chunk,
    an (N, E) float32 accumulator of dx; an E that is not a multiple of 8 is
    padded with zero columns for the kernels' 16-byte rows. float32 takes
    the same design's split-TF32 kernels (``--dtype float32`` training runs
    them): dl in float32, W's hi and lo planes per chunk as stored and
    transposed, x's transposed once, in a scratch of ``f32_bwd_scratch``
    floats, dx summed in itself; E is padded to a multiple of 4."""
    x, w, t = _cuda_inputs(x, w, targets)
    E = x.shape[1]
    x, w = _operands(x, w)
    N, Ep = x.shape
    pad = Ep - E
    V = w.shape[0]
    vecs = [v.float().contiguous() for v in (lse, c1, c2, c3)]
    chunk = bwd_chunk(V)
    dx = torch.empty((N, Ep), dtype=x.dtype, device=x.device)
    # every element of dW is written when there are rows to reduce over
    dw = (torch.empty if N else torch.zeros)((V, Ep), dtype=torch.float32,
                                             device=x.device)
    dx_acc = None
    if x.dtype == torch.bfloat16:
        scratch = torch.empty((N, chunk), dtype=x.dtype, device=x.device)
        if V > chunk:
            dx_acc = torch.empty((N, Ep), dtype=torch.float32,
                                 device=x.device)
    else:
        scratch = torch.empty(f32_bwd_scratch(N, Ep, chunk),
                              dtype=torch.float32, device=x.device)
    lib = _library()
    ptrs = [x.data_ptr(), w.data_ptr(), t.data_ptr()] + \
        [v.data_ptr() for v in vecs] + \
        [a.data_ptr() if a is not None else None
         for a in (dx, dw, scratch, dx_acc)]
    with torch.cuda.device(x.device):
        status = lib.fused_ce_bwd(*ptrs, N, Ep, V, chunk, _DTYPES[x.dtype],
                                  torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, status, "fused_ce_bwd")
    fused_ce_bwd.launches += 1
    if pad:
        return dx[:, :E].contiguous(), dw[:, :E].contiguous()
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
        x, w, targets, weights, lse = ctx.saved_tensors
        dx, dw = fused_ce_bwd(x, w, targets, lse, *dlogit_coefficients(
            weights, gl, gn, ctx.label_smoothing, w.shape[0]))
        return dx, dw.to(ctx.weight_dtype), None, None, None


def dlogit_coefficients(weights, gl, gn, label_smoothing: float, vocab: int):
    """(c1, c2, c3) of dlogits = c1 softmax - c2 onehot - c3 for the output
    gradients gl (of loss_sum) and gn (of nll_sum): loss_row = w[(1-ls)(lse
    - tgt) + ls(lse - suml/V)] and nll_row = w(lse - tgt) give c1 = w(a + b),
    c2 = w a, c3 = w b / V with a = gl(1-ls) + gn, b = gl ls
    (pasero_tpu/ops/fused_ce.py:504-518)."""
    wt = weights.float()
    a = gl * (1.0 - label_smoothing) + gn
    b = gl * label_smoothing
    return wt * (a + b), wt * a, wt * (b / vocab)


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


# -- the greedy head --------------------------------------------------------

def fused_head_argmax_plain(x, weight):
    """(tokens (N,) int64, logprobs (N,) float32) of the float32 logits
    ``x . weight^T``: a float weight rounded to x's type first, an int8
    QTensor's sums multiplied by its per-row scale. The first index wins a
    tie (torch.argmax), and logprob = -log sum exp(s - max)."""
    if isinstance(weight, QTensor):
        logits = torch.matmul(x.float(), weight.q.float().t()) * weight.scale
    else:
        logits = torch.matmul(x.float(), weight.to(x.dtype).float().t())
    tokens = logits.argmax(dim=-1)
    m = logits.gather(1, tokens[:, None])
    logprobs = -torch.log(torch.exp(logits - m).sum(dim=-1))
    return tokens, logprobs


def _head_library():
    lib = cuda_build.load("fused_head")
    fn = lib.fused_head_argmax
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 3 + [i32] + [ptr] * 5 + [i32] * 3 + [ptr]
        fn.restype = i32
        lib.fused_head_blocks.argtypes = [i32] * 4
        lib.fused_head_blocks.restype = i32
        lib.fused_head_error_string.argtypes = [i32]
        lib.fused_head_error_string.restype = ctypes.c_char_p
    return lib


def _check_head(x, weight) -> None:
    if x.dim() != 2 or len(weight.shape) != 2 or x.shape[1] != weight.shape[1]:
        raise ValueError(f"x must be (N, E) and the head (V, E), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if weight.device != x.device:
        raise ValueError(f"x lies on {x.device}, the head on {weight.device}")


def _head_cuda(x, w, scale):
    """One launch each of the partials and the combine kernel; w is a
    bfloat16 (V, E) head, or int8 with its float32 scale. The partials
    kernel is the decode stream at up to 8 rows of a bfloat16 head or 16
    of an int8 one (the head as the m side of mma.sync, read once by TMA
    with the L2 evict-first hint), above them a wgmma product: the int8
    prompt kernel or, for a bfloat16 head, the fused CE forward's
    mainloop."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the fused-head kernels take bfloat16 x, got {x.dtype}")
    N, E = x.shape
    V = w.shape[0]
    if E % 16:
        raise ValueError(f"the fused-head kernels take E a multiple of 16, "
                         f"got {E}")
    if x.device.type != "cuda":
        raise ValueError(f"no fused-head kernel for device {x.device}")
    tokens = torch.empty(N, dtype=torch.int64, device=x.device)
    logprobs = torch.empty(N, dtype=torch.float32, device=x.device)
    if N == 0:
        return tokens, logprobs
    lib = _head_library()
    with torch.cuda.device(x.device):
        parts = lib.fused_head_blocks(N, V, E, int(scale is not None))
    part_m = torch.empty((parts, N), dtype=torch.float32, device=x.device)
    part_l = torch.empty_like(part_m)
    part_i = torch.empty((parts, N), dtype=torch.int32, device=x.device)
    x, w = cuda_build.aligned(x), cuda_build.aligned(w)
    scale = cuda_build.aligned(scale) if scale is not None else None
    with torch.cuda.device(x.device):
        status = lib.fused_head_argmax(
            x.data_ptr(), w.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            int(scale is not None), part_m.data_ptr(), part_l.data_ptr(),
            part_i.data_ptr(), tokens.data_ptr(), logprobs.data_ptr(), N, V, E,
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("fused_head_argmax kernels failed: "
                           + lib.fused_head_error_string(status).decode())
    return tokens, logprobs


def fused_head_argmax(x, weight):
    """Greedy decode head: ``argmax(x . weight^T)`` and its log-probability,
    with the (N, V) logits never in device memory.

    x: (N, E) in the compute type; weight: the (V, E) head, or an int8
    QTensor (then ``fused_head_argmax_q8``). Returns (tokens (N,) int64,
    logprobs (N,) float32), the first index winning a tie. On CUDA tensors
    one run of the kernels of ``csrc/fused_head.cu`` (bfloat16 x; a float
    weight is cast to x's type, a no-op for the bfloat16 copy the decoder
    keeps); on CPU tensors ``fused_head_argmax_plain``."""
    if isinstance(weight, QTensor):
        return fused_head_argmax_q8(x, weight)
    _check_head(x, weight)
    if x.device.type == "cpu":
        return fused_head_argmax_plain(x, weight)
    out = _head_cuda(x, weight.to(x.dtype), None)
    fused_head_argmax.launches += 1
    return out


fused_head_argmax.launches = 0


def fused_head_argmax_q8(x, t: QTensor):
    """``fused_head_argmax`` with an int8 (V, E) head and its per-row scale
    (pasero_tpu/ops/fused_ce.py:387): the weight is read as int8 and each
    logit multiplied by its row's scale."""
    _check_head(x, t)
    if x.device.type == "cpu":
        return fused_head_argmax_plain(x, t)
    out = _head_cuda(x, t.q, t.scale)
    fused_head_argmax_q8.launches += 1
    return out


fused_head_argmax_q8.launches = 0
