"""The port's hand-written kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports torch only, so it
also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from pasero_torch.ops.cache_update import (cache_slot_write_,
                                           cache_slot_write_floor,
                                           cache_slot_write_plain)
from pasero_torch.scripts.bench_int8 import int8_inputs


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU version")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((320, 8, 72, 64), torch.bfloat16),   # full-width decode: 16-byte copies
    ((8, 4, 192, 64), torch.bfloat16),    # llama_1b's decode
    ((1280, 16, 8, 128), torch.bfloat16),  # rows past one wave of the grid
    ((3, 4, 17, 18), torch.float32),      # 72-byte rows: scalar copies
    ((3, 4, 17, 36), torch.bfloat16),
])
def test_cache_slot_write_matches_plain(shape, dtype):
    """Bitwise equal, with the new block as a transposed view and in float32
    (the wrapper casts it to the cache's type)."""
    _need_card()
    R, H, L, D = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    for index in (0, L // 2, L - 1):
        k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        k_new = torch.randn((R, 1, H, D), generator=gen,
                            device="cuda").transpose(1, 2)
        v_new = torch.randn((R, 1, H, D), generator=gen,
                            device="cuda").transpose(1, 2)
        k2, v2 = k.clone(), v.clone()
        before = cache_slot_write_.launches
        cache_slot_write_(k, v, k_new, v_new, index)
        cache_slot_write_plain(k2, v2, k_new, v_new, index)
        torch.cuda.synchronize()
        assert cache_slot_write_.launches == before + 1
        assert torch.equal(k, k2) and torch.equal(v, v2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(320, 8, 72, 64), (8, 4, 192, 64)])
def test_cache_slot_write_in_graph_after_producer(shape):
    """Two consecutive writes (slots i and i + 1), each right after a
    kernel that writes its new blocks, captured in a CUDA graph: the
    replay equals the plain version bit for bit, so the programmatic
    launch's wait orders each write behind its producer (and the second
    producer behind the first write's reads). The floor kernel of the same
    launch changes nothing and counts no launch."""
    _need_card()
    R, H, L, D = shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    k = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    v = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    src_k, src_v = (torch.randn((2, R, H, 1, D), generator=gen,
                                device="cuda") for _ in range(2))
    k_new = torch.empty((R, H, 1, D), device="cuda", dtype=torch.bfloat16)
    v_new = torch.empty_like(k_new)
    i = L // 2
    want_k, want_v = k.clone(), v.clone()
    for j in range(2):
        cache_slot_write_plain(want_k, want_v, src_k[j], src_v[j], i + j)

    def steps():
        for j in range(2):
            k_new.copy_(src_k[j])   # the producer: a cast kernel
            v_new.copy_(src_v[j])
            cache_slot_write_(k, v, k_new, v_new, i + j)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        steps()   # eager, on a side stream: the capture's warm-up
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(k, want_k) and torch.equal(v, want_v)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        steps()
    base_k = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    base_v = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    k.copy_(base_k)
    v.copy_(base_v)
    want_k, want_v = base_k.clone(), base_v.clone()
    for j in range(2):
        cache_slot_write_plain(want_k, want_v, src_k[j], src_v[j], i + j)
    before = cache_slot_write_.launches
    graph.replay()
    cache_slot_write_floor(k, v, k_new, v_new, i)
    torch.cuda.synchronize()
    assert torch.equal(k, want_k) and torch.equal(v, want_v)
    assert cache_slot_write_.launches == before


@pytest.mark.cuda
def test_cache_slot_write_raises_on_card():
    """On CUDA tensors the wrapper launches or raises; a slot outside the
    cache launches nothing."""
    _need_card()
    k = torch.zeros((2, 3, 5, 8), device="cuda")
    new = torch.ones((2, 3, 1, 8), device="cuda")
    before = cache_slot_write_.launches
    with pytest.raises(IndexError):
        cache_slot_write_(k, k.clone(), new, new, 5)
    assert cache_slot_write_.launches == before


FCE_SHAPES = [((130, 48, 515), torch.bfloat16),    # ragged rows and vocab
              ((130, 48, 515), torch.float32),     # the split-TF32 kernels
              ((64, 36, 100), torch.float32),      # E padded to 40
              ((48, 2048, 330), torch.bfloat16),   # width over one block
              ((64, 36, 100), torch.bfloat16),     # width not a multiple of 8
              ((2048, 512, 51865), torch.bfloat16),    # whisper_base's head
              ((8192, 2048, 32000), torch.bfloat16),   # llama_1b's head
              # the backward's vocabulary chunks (CHUNK = 8192 rows): one
              # chunk exactly, one row more, several with a ragged last one
              ((256, 128, 8192), torch.bfloat16),
              ((256, 128, 8193), torch.bfloat16),
              ((256, 136, 3 * 8192 + 1000), torch.bfloat16),
              ((4096, 768, 32128), torch.bfloat16),    # t5_base's head
              ((8192, 1024, 250880), torch.bfloat16),  # bloom_560m's head
              # float32: t5_base's head (its float32 training), the chunks
              ((4096, 768, 32128), torch.float32),
              ((256, 128, 8193), torch.float32),
              ((256, 136, 3 * 8192 + 1000), torch.float32)]


# The fused-CE gradients against float32 ones of the same operand values, in
# a limit per element: |got - want| <= rtol |want| + atol + K u S.
# In bf16 the kernels round each dlogits term to bf16 (relative error up to
# u = 2^-8) before the products, as JAX does, so an element's error is a sum
# of rounding errors of its terms a_i (dl * w for dx, dl * x for dW): at most
# u sqrt(m) S for m terms that dominate, S = sqrt(sum a_i^2), and of standard
# deviation u S / sqrt(3) when many terms add. K = 4 covers both, and rtol the
# bf16 rounding of dx. In float32 only the summation order differs: the
# split-TF32 kernels' products keep float32's accuracy, and the same kernels
# given x and w rounded to TF32 (one TF32 product, ``round_tf32``) must land
# at F32_TF32_MIN times the limits or more.
# Readings on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 4): errors at
# most 0.52 of these limits in bf16 and 0.30 in float32 (t5_base's dW); a
# backward given another row's lse lands at 320x of them or more.
FCE_GRAD_TOL = {torch.bfloat16: (1e-2, 1e-6, 4.0), torch.float32: (1e-4, 1e-6, 0.0)}
U_BF16 = 2.0 ** -8


# The float32 forward's lse against float64's. The gradient reference below
# takes the kernel's own lse, so an lse error shifts the kernels' and the
# reference's softmax alike and cancels in the gradient check: only this
# limit ties the float32 gradients to the exact ones. A float32 sum's error,
# not STAT_ATOL's bf16-sized one: readings at most 1.2e-6 on an H100 80GB
# HBM3 at 700 W (chip_smoke.py phase 4, t5_base's head among its cases).
F32_LSE_ATOL = 1e-5


def f32_reference_grads(x, w, t, cs):
    """The float32 kernels' reference gradients (dx, dW): the plain backward
    in float64 given the forward kernel's own lse (held within F32_LSE_ATOL
    of float64's), and that lse. No float32 reference, and no reference with
    an lse of its own, can serve: at t5_base's head dW's softmax terms c1 p
    x (up to about 5) cancel against the targets' -c2 x to sums near 1e-3,
    where the limit is about 1e-6, while float32 gives p = exp(s - lse) a
    relative error of at least u (|s| + |lse|) with |lse| near 12. The
    float32 plain version, with its own lse, lies 6.3 times the limits from
    this reference there (chip_smoke.py phase 4, H100 80GB HBM3, 700 W)."""
    from pasero_torch.ops.fused_ce import fused_ce_bwd_plain, fused_ce_fwd
    lse = fused_ce_fwd(x, w, t)[0]
    return fused_ce_bwd_plain(x.double(), w.double(), t, lse, *cs), lse


def fused_ce_grad_limits(x, w, t, lse, c1, c2, c3, want):
    """Per-element limits on the kernels' (dx, dW) for x (N, E), w (V, E) in
    x's type and the float32 gradients ``want``; dlogits = c1 softmax -
    c2 onehot(t) - c3 with the float32 ``lse``."""
    rtol, atol, k = FCE_GRAD_TOL[x.dtype]
    limits = [rtol * g.abs() + atol for g in want]
    if k:
        xf, wf = x.float(), w.float()
        dl = torch.exp(torch.matmul(xf, wf.t()) - lse[:, None])
        dl.mul_(c1[:, None]).sub_(c3[:, None])
        dl.scatter_add_(1, t.long()[:, None], -c2[:, None])
        dl.square_()
        for limit, sq in zip(limits, (torch.matmul(dl, wf.square()),
                                      torch.matmul(dl.t(), xf.square()))):
            limit.add_(sq.sqrt_().mul_(k * U_BF16))
    return limits


def fused_ce_grad_excess(got, want, limit) -> float:
    """max |got - want| / limit: at most 1 within the limits."""
    return ((got.float() - want).abs() / limit).max().item()


F32_TF32_MIN = 2.8


def round_tf32(x):
    """x rounded to TF32's 10 mantissa bits (to nearest), as a TF32 product
    rounds its operands."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def fused_ce_tf32_excess(x, w, t, cs, want, limits, logits) -> tuple:
    """The float32 kernels given x and w rounded to TF32 (so that each
    product is one TF32 product): the forward's worst statistic over its
    limit (lse and target over STAT_ATOL, the logits sum over STAT_SUM_RTOL
    of its row's |sum|) against the float32 ``logits``, and the backward's
    worst gradient over ``limits`` against ``want`` (dx, dW)."""
    from pasero_torch.ops.fused_ce import fused_ce_bwd, fused_ce_fwd
    xr, wr = round_tf32(x), round_tf32(w)
    stats = fused_ce_fwd(xr, wr, t)
    lse_err, tgt_err, sum_err = fused_ce_stat_errors(stats, logits, t)
    grads = fused_ce_bwd(xr, wr, t, stats[0], *cs)
    return (max(lse_err / STAT_ATOL, tgt_err / STAT_ATOL,
                sum_err / STAT_SUM_RTOL),
            max(fused_ce_grad_excess(g, w_, lim)
                for g, w_, lim in zip(grads, want, limits)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", FCE_SHAPES)
@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_fused_ce_kernels_match_plain(shape, dtype, ls):
    """Sums rtol 1e-5; gradients within ``fused_ce_grad_limits`` of the plain
    version's float32 gradients of the same operand values (x and the weight
    rounded to x's type first, so the reference rounds nothing) in bf16, of
    ``f32_reference_grads`` in float32, whose lse lies within F32_LSE_ATOL
    of float64's. x has a per-row scale, so that the same check rejects the
    backward given another row's lse; in float32 the kernels given x and w
    rounded to TF32 land at F32_TF32_MIN times the limits or more."""
    from pasero_torch.ops.fused_ce import (CHUNK, dlogit_coefficients,
                                           fused_ce_bwd, fused_ce_fwd,
                                           fused_cross_entropy,
                                           fused_cross_entropy_plain)
    _need_card()
    N, E, V = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = 0.5 + 1.5 * torch.rand(N, 1, generator=gen, device="cuda")
    x = (torch.randn(N, E, generator=gen, device="cuda") * scale).to(dtype)
    w = torch.randn(V, E, generator=gen, device="cuda") * E ** -0.5
    t = torch.randint(0, V, (N,), generator=gen, device="cuda")
    wt = (torch.rand(N, generator=gen, device="cuda") >= 0.2).float()
    wb = w.to(dtype)
    outs, grads = [], []
    before = (fused_ce_fwd.launches, fused_ce_bwd.launches)
    for fn, xi, wi in ((fused_cross_entropy, x, w),
                       (fused_cross_entropy_plain, x.float(), wb.float())):
        xi, wi = xi.clone().requires_grad_(), wi.clone().requires_grad_()
        out = fn(xi, wi, t, wt, ls)
        (out[0] + 0.5 * out[1]).backward()
        outs.append([o.item() for o in out])
        grads.append((xi.grad, wi.grad))
    torch.cuda.synchronize()
    assert (fused_ce_fwd.launches, fused_ce_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    (lk, nk, dk), (lp, np_, dp) = outs
    assert lk == pytest.approx(lp, rel=1e-5)
    assert nk == pytest.approx(np_, rel=1e-5)
    assert dk == dp

    # the backward's coefficients as autograd gives them
    gl, gn = (torch.tensor(g, device="cuda") for g in (1.0, 0.5))
    cs = dlogit_coefficients(wt, gl, gn, ls, V)
    if dtype == torch.float32:
        grads[1], lse = f32_reference_grads(x, wb, t, cs)
        ref_lse = torch.logsumexp(torch.matmul(x.double(), wb.double().t()),
                                  -1)
        assert (lse - ref_lse).abs().max().item() <= F32_LSE_ATOL
        del ref_lse
    else:
        lse = torch.logsumexp(torch.matmul(x.float(), wb.float().t()), -1)
    limits = fused_ce_grad_limits(x, wb, t, lse, *cs, grads[1])
    torch.cuda.empty_cache()
    excess = [fused_ce_grad_excess(got, want, limit)
              for got, want, limit in zip(grads[0], grads[1], limits)]
    assert max(excess) <= 1.0, excess
    bad = fused_ce_bwd(x, wb, t, fused_ce_fwd(x, wb, t)[0].roll(1), *cs)
    assert min(fused_ce_grad_excess(got, want, limit) for got, want, limit
               in zip(bad, grads[1], limits)) > 1.0
    if dtype == torch.float32:
        logits = torch.matmul(x, wb.t())
        assert min(fused_ce_tf32_excess(x, wb, t, cs, grads[1], limits,
                                        logits)) >= F32_TF32_MIN
        del logits
    if V > CHUNK:
        # dW rolled by one chunk; dx without the last chunk's share where a
        # target lies in it (else the share is the softmax tail alone, below
        # the bf16 error model)
        assert fused_ce_grad_excess(grads[0][1].roll(CHUNK, 0), grads[1][1],
                                    limits[1]) > 1.0
        v_last = (V - 1) // CHUNK * CHUNK
        if (t >= v_last).any():
            part = fused_ce_bwd(x, wb[:v_last], t, lse, *cs)[0]
            assert fused_ce_grad_excess(part, grads[1][0], limits[0]) > 1.0


# The bf16 forward's per-row statistics against float32 logits of the same
# operands (they differ by summation order only): lse and the target logit
# within STAT_ATOL, the logits sum within STAT_SUM_RTOL of the row's |sum|,
# as chip_smoke.py phase 4 holds them.
STAT_ATOL = 1e-4
STAT_SUM_RTOL = 1e-6


def fused_ce_stat_errors(stats, logits, t):
    """(lse, target logit, logits sum) errors of ``stats`` against float32
    ``logits``: the first two absolute, the sum relative to the row's
    |sum|."""
    lse, tgt, suml = stats
    return ((lse - torch.logsumexp(logits, -1)).abs().max().item(),
            (tgt - logits.gather(-1, t.long()[:, None])[:, 0]).abs().max().item(),
            ((suml - logits.sum(-1)).abs() / logits.abs().sum(-1)).max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (130, 48, 3 * 256 + 37),   # several 256-column tiles, a ragged last one
    (50, 64, 1000),            # N below one 128-row tile
    (64, 36, 100)])            # E padded to 40, V below one tile
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_ce_fwd_matches_plain(shape, dtype):
    """The forward (its wgmma product's partials and their merge, one count
    in ``fused_ce_fwd.launches``; float32 in split TF32 with 128-column
    tiles) against float32 logits of the same operands and against
    ``fused_ce_fwd_plain``, its own plain version in the kernels' order,
    each within STAT_ATOL / STAT_SUM_RTOL; a forward whose targets are
    rolled by one row lies outside them."""
    from pasero_torch.ops.fused_ce import fused_ce_fwd, fused_ce_fwd_plain
    _need_card()
    N, E, V = shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.randn(N, E, generator=gen, device="cuda")
         * (0.5 + 1.5 * torch.rand(N, 1, generator=gen, device="cuda"))
         ).to(dtype)
    w = (torch.randn(V, E, generator=gen, device="cuda") * E ** -0.5).to(dtype)
    t = torch.randint(0, V, (N,), generator=gen, device="cuda")
    before = fused_ce_fwd.launches
    got = fused_ce_fwd(x, w, t)
    torch.cuda.synchronize()
    assert fused_ce_fwd.launches == before + 1
    logits = torch.matmul(x.float(), w.float().t())
    for stats in (got, fused_ce_fwd_plain(x, w, t)):
        lse_err, tgt_err, sum_err = fused_ce_stat_errors(stats, logits, t)
        assert lse_err <= STAT_ATOL and tgt_err <= STAT_ATOL, (lse_err, tgt_err)
        assert sum_err <= STAT_SUM_RTOL, sum_err
    rolled = fused_ce_fwd(x, w, t.roll(1))
    assert fused_ce_stat_errors(rolled, logits, t)[1] > STAT_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_ce_fwd_same_bits(dtype):
    """Two forward calls give the same bits: each (row, vocabulary tile)
    writes one partial, merged in a fixed order, with no atomics."""
    from pasero_torch.ops.fused_ce import fused_ce_fwd
    _need_card()
    N, E, V = 1000, 512, 3 * 8192 + 1000
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(N, E, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(V, E, generator=gen, device="cuda") * E ** -0.5).to(dtype)
    t = torch.randint(0, V, (N,), generator=gen, device="cuda")
    first, second = fused_ce_fwd(x, w, t), fused_ce_fwd(x, w, t)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((130, 48, 515), torch.bfloat16),
    ((64, 36, 100), torch.bfloat16),                # E padded to 40
    ((1000, 512, 3 * 8192 + 1000), torch.bfloat16),  # four chunks
    ((4096, 768, 32128), torch.bfloat16),           # t5_base's head
    ((130, 48, 515), torch.float32),
    ((64, 36, 100), torch.float32),                 # E padded to 40
    ((1000, 512, 3 * 8192 + 1000), torch.float32)])
def test_fused_ce_bwd_matches_bwd_plain(shape, dtype):
    """The backward kernels against fused_ce_bwd_plain on the same inputs:
    both round dlogits to x's type per chunk and sum in float32, so they
    differ by summation order, by one bf16 step of dx (rtol 2^-7; float32
    1e-5) and, where the kernels' exponential and torch.exp round one
    dlogit to neighbouring bf16 values, by atol 2^-10 of the largest
    magnitude; dW rtol 1e-5."""
    from pasero_torch.ops.fused_ce import (fused_ce_bwd, fused_ce_bwd_plain,
                                           fused_ce_fwd)
    _need_card()
    N, E, V = shape
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = (torch.randn(N, E, generator=gen, device="cuda")
         * (0.5 + 1.5 * torch.rand(N, 1, generator=gen, device="cuda"))
         ).to(dtype)
    w = (torch.randn(V, E, generator=gen, device="cuda") * E ** -0.5).to(dtype)
    t = torch.randint(0, V, (N,), generator=gen, device="cuda")
    c = torch.rand(N, generator=gen, device="cuda")
    args = (x, w, t, fused_ce_fwd(x, w, t)[0], 1.1 * c, c, 0.1 * c / V)
    dx_rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    for got, want, rtol in zip(fused_ce_bwd(*args), fused_ce_bwd_plain(*args),
                               (dx_rtol, 1e-5)):
        got, want = got.float(), want.float()
        limit = rtol * want.abs() + 2.0 ** -10 * want.abs().max()
        assert ((got - want).abs() <= limit).all(), \
            ((got - want).abs() / limit).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(130, 48, 515), (1000, 512, 3 * 8192 + 1000)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_ce_bwd_same_bits(shape, dtype):
    """Two backward calls give the same bits: no atomics, no split sums."""
    from pasero_torch.ops.fused_ce import fused_ce_bwd, fused_ce_fwd
    _need_card()
    N, E, V = shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(N, E, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(V, E, generator=gen, device="cuda") * E ** -0.5).to(dtype)
    t = torch.randint(0, V, (N,), generator=gen, device="cuda")
    c = torch.rand(N, generator=gen, device="cuda")
    lse = fused_ce_fwd(x, w, t)[0]
    (dx, dw), (dx2, dw2) = [fused_ce_bwd(x, w, t, lse, c, c, c / V)
                            for _ in range(2)]
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "shape", "weight_type"])
def test_fused_ce_bad_input_raises_on_card(bad):
    """A bad input on the card raises before any launch."""
    from pasero_torch.ops.fused_ce import (fused_ce_bwd, fused_ce_fwd,
                                           fused_cross_entropy)
    _need_card()
    x = torch.zeros((8, 16), device="cuda", dtype=torch.bfloat16)
    w = torch.zeros((10, 16), device="cuda")
    t = torch.zeros(8, dtype=torch.long, device="cuda")
    wt = torch.ones(8, device="cuda")
    before = (fused_ce_fwd.launches, fused_ce_bwd.launches)
    with pytest.raises((TypeError, ValueError)):
        if bad == "dtype":
            fused_cross_entropy(x.half(), w, t, wt, 0.1)
        elif bad == "shape":
            fused_cross_entropy(x, w[:, :8], t, wt, 0.1)
        else:   # the kernel wrapper takes w already in x's type
            fused_ce_fwd(x, w, t)
    assert (fused_ce_fwd.launches, fused_ce_bwd.launches) == before


# The flash-attention kernels against the plain version's float32 results of
# the same bfloat16 inputs, in a limit per element of the same form as the
# fused CE's: |got - want| <= rtol |want| + atol + K u S + scale F. The
# kernels round P to bf16 before P.V and P^T.dO, and dS before dS.K and
# dS^T.Q (relative error up to u = 2^-8 each), as the Pallas kernels do, so
# an element's error is a sum of rounding errors of its terms a_i (P v for
# out, P dO for dv, scale dS k for dq, scale dS q for dk), S = sqrt(sum
# a_i^2); rtol covers the bf16 rounding of the outputs. dS = P (dO.v -
# delta) cancels: where a row sees one key, dO.v and delta are the same
# number summed in another order, and dS is float32 noise of either sum. F
# bounds that noise, 2^-20 (|dO|.|v| + |dO|.|out|) per unit of P, carried
# through |k| into dq and |q| into dk (readings on an H100 at 700 W: dq
# errors of 1.3e-6 at such rows, within 1e-6 + K u S otherwise). The same
# limits reject a backward given another row's lse.
FLASH_TOL = (1e-2, 1e-6, 4.0)

FLASH_SHAPES = [   # (B, H, Hkv, S or (Sq, Sk), D), causal, window, padded
    ((2, 8, 2, 256, 64), True, None, False),
    ((2, 4, 4, 200, 128), True, 48, True),    # ragged S, window, padding
    ((1, 6, 3, 77, 64), False, None, True),   # unaligned S, not causal
    ((3, 4, 2, 45, 32), True, None, True),    # the mini LM's head dim
    ((4, 12, 12, (128, 512), 64), False, None, True),   # cross-attention
    ((2, 4, 2, (96, 300), 32), False, None, True),      # and at D = 32
]


def flash_lengths(S):
    """(Sq, Sk) of a shape's S: one length, or the pair of a
    cross-attention."""
    return S if isinstance(S, tuple) else (S, S)


def flash_inputs(B, H, Hkv, S, D, padded, seed=0, device="cuda", Sk=None,
                 dtype=torch.bfloat16):
    """q, k, v, dO in ``dtype`` (bf16 unless given) with a per-row scale of
    q (so lse differs between rows) and a (B, Sk) key mask with the last
    keys of each row padded; Sk is S unless given."""
    Sk = S if Sk is None else Sk
    gen = torch.Generator(device=device).manual_seed(seed)
    scale = 0.5 + 1.5 * torch.rand(B, H, S, 1, generator=gen, device=device)
    q = (torch.randn(B, H, S, D, generator=gen, device=device) * scale)
    k = torch.randn(B, Hkv, Sk, D, generator=gen, device=device)
    v = torch.randn(B, Hkv, Sk, D, generator=gen, device=device)
    do = torch.randn(B, H, S, D, generator=gen, device=device)
    mask = torch.ones(B, Sk, dtype=torch.bool, device=device)
    if padded:
        lengths = torch.randint(Sk // 2, Sk + 1, (B,), generator=gen,
                                device=device)
        mask = torch.arange(Sk, device=device)[None] < lengths[:, None]
    return [x.to(dtype) for x in (q, k, v, do)] + [mask]


def flash_limits(q, k, v, kv_mask, lse, do, scale, causal, window, want,
                 bias=None):
    """Per-element limits on the kernels' (out, dq, dk, dv) for bf16 inputs,
    the plain version's float32 results ``want`` and its float32 ``lse``;
    ``bias`` (float32, broadcast to (B, H, Sq, Sk)) is added to the scores
    as the biased kernels add it."""
    from pasero_torch.ops.flash_attention import visible
    rtol, atol, K = FLASH_TOL
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    kg, vg = (x.repeat_interleave(group, 1) for x in (kf, vf))
    ok = visible(kv_mask, Sq, causal, window)
    s = torch.matmul(qf, kg.transpose(-1, -2)) * scale
    if bias is not None:
        s += bias
    p = torch.exp(s - lse[..., None]).masked_fill_(~ok, 0.0)
    delta = (dof * want[0].float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dof, vg.transpose(-1, -2)) - delta)
    noise = torch.matmul(dof.abs(), vg.abs().transpose(-1, -2))
    noise.add_((dof.abs() * want[0].float().abs()).sum(-1, keepdim=True))
    noise.mul_(p).mul_(2.0 ** -20 * scale)
    p2, ds2 = p.square_(), ds.square_().mul_(scale * scale)

    def kv_sum(x):
        return x.reshape(B, Hkv, group, Sk, D).sum(2)

    sums = [torch.matmul(p2, vg.square()),
            torch.matmul(ds2, kg.square()),
            kv_sum(torch.matmul(ds2.transpose(-1, -2), qf.square())),
            kv_sum(torch.matmul(p2.transpose(-1, -2), dof.square()))]
    limits = [rtol * w.float().abs() + atol + sq.sqrt_().mul_(K * U_BF16)
              for w, sq in zip(want, sums)]
    limits[1].add_(torch.matmul(noise, kg.abs()))
    limits[2].add_(kv_sum(torch.matmul(noise.transpose(-1, -2), qf.abs())))
    return limits


def flash_excess(got, want, limit, rows=None) -> float:
    """max |got - want| / limit over the rows that see a key: at most 1
    within the limits."""
    err = (got.float() - want.float()).abs() / limit
    err = torch.nan_to_num(err, nan=float("inf"))
    if rows is not None:
        err = err[rows]
    return err.max().item()


def flash_compare(shape, causal, window, padded) -> dict:
    """The kernels (forward, dq, dk/dv, one launch each) against the plain
    version on the same inputs at one shape. Rows that see no key (a window
    past the padding) are out of the comparison of out; their dO is zero,
    as in a model. Returns the lse error, each output's excess over its
    limit (out, dq, dk, dv), the largest excess of a backward given another
    row's lse, and the max abs errors of the forward (out, lse), dq and
    dk/dv."""
    from pasero_torch.ops.flash_attention import (flash_bwd, flash_bwd_dkv,
                                                  flash_bwd_dq, flash_bwd_plain,
                                                  flash_fwd, flash_fwd_plain,
                                                  visible)
    B, H, Hkv, S, D = shape
    Sq, Sk = flash_lengths(S)
    q, k, v, do, mask = flash_inputs(B, H, Hkv, Sq, D, padded, Sk=Sk)
    rows = visible(mask, Sq, causal, window).any(-1).expand(B, H, Sq)
    do = do * rows[..., None]
    scale = D ** -0.5
    out, lse = flash_fwd(q, k, v, mask, scale, causal, window)
    dq, delta = flash_bwd_dq(q, k, v, mask, out, lse, do, scale, causal,
                             window)
    grads = (dq,) + flash_bwd_dkv(q, k, v, mask, do, lse, delta, scale,
                                  causal, window)
    ref_out, ref_lse = flash_fwd_plain(q.float(), k.float(), v.float(), mask,
                                       scale, causal, window)
    ref = flash_bwd_plain(q.float(), k.float(), v.float(), mask, out, ref_lse,
                          do, scale, causal, window)
    torch.cuda.synchronize()
    lse_err = (lse - ref_lse)[rows].abs().max().item()
    limits = flash_limits(q, k, v, mask, ref_lse, do, scale, causal, window,
                          (ref_out,) + tuple(ref))
    excess = [flash_excess(out, ref_out, limits[0], rows)]
    excess += [flash_excess(g, w, lim)
               for g, w, lim in zip(grads, ref, limits[1:])]
    bad = flash_bwd(q, k, v, mask, out, lse.roll(1, -1), do, scale, causal,
                    window)
    bad_excess = max(flash_excess(g, w, lim)
                     for g, w, lim in zip(bad, ref, limits[1:]))

    def err(got, want, rows=None):
        diff = (got.float() - want.float()).abs()
        return (diff[rows] if rows is not None else diff).max().item()

    return {"lse_err": lse_err, "excess": excess, "bad_excess": bad_excess,
            "max_abs_err": {"fwd": max(lse_err, err(out, ref_out, rows)),
                            "dq": err(dq, ref[0]),
                            "dkv": max(err(grads[1], ref[1]),
                                       err(grads[2], ref[2]))}}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window,padded", FLASH_SHAPES)
def test_flash_kernels_match_plain(shape, causal, window, padded):
    """out, dq, dk, dv within ``flash_limits`` of the plain version on the
    same inputs, lse within 1e-4, one launch of each kernel; a backward
    given another row's lse exceeds the limits."""
    from pasero_torch.ops.flash_attention import (flash_bwd_dkv, flash_bwd_dq,
                                                  flash_fwd)
    _need_card()
    counts = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
    before = [fn.launches for fn in counts]
    result = flash_compare(shape, causal, window, padded)
    # one launch each for the comparison, one more of each backward kernel
    # for the backward given another row's lse
    assert [fn.launches for fn in counts] == \
        [before[0] + 1, before[1] + 2, before[2] + 2]
    assert result["lse_err"] <= 1e-4
    assert max(result["excess"]) <= 1.0, result["excess"]
    assert result["bad_excess"] > 1.0


def flash_same_bits(shape, causal, window, padded) -> bool:
    """Whether two calls of the backward (dq, then dk/dv) on the same inputs
    give the same bits."""
    from pasero_torch.ops.flash_attention import flash_bwd, flash_fwd
    B, H, Hkv, S, D = shape
    Sq, Sk = flash_lengths(S)
    q, k, v, do, mask = flash_inputs(B, H, Hkv, Sq, D, padded, Sk=Sk)
    args = (D ** -0.5, causal, window)
    out, lse = flash_fwd(q, k, v, mask, *args)
    first = flash_bwd(q, k, v, mask, out, lse, do, *args)
    second = flash_bwd(q, k, v, mask, out, lse, do, *args)
    return all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window,padded", FLASH_SHAPES)
def test_flash_backward_same_bits(shape, causal, window, padded):
    """dq, dk and dv are deterministic: no float atomics."""
    _need_card()
    assert flash_same_bits(shape, causal, window, padded)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["head_dim", "dtype", "mixed", "window"])
def test_flash_bad_input_raises_on_card(bad):
    """Head dims past 128 (flash_attention pads the others up to 32, 64 or
    128), types other than bfloat16 and float32, q, k and v of mixed types
    and a window that is not positive raise before any launch."""
    from pasero_torch.ops.flash_attention import (flash_attention, flash_fwd,
                                                  launch_counts)
    _need_card()
    D = 160 if bad == "head_dim" else 64
    dtype = torch.float16 if bad == "dtype" else torch.float32
    q = torch.zeros((1, 2, 8, D), device="cuda", dtype=dtype)
    kv = q.to(torch.bfloat16) if bad == "mixed" else q
    before = launch_counts()
    with pytest.raises((TypeError, ValueError)):
        flash_attention(q, kv, kv, causal=True,
                        window=0 if bad == "window" else None)
    assert launch_counts() == before
    assert flash_fwd.launches_f32 == before["flash_fwd_f32"]


ODD_HEAD_DIMS = [   # (B, H, Hkv, S, D), causal, padded, bias kind or None
    ((2, 4, 4, 200, 80), True, True, "alibi"),   # bloom_3b's head, ALiBi
    ((2, 4, 2, 130, 100), True, True, None),     # llama_3b's, GQA
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,padded,kind", ODD_HEAD_DIMS)
def test_flash_attention_pads_odd_head_dims(shape, causal, padded, kind):
    """flash_attention at a head dim the kernels do not take pads it to the
    next one (128 here) and slices the padding off: out, dq, dk and dv
    through its autograd within ``flash_limits`` (the bias added, as
    ``flash_bias_compare`` holds the biased kernels) of the plain version at
    the caller's D, with one launch each of the forward, dq and dk/dv
    kernels of the bias's kind and none of any other."""
    from pasero_torch.ops import flash_attention as fa
    _need_card()
    B, H, Hkv, S, D = shape
    q, k, v, do, mask = flash_inputs(B, H, Hkv, S, D, padded)
    bias = None if kind is None else flash_bias(kind, B, H, S, mask)
    rows = fa.visible(mask, S, causal, None).any(-1).expand(B, H, S)
    do = do * rows[..., None]
    scale = D ** -0.5
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = fa.launch_counts()
    out = fa.flash_attention(*leaves, mask=mask[:, None, None, :], bias=bias,
                             scale=scale, causal=causal)
    out.backward(do)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    end = "" if kind is None else "_bias"
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} \
        == {f"flash_fwd{end}": 1, f"flash_bwd_dq{end}": 1,
            f"flash_bwd_dkv{end}": 1}
    assert out.shape == q.shape and all(x.grad.shape == x.shape
                                        for x in leaves)
    f32 = [x.float() for x in (q, k, v)]
    args = (scale, causal, None, bias)
    ref_out, ref_lse = fa.flash_fwd_plain(*f32, mask, *args)
    ref = fa.flash_bwd_plain(*f32, mask, out.detach(), ref_lse, do, *args)
    limits = flash_limits(q, k, v, mask, ref_lse, do, scale, causal, None,
                          (ref_out,) + tuple(ref), bias)
    excess = [flash_excess(out, ref_out, limits[0], rows)]
    excess += [flash_excess(x.grad, w, lim)
               for x, w, lim in zip(leaves, ref, limits[1:])]
    assert max(excess) <= 1.0, excess


# The biased kernels (the forward, dq and dk/dv with a float32 bias; dbias)
# against the plain version's float32 results of the same bf16 inputs and
# float32 bias. out, dq, dk and dv within ``flash_limits`` with the bias added
# to the recomputed scores: the bias enters P exactly as the scores do, in
# float32 before the exponent, so the bf16 roundings of P and dS stay the
# only large errors. dbias is dS itself, unrounded float32: within
# DBIAS_RTOL |dS| + atol + the float32 noise of dP - delta per unit of P (the
# F term of ``flash_limits``, without the scale), each limit summed as the
# kernel sums dS (over the batch for b0 = 1, over the heads for h0 = 1).
# DBIAS_RTOL is a float32 one: a dS rounded to bfloat16 (2^-9 of it) lies
# outside it. The same limits reject a bias transposed (Sq <-> Sk), a bias
# row taken from another head, dbias computed without delta, dbias with dS
# rounded to bfloat16 before its sum, and a backward given another row's
# lse. The forward's own mutations (a transposed bias, the next key tile's
# bias, another head's bias rows, each read by out and by lse within
# LSE_ATOL, and a dq given the forward's lse in log2 units) lie at
# FWD_MUTANT_MIN or more of the limits.
DBIAS_RTOL = 1e-4
LSE_ATOL = 1e-4
FWD_MUTANT_MIN = 2.8
FWD_MUTANTS = ("transposed", "other_head", "next_key_tile", "lse_log2")
FLASH_BIAS_SHAPES = [   # (B, H, Hkv, S, D), causal, window, padded, bias kind
    ((2, 8, 8, 256, 64), True, None, False, "alibi"),
    ((2, 8, 2, 300, 64), True, 64, True, "learned_1xH"),   # GQA 4, a window
    ((2, 4, 2, 77, 64), False, None, True, "Bx1"),         # 4-byte bias rows
    ((3, 4, 2, 45, 32), True, None, True, "1x1"),
    ((2, 4, 4, 200, 128), False, None, True, "encoder"),   # rows of only -1e9
    # the forward's instances and paths: shared biases at D = 128, 4-byte
    # rows (cp.async) under a window, more work items than 132 SMs
    ((2, 4, 4, 200, 128), True, None, True, "1x1"),
    ((2, 8, 8, 256, 128), True, None, False, "learned_1xH"),
    ((1, 4, 2, 130, 64), True, 48, True, "learned_1xH"),
    ((4, 8, 8, 640, 64), True, None, False, "alibi"),      # 160 items
    # the model's ALiBi rows at a bucket's length, 143 keys padded to 144
    # floats (TMA where Sk % 4 != 0), under a window
    ((2, 8, 4, 143, 64), True, 32, True, "alibi"),
    # dbias: per-sample at D = 32 (130 keys: the cp.async path and plain
    # stores) and D = 128, a bias shared over four batches at bloom_560m's
    # width, and more output planes (12 x 12) than 132 SMs
    ((2, 4, 2, 130, 32), True, None, True, "alibi"),
    ((2, 4, 4, 200, 128), True, None, False, "alibi"),
    ((4, 16, 16, 2048, 64), True, None, False, "learned_1xH"),
    ((12, 12, 12, 128, 64), True, None, True, "alibi"),
]


def flash_bias(kind, B, H, S, kv_mask, device="cuda"):
    """A float32 bias of ``kind``: the causal ALiBi bias (B, H, S, S) of the
    key mask's positions with max_bias 8 ("alibi") or 16 ("alibi16"), the
    encoder's half-head one ("encoder"), or a seeded normal bias of (1, H),
    (B, 1) or (1, 1) ("learned_1xH", "Bx1", "1x1")."""
    from pasero_torch.models.positional import alibi_bias
    if kind in ("alibi", "alibi16", "encoder"):
        pos = (kv_mask.long().cumsum(1) - 1).clamp(min=0)
        return alibi_bias(H, pos, pos, 16 if kind == "alibi16" else 8,
                          causal=kind != "encoder")
    b0, h0 = {"learned_1xH": (1, H), "Bx1": (B, 1), "1x1": (1, 1)}[kind]
    gen = torch.Generator(device=device).manual_seed(1)
    return 2 * torch.randn(b0, h0, S, S, generator=gen, device=device)


def flash_dbias_limits(q, k, v, kv_mask, lse, do, out, scale, causal, window,
                       bias, want, rtol=DBIAS_RTOL):
    """Per-element limits on the dbias kernel's float32 result, given the
    plain version's float32 dbias ``want`` reduced to the bias's shape."""
    from pasero_torch.ops.flash_attention import _reduce_to, visible
    atol = FLASH_TOL[1]
    group = q.shape[1] // k.shape[1]
    qf, dof = q.float(), do.float()
    kg, vg = (x.float().repeat_interleave(group, 1) for x in (k, v))
    ok = visible(kv_mask, q.shape[2], causal, window)
    s = torch.matmul(qf, kg.transpose(-1, -2)).mul_(scale).add_(bias)
    p = torch.exp(s.sub_(lse[..., None])).masked_fill_(~ok, 0.0)
    del s
    dp = torch.matmul(dof, vg.transpose(-1, -2))
    delta = (dof * out.float()).sum(-1, keepdim=True)
    limit = (p * (dp - delta)).abs_().mul_(rtol).add_(atol)
    noise = torch.matmul(dof.abs(), vg.abs().transpose(-1, -2))
    noise.add_((dof.abs() * out.float().abs()).sum(-1, keepdim=True))
    limit.add_(noise.mul_(p).mul_(2.0 ** -20))
    return _reduce_to(limit, want.shape)


def flash_bias_compare(shape, causal, window, padded, kind) -> dict:
    """The biased kernels (forward, dq, dk/dv, dbias; one launch each)
    against the plain version on the same inputs at one shape, as
    ``flash_compare`` does, and the mutations the limits must reject, each
    one launch more: a forward of a transposed bias (where the bias is not
    symmetric), of a bias rolled by one head (where it has a row per head)
    and of the next key tile's bias (rolled by 64 keys), dbias without
    delta, dbias of the bias expanded to (B, H) with dS rounded to bfloat16
    before its sum to the bias's shape, a dq and dk/dv given another row's
    lse and a dq given the forward's lse in log2 units; then the forward,
    dq and dk/dv once more on the same inputs. Returns the lse error, the
    excess of out, dq, dk, dv and dbias over their limits, the excess of
    each mutation (a forward's over out's limits and LSE_ATOL, the larger),
    whether the second calls gave the same bits, and the max abs errors."""
    from pasero_torch.ops.flash_attention import (_reduce_to, flash_bwd,
                                                  flash_bwd_dbias,
                                                  flash_bwd_dkv, flash_bwd_dq,
                                                  flash_bwd_plain,
                                                  flash_dbias_plain, flash_fwd,
                                                  flash_fwd_plain, visible)
    B, H, Hkv, S, D = shape
    q, k, v, do, mask = flash_inputs(B, H, Hkv, S, D, padded)
    bias = flash_bias(kind, B, H, S, mask)
    rows = visible(mask, S, causal, window).any(-1).expand(B, H, S)
    do = do * rows[..., None]
    args = (D ** -0.5, causal, window)
    out, lse = flash_fwd(q, k, v, mask, *args, bias)
    dq, delta = flash_bwd_dq(q, k, v, mask, out, lse, do, *args, bias)
    dk, dv = flash_bwd_dkv(q, k, v, mask, do, lse, delta, *args, bias)
    dbias = flash_bwd_dbias(q, k, v, mask, bias, do, lse, delta, *args)
    f32 = [x.float() for x in (q, k, v)]
    ref_out, ref_lse = flash_fwd_plain(*f32, mask, *args, bias)
    ref = flash_bwd_plain(*f32, mask, out, ref_lse, do, *args, bias)
    ref_dbias = flash_dbias_plain(*f32, mask, out, ref_lse, do, *args, bias)
    torch.cuda.synchronize()
    lse_err = (lse - ref_lse)[rows].abs().max().item()
    limits = flash_limits(q, k, v, mask, ref_lse, do, *args,
                          (ref_out,) + tuple(ref), bias)
    dbias_limit = flash_dbias_limits(q, k, v, mask, ref_lse, do, out, *args,
                                     bias, ref_dbias)
    excess = [flash_excess(out, ref_out, limits[0], rows)]
    excess += [flash_excess(g, w, lim)
               for g, w, lim in zip((dq, dk, dv), ref, limits[1:])]
    excess.append(flash_excess(dbias, ref_dbias, dbias_limit))
    mutants = {"no_delta": flash_excess(flash_bwd_dbias(
        q, k, v, mask, bias, do, lse, torch.zeros_like(delta), *args),
        ref_dbias, dbias_limit)}
    ds = flash_bwd_dbias(q, k, v, mask, bias.expand(B, H, S, S), do, lse,
                         delta, *args)
    mutants["dbias_bf16"] = flash_excess(_reduce_to(
        ds.to(torch.bfloat16).float(), bias.shape), ref_dbias, dbias_limit)
    del ds
    bad_lse = lse.roll(1, -1)
    bad_dq, bad_delta = flash_bwd_dq(q, k, v, mask, out, bad_lse, do, *args,
                                     bias)
    bad = (bad_dq,) + flash_bwd_dkv(q, k, v, mask, do, bad_lse, bad_delta,
                                    *args, bias)
    mutants["other_lse"] = max(flash_excess(g, w, lim)
                               for g, w, lim in zip(bad, ref, limits[1:]))

    def fwd_excess(bad_bias):
        got, got_lse = flash_fwd(q, k, v, mask, *args, bad_bias)
        return max(flash_excess(got, ref_out, limits[0], rows),
                   (got_lse - ref_lse)[rows].abs().max().item() / LSE_ATOL)

    if kind not in ("alibi", "alibi16"):     # ALiBi's causal bias: symmetric
        mutants["transposed"] = fwd_excess(bias.transpose(-1, -2))
    if bias.shape[1] > 1:
        mutants["other_head"] = fwd_excess(bias.roll(1, 1))
    mutants["next_key_tile"] = fwd_excess(bias.roll(-64, -1))
    log2_dq, _ = flash_bwd_dq(q, k, v, mask, out, lse * math.log2(math.e),
                              do, *args, bias)
    mutants["lse_log2"] = flash_excess(log2_dq, ref[0], limits[1])
    out2, lse2 = flash_fwd(q, k, v, mask, *args, bias)
    again = flash_bwd(q, k, v, mask, out, lse, do, *args, bias)
    again += (flash_bwd_dbias(q, k, v, mask, bias, do, lse, delta, *args),)
    same_bits = torch.equal(out, out2) and torch.equal(lse, lse2) and all(
        torch.equal(a, b) for a, b in zip((dq, dk, dv, dbias), again))

    def err(got, want, rows=None):
        diff = (got.float() - want.float()).abs()
        return (diff[rows] if rows is not None else diff).max().item()

    return {"lse_err": lse_err, "excess": excess, "mutants": mutants,
            "same_bits": same_bits,
            "max_abs_err": {"fwd": max(lse_err, err(out, ref_out, rows)),
                            "dq": err(dq, ref[0]),
                            "dkv": max(err(dk, ref[1]), err(dv, ref[2])),
                            "dbias": err(dbias, ref_dbias)}}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window,padded,kind", FLASH_BIAS_SHAPES)
def test_biased_flash_kernels_match_plain(shape, causal, window, padded,
                                          kind):
    """out, dq, dk, dv and dbias within their limits, lse within LSE_ATOL;
    each mutation outside them, the forward's at FWD_MUTANT_MIN or more;
    the forward, dq, dk, dv and dbias the same bits twice."""
    from pasero_torch.ops.flash_attention import launch_counts
    _need_card()
    names = ("flash_fwd_bias", "flash_bwd_dq_bias", "flash_bwd_dkv_bias",
             "flash_bwd_dbias")
    before = launch_counts()
    result = flash_bias_compare(shape, causal, window, padded, kind)
    after = launch_counts()
    mutants = result["mutants"]
    forwards = [name for name in FWD_MUTANTS[:-1] if name in mutants]
    assert [after[n] - before[n] for n in names] == \
        [2 + len(forwards), 4, 3, 4]
    assert result["lse_err"] <= LSE_ATOL
    assert max(result["excess"]) <= 1.0, result["excess"]
    assert min(mutants.values()) > 1.0, mutants
    assert min(mutants[n] for n in FWD_MUTANTS if n in mutants) >= \
        FWD_MUTANT_MIN, mutants
    assert result["same_bits"]


@pytest.mark.cuda
def test_learned_bias_gradient_launches_dbias_and_alibi_does_not():
    """Through flash_attention's autograd: a bias that requires a gradient
    launches the dbias kernel once per backward; a constant (ALiBi) bias
    none, and the bias-free kernels never run."""
    from pasero_torch.ops import flash_attention as fa
    _need_card()
    q, k, v, do, mask = flash_inputs(2, 8, 2, 128, 64, True)
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_bias",
             "flash_bwd_dq_bias", "flash_bwd_dkv_bias", "flash_bwd_dbias")
    for learned, want in ((True, [0, 0, 0, 1, 1, 1, 1]),
                          (False, [0, 0, 0, 1, 1, 1, 0])):
        bias = flash_bias("learned_1xH" if learned else "alibi", 2, 8, 128,
                          mask).requires_grad_(learned)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        before = fa.launch_counts()
        out = fa.flash_attention(*leaves, mask=mask[:, None, None, :],
                                 bias=bias, scale=0.125, causal=True)
        out.backward(do)
        torch.cuda.synchronize()
        after = fa.launch_counts()
        assert [after[n] - before[n] for n in names] == want
        assert (bias.grad is not None) == learned
        if learned:
            assert bias.grad.shape == bias.shape and \
                bias.grad.dtype == torch.float32


@pytest.mark.cuda
def test_biased_flash_wrappers_raise_on_card():
    """A bias of another shape or on another device raises before any
    launch."""
    from pasero_torch.ops.flash_attention import flash_fwd
    _need_card()
    q = torch.zeros((2, 4, 8, 64), device="cuda", dtype=torch.bfloat16)
    mask = torch.ones((2, 8), dtype=torch.bool, device="cuda")
    before = flash_fwd.bias_launches
    for bias in (torch.zeros((3, 4, 8, 8), device="cuda"),
                 torch.zeros((2, 4, 8, 7), device="cuda"),
                 torch.zeros((1, 4, 8, 8))):
        with pytest.raises(ValueError):
            flash_fwd(q, q, q, mask, 0.125, True, None, bias)
    assert flash_fwd.bias_launches == before


# The T5 kernels (the forward, dq and dk/dv with T5's table; demb, which the
# T5 dq kernel sums from its own float32 dS) against the plain version's
# float32 results of the same bf16 inputs and float32 table. out, dq, dk and
# dv within ``flash_limits`` with the table's bias
# materialized from slot indices and added to the recomputed scores, as a
# dense bias is. demb sums dS over every (batch, query, key) of a bucket, up
# to 10^6 elements and more, so its limit is a sum too: per (bucket, head),
# the root sum of squares of the dbias element limits e = DBIAS_RTOL |dS| +
# atol + F (``flash_dbias_limits``; the kernel's float32 errors of dS are
# independent roundings) plus DEMB_SUM_RTOL sum |dS| (the float32 roundings
# of the sums themselves and any error common to the elements) plus atol (a
# bucket no element reaches). A dS rounded
# to bfloat16 errs by up to 2^-9 of each element, 2^-9 / sqrt(3) in the root
# sum of squares, beyond both terms while a bucket holds fewer than about
# 10^6 elements; the plain version sums in float64. The same limits reject
# the direction flipped, another head's column, the distances shifted by
# one, demb without delta, demb of dS rounded to bfloat16 (the dbias kernel
# on the materialized bias gives that dS) and a backward given another row's
# lse. With JAX's buckets every visible key of a causal row of a
# unidirectional table lies in bucket 0 (the bias is one constant per row
# and head, ROADMAP.md C.10), so another head's column cannot show there.
DEMB_SUM_RTOL = 2.0 ** -20
FLASH_T5_SHAPES = [  # (B, H, Hkv, S, D), causal, window, padded, bidirectional
    ((2, 4, 4, 256, 64), False, None, True, True),      # an encoder
    ((2, 4, 4, 200, 64), True, None, False, False),     # a decoder
    ((2, 8, 2, 300, 128), True, 64, True, True),        # GQA 4, a window
    ((3, 4, 2, 77, 32), False, None, True, False),      # unaligned
]
# demb in the dq kernel: every tile near (S <= 128), and tiles whose
# distances all fall in one bucket (S >= 1024), at head dims 32, 64 and 128
FLASH_T5_DEMB_SHAPES = [
    ((2, 4, 4, 128, 32), True, None, True, False),      # near only, causal
    ((2, 4, 2, 100, 128), False, None, True, True),     # near only, padded
    ((1, 4, 4, 1100, 64), False, None, True, True),     # far tiles, padded
    ((1, 4, 2, 1030, 128), True, 200, False, False),    # far tiles, a window
    ((1, 2, 2, 1024, 32), False, None, False, False),   # far tiles
    # the t5_mini CLI's decoder and encoder (one work item a block; Sq <=
    # 64, so one consumer of each item has no rows) and t5_base's encoder
    ((32, 4, 4, 16, 32), True, None, True, False),
    ((32, 4, 4, 21, 32), False, None, True, True),
    ((32, 12, 12, 512, 64), False, None, True, True),
]


def t5_table(H, num_buckets=32, device="cuda"):
    """A seeded float32 (num_buckets, H) table."""
    gen = torch.Generator(device=device).manual_seed(2)
    return 0.5 * torch.randn(num_buckets, H, generator=gen, device=device)


def shifted_t5(t5):
    """``t5`` whose distance index is read one entry off (a mutation)."""
    from pasero_torch.ops.flash_attention import T5Bias

    class Shifted(T5Bias):
        def index(self, Sq, Sk):
            return super().index(Sq, Sk).roll(-1)

    return Shifted(t5.table, t5.bidirectional, t5.num_buckets,
                   t5.max_distance)


def flash_demb_limits(q, k, v, kv_mask, lse, do, out, scale, causal, window,
                      t5, rtol=DBIAS_RTOL):
    """Per-(bucket, head) limits (num_buckets, H) on the kernels' demb
    result, with the plain version's float32 ``lse``."""
    from pasero_torch.ops.flash_attention import visible
    atol = FLASH_TOL[1]
    B, H, Sq = q.shape[:3]
    Sk = k.shape[2]
    group = H // k.shape[1]
    dof, of = do.float(), out.float()
    kg, vg = (x.float().repeat_interleave(group, 1) for x in (k, v))
    ok = visible(kv_mask, Sq, causal, window)
    p = torch.matmul(q.float(), kg.transpose(-1, -2)).mul_(scale)
    p.add_(t5.materialize(Sq, Sk)).sub_(lse[..., None]).exp_()
    p.masked_fill_(~ok, 0.0)
    ds = torch.matmul(dof, vg.transpose(-1, -2))
    ds.sub_((dof * of).sum(-1, keepdim=True)).mul_(p).abs_()
    e = torch.matmul(dof.abs(), vg.abs().transpose(-1, -2))
    e.add_((dof.abs() * of.abs()).sum(-1, keepdim=True))
    e.mul_(p).mul_(2.0 ** -20).add_(ds, alpha=rtol).add_(atol).square_()
    del p
    buckets = t5.buckets(Sq, Sk).reshape(-1)

    def by_bucket(x):
        out = torch.zeros((H, t5.num_buckets), dtype=torch.float64,
                          device=x.device)
        for h in range(H):   # one head at a time: no float64 (B, H, Sq, Sk)
            out[h].index_add_(0, buckets, x[:, h].double().sum(0).reshape(-1))
        return out

    limit = by_bucket(e).sqrt_() + DEMB_SUM_RTOL * by_bucket(ds) + atol
    return limit.t().float()


def flash_t5_compare(shape, causal, window, padded, bidirectional) -> dict:
    """The T5 kernels (forward, dq with demb, dk/dv; one launch each) against
    the plain version on the same inputs at one shape, as ``flash_compare``
    does, and the mutations the limits must reject (see above); then dq
    (with demb, and without it) and dk/dv once more on the same inputs.
    Returns the lse error, the excess of out, dq, dk, dv and demb over their
    limits, the smallest excess of each mutation, whether the second
    backward gave the same bits (demb too, and the dq without demb the same
    as the dq with it), and the max abs errors."""
    from pasero_torch.ops.flash_attention import (T5Bias, flash_bwd,
                                                  flash_bwd_dbias,
                                                  flash_bwd_dkv, flash_bwd_dq,
                                                  flash_bwd_plain,
                                                  flash_demb_plain, flash_fwd,
                                                  flash_fwd_plain, visible)
    B, H, Hkv, S, D = shape
    q, k, v, do, mask = flash_inputs(B, H, Hkv, S, D, padded)
    t5 = T5Bias(t5_table(H), bidirectional)
    rows = visible(mask, S, causal, window).any(-1).expand(B, H, S)
    do = do * rows[..., None]
    args = (D ** -0.5, causal, window)
    out, lse = flash_fwd(q, k, v, mask, *args, t5)
    dq, delta, demb = flash_bwd_dq(q, k, v, mask, out, lse, do, *args, t5,
                                   table_grad=True)
    dk, dv = flash_bwd_dkv(q, k, v, mask, do, lse, delta, *args, t5)
    f32 = [x.float() for x in (q, k, v)]
    ref_out, ref_lse = flash_fwd_plain(*f32, mask, *args, t5)
    ref = flash_bwd_plain(*f32, mask, out, ref_lse, do, *args, t5)
    ref_demb = flash_demb_plain(*f32, mask, out, ref_lse, do, *args, t5)
    torch.cuda.synchronize()
    lse_err = (lse - ref_lse)[rows].abs().max().item()
    limits = flash_limits(q, k, v, mask, ref_lse, do, *args,
                          (ref_out,) + tuple(ref), t5.materialize(S, S))
    demb_limit = flash_demb_limits(q, k, v, mask, ref_lse, do, out, *args, t5)
    excess = [flash_excess(out, ref_out, limits[0], rows)]
    excess += [flash_excess(g, w, lim)
               for g, w, lim in zip((dq, dk, dv), ref, limits[1:])]
    excess.append(flash_excess(demb, ref_demb, demb_limit))
    # demb without delta: the dq kernel computes delta from out, so a zero
    # out gives it none
    mutants = {"no_delta": flash_excess(flash_bwd_dq(
        q, k, v, mask, torch.zeros_like(out), lse, do, *args, t5,
        table_grad=True)[2], ref_demb, demb_limit)}
    ds = flash_bwd_dbias(q, k, v, mask, t5.materialize(S, S).expand(
        B, H, S, S), do, lse, delta, *args)
    ds_demb = torch.zeros((H, t5.num_buckets), dtype=torch.float64,
                          device=ds.device)
    ds_demb.index_add_(1, t5.buckets(S, S).reshape(-1), ds.to(
        torch.bfloat16).double().sum(0).reshape(H, S * S))
    del ds
    mutants["demb_bf16"] = flash_excess(ds_demb.t().float(), ref_demb,
                                        demb_limit)
    bad_lse = lse.roll(1, -1)
    bad_dq, bad_delta = flash_bwd_dq(q, k, v, mask, out, bad_lse, do, *args,
                                     t5)
    bad = (bad_dq,) + flash_bwd_dkv(q, k, v, mask, do, bad_lse, bad_delta,
                                    *args, t5)
    mutants["other_lse"] = max(flash_excess(g, w, lim)
                               for g, w, lim in zip(bad, ref, limits[1:]))
    fwd_mutants = {"direction": T5Bias(t5.table, not bidirectional),
                   "shifted": shifted_t5(t5)}
    if H > 1 and (bidirectional or not causal):
        fwd_mutants["other_head"] = T5Bias(t5.table.roll(1, 1),
                                           bidirectional)
    for name, bad_t5 in fwd_mutants.items():
        mutants[name] = flash_excess(flash_fwd(q, k, v, mask, *args,
                                               bad_t5)[0], ref_out,
                                     limits[0], rows)
    again = flash_bwd(q, k, v, mask, out, lse, do, *args, t5)
    dq2, _, demb2 = flash_bwd_dq(q, k, v, mask, out, lse, do, *args, t5,
                                 table_grad=True)
    same_bits = all(torch.equal(a, b) for a, b in zip(
        (dq, dq, dk, dv, demb), again[:1] + (dq2,) + again[1:] + (demb2,)))

    def err(got, want, rows=None):
        diff = (got.float() - want.float()).abs()
        return (diff[rows] if rows is not None else diff).max().item()

    return {"lse_err": lse_err, "excess": excess, "mutants": mutants,
            "same_bits": same_bits,
            "max_abs_err": {"fwd": max(lse_err, err(out, ref_out, rows)),
                            "dq": err(dq, ref[0]),
                            "dkv": max(err(dk, ref[1]), err(dv, ref[2])),
                            "demb": err(demb, ref_demb)}}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window,padded,bidirectional",
                         FLASH_T5_SHAPES + FLASH_T5_DEMB_SHAPES)
def test_t5_flash_kernels_match_plain(shape, causal, window, padded,
                                      bidirectional):
    """out, dq, dk, dv and demb within their limits, lse within 1e-4; each
    mutation outside them; dq, dk and dv the same bits twice."""
    from pasero_torch.ops.flash_attention import launch_counts
    _need_card()
    names = ("flash_fwd_t5", "flash_bwd_dq_t5", "flash_bwd_dkv_t5",
             "flash_bwd_dq_t5_demb", "flash_bwd_demb", "flash_bwd_dbias")
    before = launch_counts()
    result = flash_t5_compare(shape, causal, window, padded, bidirectional)
    after = launch_counts()
    mutants = result["mutants"]
    fwd_mutants = 2 + ("other_head" in mutants)
    assert [after[n] - before[n] for n in names] == \
        [1 + fwd_mutants, 5, 3, 3, 0, 1]
    assert result["lse_err"] <= 1e-4
    assert max(result["excess"]) <= 1.0, result["excess"]
    assert min(mutants.values()) > 1.0, mutants
    assert result["same_bits"]


# Guard bands: each output of a kernel launched straight through its C entry
# point lies inside a buffer GUARD elements longer on each side, filled with
# CANARY, so a store past the output's own elements shows as a canary hit.
GUARD = 1 << 16
CANARY = -1536.0   # exact in bfloat16 and float32


def guarded(shape, dtype, bufs: dict, name: str):
    """A tensor of ``shape`` inside a canary-filled buffer, kept in ``bufs``
    under ``name``; the tensor starts filled with CANARY too."""
    n = math.prod(shape)
    buf = torch.full((n + 2 * GUARD,), CANARY, dtype=dtype, device="cuda")
    bufs[name] = buf
    return buf[GUARD:GUARD + n].view(shape)


def canaries_hit(bufs: dict) -> dict:
    """Per buffer, the guard elements that no longer hold CANARY."""
    return {name: int((buf[:GUARD] != CANARY).sum() +
                      (buf[-GUARD:] != CANARY).sum())
            for name, buf in bufs.items()}


def t5_guard_band(shape, causal, padded, bidirectional, poison=None,
                  iters=1) -> dict:
    """The bf16 T5 forward, dq with demb and dk/dv at one self-attention
    shape through the C entry points, every output guarded (``guarded``);
    dq with demb ``iters`` times, each time right after a dq with demb at
    ``poison``'s shape (B, H, Sq, Sk) where one is given: that launch leaves
    its own facts in the shared memory of every SM (with T5_POISON each
    tile an item's last, of 128 rows), which the next launch's blocks
    inherit. Returns the canaries hit after all launches and how
    many of the dq launches gave other bits than the first (dq, delta and
    the partial rows of demb)."""
    from pasero_torch.ops import flash_attention as fa
    B, H, Hkv, S, D = shape
    q, k, v, do, mask = flash_inputs(B, H, Hkv, S, D, padded)
    t5 = fa.T5Bias(t5_table(H), bidirectional)
    qc, kc, vc, m, dims = fa._cuda_args(q, k, v, mask, None)
    ops = fa._bias_args(t5, qc, dims)
    scalars = fa._scalars(dims, D ** -0.5, causal, None)
    lib, dev = fa._bwd_library(), q.device
    bufs = {}
    out = guarded(q.shape, torch.bfloat16, bufs, "out")
    lse = guarded((B, H, S), torch.float32, bufs, "lse")
    fa._launch("fwd", dev, qc, kc, vc, m, *ops, out, lse, *scalars, lib=lib)
    dq = guarded(q.shape, torch.bfloat16, bufs, "dq")
    delta = guarded((B, H, S), torch.float32, bufs, "delta")
    partial = guarded((B, H, -(-S // 64), t5.num_buckets), torch.float32,
                      bufs, "partial")
    plan = t5.far_tiles(S, S)
    if poison is not None:
        PB, PH, PSq, PSk = poison
        pq, pk, pv, pdo, pmask = flash_inputs(PB, PH, PH, PSq, D, True,
                                              seed=1, Sk=PSk)
        pt5 = fa.T5Bias(t5_table(PH), bidirectional)
        pout, plse = fa.flash_fwd(pq, pk, pv, pmask, D ** -0.5, causal, None,
                                  pt5)
    first, differ = None, 0
    for _ in range(iters):
        if poison is not None:
            fa.flash_bwd_dq(pq, pk, pv, pmask, pout, plse, pdo, D ** -0.5,
                            causal, None, pt5, table_grad=True)
        fa._launch("bwd_dq", dev, qc, kc, vc, m, *ops, out, do, lse, delta,
                   dq, partial, *plan, *scalars, lib=lib)
        now = [x.clone() for x in (dq, delta, partial)]
        if first is None:
            first = now
        else:
            differ += not all(torch.equal(a, b) for a, b in zip(first, now))
    dk = guarded(k.shape, torch.bfloat16, bufs, "dk")
    dv = guarded(v.shape, torch.bfloat16, bufs, "dv")
    fa._launch("bwd_dkv", dev, qc, kc, vc, m, *ops, do, lse, delta, dk, dv,
               *scalars, lib=lib)
    torch.cuda.synchronize()
    return {"hit": canaries_hit(bufs), "differ": differ}


# A dq with demb whose every work item (128 query rows, 64 keys) is one
# tile: each stage's facts in shared memory say "an item's last tile, two
# consumers with rows", a row far past a small launch's partial rows
T5_POISON = (64, 4, 128, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,padded,bidirectional", [
    ((32, 4, 4, 16, 32), True, True, False),     # the t5_mini CLI's decoder
    ((32, 4, 4, 21, 32), False, True, True),     # and encoder: an item a block
    ((2, 4, 4, 100, 128), True, True, False),    # D = 128: an item a block
    ((32, 12, 12, 512, 64), False, True, True),  # t5_base's encoder
])
def test_t5_kernels_store_inside_their_outputs(shape, causal, padded,
                                               bidirectional):
    """No T5 kernel stores outside its outputs (forward: out, lse; dq: dq,
    delta, demb's partial rows; dk/dv), at one work item a block and at the
    persistent grid. Each dq launch follows a dq with demb at a shape of
    more rows, whose facts its blocks inherit in shared memory; every dq
    launch gives the same bits (every partial row written)."""
    _need_card()
    poison = (T5_POISON[0], shape[1]) + T5_POISON[2:]
    result = t5_guard_band(shape, causal, padded, bidirectional,
                           poison=poison, iters=20)
    assert not any(result["hit"].values()), result["hit"]
    assert result["differ"] == 0


def dbias_guard_band(shape, causal, padded, kind) -> dict:
    """The bf16 dbias kernel at one shape through its C entry point, its
    output guarded (``guarded``). Returns the canaries hit, the elements of
    the output it left unwritten (still CANARY) and whether its result,
    reduced to the bias's shape, has the bits of ``flash_bwd_dbias``'s."""
    from pasero_torch.ops import flash_attention as fa
    B, H, Hkv, S, D = shape
    q, k, v, do, mask = flash_inputs(B, H, Hkv, S, D, padded)
    bias = flash_bias(kind, B, H, S, mask)
    args = (D ** -0.5, causal, None)
    out, lse = fa.flash_fwd(q, k, v, mask, *args, bias)
    _, delta = fa.flash_bwd_dq(q, k, v, mask, out, lse, do, *args, bias)
    qc, kc, vc, m, dims = fa._cuda_args(q, k, v, mask, None)
    rows, bs, hs = fa._bias_args(bias.contiguous(), qc, dims)[:3]
    bufs = {}
    dbias = guarded((bias.shape[0], H, S, S), torch.float32, bufs, "dbias")
    fa._launch("bwd_dbias", q.device, qc, kc, vc, m, rows, bs, hs, do, lse,
               delta, dbias, *fa._scalars(dims, *args), lib=fa._bwd_library())
    want = fa.flash_bwd_dbias(q, k, v, mask, bias, do, lse, delta, *args)
    torch.cuda.synchronize()
    return {"hit": canaries_hit(bufs),
            "unwritten": int((dbias == CANARY).sum()),
            "same_bits": torch.equal(fa._reduce_to(dbias, bias.shape), want)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,padded,kind", [
    ((2, 4, 4, 200, 64), True, False, "alibi"),        # TMA, per sample
    ((2, 4, 2, 130, 32), True, True, "alibi"),         # cp.async, per sample
    ((4, 4, 4, 200, 128), True, True, "learned_1xH"),  # summed over 4 batches
    ((3, 4, 2, 45, 32), False, True, "1x1"),           # summed, cp.async
])
def test_dbias_stores_inside_its_output(shape, causal, padded, kind):
    """The bf16 dbias kernel writes every element of its output and nothing
    around it, and gives flash_bwd_dbias's bits."""
    _need_card()
    result = dbias_guard_band(shape, causal, padded, kind)
    assert not any(result["hit"].values()), result["hit"]
    assert result["unwritten"] == 0
    assert result["same_bits"]


@pytest.mark.cuda
def test_t5_table_gradient_through_flash_attention():
    """Through flash_attention's autograd: a T5 table that requires a
    gradient launches the three T5 kernels once each, the dq kernel as its
    instance that sums the table's gradient (``flash_bwd_dq_t5_demb``), and
    nothing else; the gradient is (num_buckets, H)
    float32, the same bits twice."""
    from pasero_torch.ops import flash_attention as fa
    _need_card()
    q, k, v, do, mask = flash_inputs(2, 8, 2, 128, 64, True)
    grads = []
    for _ in range(2):
        table = t5_table(8).requires_grad_()
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        fa.reset_launch_counts()
        out = fa.flash_attention(*leaves, mask=mask[:, None, None, :],
                                 scale=0.125, t5_bias=fa.T5Bias(table, True))
        out.backward(do)
        torch.cuda.synchronize()
        counts = fa.launch_counts()
        want = {n: int(n.endswith(("_t5", "_t5_demb"))) for n in counts}
        assert counts == want, counts
        assert table.grad.shape == (32, 8) and \
            table.grad.dtype == torch.float32
        grads.append(table.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
def test_t5_flash_wrappers_raise_on_card():
    """A table of another shape or device, or a T5 table with a bias,
    raises before any launch."""
    from pasero_torch.ops.flash_attention import (T5Bias, flash_attention,
                                                  flash_fwd)
    _need_card()
    q = torch.zeros((2, 4, 8, 64), device="cuda", dtype=torch.bfloat16)
    mask = torch.ones((2, 8), dtype=torch.bool, device="cuda")
    before = flash_fwd.t5_launches
    for table in (torch.zeros((32, 3), device="cuda"), torch.zeros((32, 4))):
        with pytest.raises(ValueError):
            flash_fwd(q, q, q, mask, 0.125, True, None, T5Bias(table))
    with pytest.raises(ValueError):
        flash_attention(q, q, q, bias=torch.zeros((1, 4, 8, 8),
                                                  device="cuda"),
                        t5_bias=T5Bias(torch.zeros((32, 4), device="cuda")))
    assert flash_fwd.t5_launches == before


# The float32 kernels (csrc/flash_f32.cu: the forward, dq with T5's demb,
# dk/dv and dbias of every bias kind) against the plain version's float32 results of the
# same float32 inputs. Both sides compute every product and sum in float32
# (no operand or P or dS is rounded to a shorter type), so they differ by
# float32 roundings of u = 2^-24 only, in a limit per element of the bf16
# model's form: an output is a sum of terms a_i = c_i m_i (P v for out, P dO
# for dv, scale dS k for dq, scale dS q for dk), and
#
#   |got - want| <= atol + K u (sqrt(sum_i (a_i e_i)^2) + 2 sqrt(n) S + sqrt(n) |want|)
#
# where S = sqrt(sum_i a_i^2) and n is the row's length (the visible keys of
# a query row for out and dq, the visible (query, head) pairs of a key row
# for dk and dv): the sums' own roundings, a random walk of n steps of at
# most u times a partial sum, and for out the row sum l's. e_i is the
# relative error of the coefficient c_i in units of u. For P = exp(s - lse):
# the score's dot product over D (sqrt(D) times the root sum of squares of
# its terms, scale q_d k_d), the roundings of s and of the bias added to it
# and of lse (|s| + |lse|) and the exponential's own (4); for dS = P (dP -
# delta) that times |dS|, plus P times the dot products' errors of dP and
# delta (sqrt(D) times their roots of sums of squares) and the rounding of
# the difference (|dP| + |delta|), which is all of dS where a row sees one
# key (dP and delta are then one number summed in two orders). K = 4. A
# TF32 product (operands rounded to 10 mantissa bits, 2^-11) errs by 2^13 u
# per operand, far outside; so do the kernels given another row's lse, a
# transposed bias, another head's T5 column or shifted distances. dbias and
# demb keep the limits of ``flash_dbias_limits`` and ``flash_demb_limits``
# (float32 ones already), which reject dS rounded to bfloat16.
U_F32 = 2.0 ** -24
F32_K = 4.0
F32_ATOL = 1e-7
F32_LSE_ATOL = 1e-5
FLASH_F32_CASES = [   # (B, H, Hkv, S, D), causal, window, padded, bias kind
    ((2, 8, 2, 2048, 64), True, None, False, None),      # llama-like GQA
    ((2, 4, 4, 200, 128), True, 48, True, None),         # ragged, a window
    ((1, 6, 3, 77, 64), False, None, True, None),        # Sk % 4 != 0
    ((2, 8, 8, 256, 64), True, None, False, "alibi"),    # per-sample ALiBi
    ((2, 8, 2, 300, 64), True, 64, True, "learned_1xH"),  # with dbias
    ((2, 4, 4, 256, 64), False, None, True, "t5"),       # bidirectional, demb
    ((2, 4, 2, 200, 64), True, None, False, "t5_causal"),
    ((1, 8, 1, 160, 64), True, None, True, None),        # a cluster of 8
    ((2, 12, 2, 150, 64), False, None, True, "t5"),      # a cluster of 6
    ((8, 12, 12, 512, 64), False, None, False, "t5"),    # t5_base's width
    # dbias: a per-sample (B, 1) and a (1, 1) bias; a shared bias summed
    # over four batches; a shared bias at full width, each block holding
    # more than one key tile
    ((2, 4, 2, 77, 64), False, None, True, "Bx1"),
    ((3, 4, 2, 45, 32), True, None, True, "1x1"),
    ((4, 4, 2, 200, 64), True, None, True, "learned_1xH"),
    ((2, 8, 8, 2048, 64), True, None, False, "learned_1xH"),
] + [((2, 4, 2, 130, D), kind != "t5", None, True, kind)   # every D, kind
     for kind in (None, "learned_1xH", "t5") for D in (32, 128)]


def flash_f32_limits(q, k, v, kv_mask, lse, do, out, scale, causal, window,
                     want, bias=None):
    """Per-element limits (out, dq, dk, dv) on the float32 kernels, given
    float32 inputs, the plain version's results ``want``, its ``lse``, and
    the forward's ``out`` (the backward's delta comes from it on both
    sides); ``bias`` (float32, broadcast to (B, H, Sq, Sk)) as in
    ``flash_limits``."""
    from pasero_torch.ops.flash_attention import visible
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    kg, vg = (x.repeat_interleave(group, 1) for x in (k, v))
    ok = visible(kv_mask, Sq, causal, window)
    s = torch.matmul(q, kg.transpose(-1, -2)).mul_(scale)
    if bias is not None:
        s.add_(bias)
    p = torch.exp(s - lse[..., None]).masked_fill_(~ok, 0.0)
    e = torch.matmul(q.square(), kg.square().transpose(-1, -2)).sqrt_()
    e.mul_(scale * D ** 0.5).add_(s.abs_()).add_(lse.abs()[..., None] + 4)
    del s
    dp = torch.matmul(do, vg.transpose(-1, -2))
    delta = (do * out).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    eds = torch.matmul(do.square(), vg.square().transpose(-1, -2)).sqrt_()
    eds.add_((do * out).square().sum(-1, keepdim=True).sqrt_())
    eds.mul_(D ** 0.5).add_(dp.abs_()).add_(delta.abs()).mul_(p)
    del dp
    eds.add_(ds.abs() * e)
    pe = p * e
    del e
    n_q = ok.expand(B, H, Sq, Sk).sum(-1, keepdim=True).float()   # per query
    n_k = ok.expand(B, H, Sq, Sk).float().sum(-2)[..., None]      # per key
    n_k = n_k.reshape(B, Hkv, group, Sk, 1).sum(2)

    def kv_sum(x):
        return x.reshape(B, Hkv, group, Sk, D).sum(2)

    terms = [torch.matmul(pe.square(), vg.square()),
             torch.matmul(eds.square(), kg.square()).mul_(scale ** 2),
             kv_sum(torch.matmul(eds.square().transpose(-1, -2), q.square()))
             .mul_(scale ** 2),
             kv_sum(torch.matmul(pe.square().transpose(-1, -2), do.square()))]
    rss = [torch.matmul(p.square(), vg.square()),
           torch.matmul(ds.square(), kg.square()).mul_(scale ** 2),
           kv_sum(torch.matmul(ds.square().transpose(-1, -2), q.square()))
           .mul_(scale ** 2),
           kv_sum(torch.matmul(p.square().transpose(-1, -2), do.square()))]
    lengths = [n_q, n_q, n_k, n_k]
    limits = []
    for t, r, n, w in zip(terms, rss, lengths, want):
        lim = t.sqrt_().add_(r.sqrt_().mul_(2 * n.sqrt()))
        lim.add_(w.abs() * n.sqrt())
        limits.append(lim.mul_(F32_K * U_F32).add_(F32_ATOL))
    return limits


def flash_f32_compare(shape, causal, window, padded, kind) -> dict:
    """The float32 kernels (forward, dq with T5's demb, dk/dv, and dbias with
    a dense bias; one launch each) against the plain version on the same
    float32 inputs at one shape, as ``flash_compare`` does, and the
    mutations the limits must reject: the kernels on q, k and v rounded to
    TF32 (a TF32 product), a backward given another row's lse, and with a
    bias those of ``flash_bias_compare`` and ``flash_t5_compare`` (dbias
    without delta, given another row's lse and on TF32-rounded q, k and v
    too); then the forward, dq (with demb), dk/dv and dbias once more on
    the same inputs. Returns the lse error, the excess of out, dq, dk, dv
    (and dbias or demb) over their limits, the smallest excess of each
    mutation, whether the second calls gave the same bits (out, demb and
    dbias too), and the max abs errors."""
    from pasero_torch.ops.flash_attention import (T5Bias, _reduce_to,
                                                  flash_bwd_dbias,
                                                  flash_bwd_dkv, flash_bwd_dq,
                                                  flash_bwd_plain,
                                                  flash_dbias_plain,
                                                  flash_demb_plain, flash_fwd,
                                                  flash_fwd_plain, visible)
    B, H, Hkv, S, D = shape
    q, k, v, do, mask = flash_inputs(B, H, Hkv, S, D, padded,
                                     dtype=torch.float32)
    t5 = kind in ("t5", "t5_causal")
    if t5:
        bias = T5Bias(t5_table(H), kind == "t5")
        dense = bias.materialize(S, S)
    else:
        bias = dense = None if kind is None else \
            flash_bias(kind, B, H, S, mask)
    rows = visible(mask, S, causal, window).any(-1).expand(B, H, S)
    do = do * rows[..., None]
    args = (D ** -0.5, causal, window)

    def kernels(q, k, v, lse=None):
        """(out, lse, delta, dq, dk, dv), and demb with T5."""
        out, own = flash_fwd(q, k, v, mask, *args, bias)
        lse = own if lse is None else lse
        dq, delta, *demb = flash_bwd_dq(q, k, v, mask, out, lse, do, *args,
                                        bias, table_grad=t5)
        return (out, own, delta, dq) + flash_bwd_dkv(
            q, k, v, mask, do, lse, delta, *args, bias) + tuple(demb)

    first = kernels(q, k, v)
    out, lse, delta, dq, dk, dv = first[:6]
    ref_out, ref_lse = flash_fwd_plain(q, k, v, mask, *args, bias)
    ref = flash_bwd_plain(q, k, v, mask, out, ref_lse, do, *args, bias)
    torch.cuda.synchronize()
    lse_err = (lse - ref_lse)[rows].abs().max().item()
    limits = flash_f32_limits(q, k, v, mask, ref_lse, do, out, *args,
                              (ref_out,) + tuple(ref), dense)
    got = (out, dq, dk, dv)
    want = (ref_out,) + tuple(ref)
    excess = [flash_excess(out, ref_out, limits[0], rows)]
    excess += [flash_excess(g, w, lim)
               for g, w, lim in zip(got[1:], want[1:], limits[1:])]

    def worst(outputs):   # the largest excess of (out, dq, dk, dv)
        return max([flash_excess(outputs[0], ref_out, limits[0], rows)] +
                   [flash_excess(g, w, lim) for g, w, lim in
                    zip(outputs[1:], want[1:], limits[1:])])

    bad = kernels(*(round_tf32(x) for x in (q, k, v)))
    mutants = {"tf32": worst((bad[0],) + bad[3:])}
    bad = kernels(q, k, v, lse.roll(1, -1))
    mutants["other_lse"] = worst((out,) + bad[3:])
    errs = {}
    if kind is not None:
        name = "demb" if t5 else "dbias"
        grad = (first[6] if t5 else
                flash_bwd_dbias(q, k, v, mask, bias, do, lse, delta, *args))
        plain = flash_demb_plain if t5 else flash_dbias_plain
        ref_grad = plain(q, k, v, mask, out, ref_lse, do, *args, bias)
        limit = (flash_demb_limits(q, k, v, mask, ref_lse, do, out, *args,
                                   bias) if t5 else
                 flash_dbias_limits(q, k, v, mask, ref_lse, do, out, *args,
                                    bias, ref_grad))
        excess.append(flash_excess(grad, ref_grad, limit))
        errs[name] = (grad - ref_grad).abs().max().item()
        ds = flash_bwd_dbias(q, k, v, mask, dense.expand(B, H, S, S), do,
                             lse, delta, *args).to(torch.bfloat16).double()
        if t5:
            ds_demb = torch.zeros((H, bias.num_buckets), dtype=torch.float64,
                                  device=ds.device)
            ds_demb.index_add_(1, bias.buckets(S, S).reshape(-1),
                               ds.sum(0).reshape(H, S * S))
            bad_grad = ds_demb.t().float()
        else:
            bad_grad = _reduce_to(ds.float(), bias.shape)
        mutants[f"{name}_bf16"] = flash_excess(bad_grad, ref_grad, limit)
        del ds
        if not t5:
            # dbias without delta, given another row's lse, and on q, k, v
            # rounded to TF32 (a TF32 product); the same bits twice
            for mutant, bad_args in (
                    ("dbias_no_delta", (q, k, v, torch.zeros_like(delta),
                                        lse)),
                    ("dbias_other_lse", (q, k, v, delta, lse.roll(1, -1))),
                    ("dbias_tf32", tuple(round_tf32(x) for x in (q, k, v))
                     + (delta, lse))):
                bq, bk, bv, bdelta, blse = bad_args
                mutants[mutant] = flash_excess(flash_bwd_dbias(
                    bq, bk, bv, mask, bias, do, blse, bdelta, *args),
                    ref_grad, limit)
            dbias_again = flash_bwd_dbias(q, k, v, mask, bias, do, lse,
                                          delta, *args)
            dbias_same_bits = torch.equal(grad, dbias_again)
            del dbias_again
        if t5:
            fwd_mutants = {"direction": T5Bias(bias.table, kind != "t5"),
                           "shifted": shifted_t5(bias)}
            if kind == "t5":
                fwd_mutants["other_head"] = T5Bias(bias.table.roll(1, 1),
                                                   True)
        else:
            fwd_mutants = {}
            if bias.shape[1] > 1:
                fwd_mutants["other_head"] = bias.roll(1, 1)
            if kind != "alibi":     # ALiBi's causal bias: symmetric
                fwd_mutants["transposed"] = bias.transpose(-1, -2)
        for name, b in fwd_mutants.items():
            mutants[name] = flash_excess(flash_fwd(q, k, v, mask, *args, b)[0],
                                         ref_out, limits[0], rows)
    again = kernels(q, k, v)
    same_bits = all(torch.equal(a, b) for a, b in zip(first, again))
    if kind is not None and not t5:
        same_bits = same_bits and dbias_same_bits

    def err(got, want, rows=None):
        diff = (got - want).abs()
        return (diff[rows] if rows is not None else diff).max().item()

    errs.update(fwd=max(lse_err, err(out, ref_out, rows)), dq=err(dq, ref[0]),
                dkv=max(err(dk, ref[1]), err(dv, ref[2])))
    return {"lse_err": lse_err, "excess": excess, "mutants": mutants,
            "same_bits": same_bits, "max_abs_err": errs}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window,padded,kind", FLASH_F32_CASES)
def test_f32_flash_kernels_match_plain(shape, causal, window, padded, kind):
    """Float32 q, k and v take csrc/flash_f32.cu's kernels (counted as
    ``*_f32``, no bf16 kernel launched; T5's demb from the dq kernel, no
    separate demb kernel): out, dq, dk, dv and dbias or demb within their
    float32 limits, lse within F32_LSE_ATOL; each mutation at 2.8 times its
    limits or more; out, lse, delta, dq, dk, dv and demb the same bits
    twice."""
    from pasero_torch.ops.flash_attention import launch_counts
    _need_card()
    before = launch_counts()
    result = flash_f32_compare(shape, causal, window, padded, kind)
    after = launch_counts()
    launched = {n for n in after if after[n] != before[n]}
    assert launched and all(n.endswith("_f32") for n in launched), launched
    end = "_t5" if kind in ("t5", "t5_causal") else "_bias" if kind else ""
    assert {f"flash_fwd{end}_f32", f"flash_bwd_dq{end}_f32",
            f"flash_bwd_dkv{end}_f32"} <= launched
    assert ("flash_bwd_dq_t5_demb_f32" in launched) == (end == "_t5")
    assert "flash_bwd_demb_f32" not in launched
    assert result["lse_err"] <= F32_LSE_ATOL, result["lse_err"]
    assert max(result["excess"]) <= 1.0, result["excess"]
    assert min(result["mutants"].values()) >= 2.8, result["mutants"]
    assert result["same_bits"]


# The T5 forward (flash_bwd.cu's fwd_kernel<T5_BIAS, ...>: persistent at D
# <= 64, one block per item at D = 128) against the plain version at item
# counts below and above the card's SM count, a key length that is not a
# multiple of 64, head dims 32 and 128 and t5_base's decoder (causal) shape;
# out within ``flash_limits``, lse within 1e-4, and the T5 dq kernel given the
# forward's lse within its limits too (the lse is in natural units for every
# T5 kernel). Two forwards give the same bits.
T5_FWD_CASES = [   # (B, H, Hkv, S, D), causal, padded, bidirectional
    ((1, 2, 2, 256, 64), False, True, True),     # 4 items, below 132 SMs
    ((32, 12, 12, 512, 64), False, True, True),  # t5_base's encoder, 1536
    ((2, 4, 2, 333, 64), False, True, True),     # Sk % 64 != 0, GQA
    ((2, 4, 4, 100, 32), False, True, False),    # D = 32
    ((2, 8, 2, 300, 128), True, True, True),     # D = 128
    ((32, 12, 12, 128, 64), True, False, False),  # t5_base's decoder
]


def t5_forward_compare(shape, causal, padded, bidirectional) -> dict:
    """The T5 forward, and the T5 dq kernel on its lse, against the plain
    version at one shape. Returns the lse error, the excess of out and dq
    over ``flash_limits``, and whether a second forward gave the same
    bits."""
    from pasero_torch.ops.flash_attention import (T5Bias, flash_bwd_dq,
                                                  flash_bwd_plain, flash_fwd,
                                                  flash_fwd_plain, visible)
    B, H, Hkv, S, D = shape
    q, k, v, do, mask = flash_inputs(B, H, Hkv, S, D, padded)
    t5 = T5Bias(t5_table(H), bidirectional)
    rows = visible(mask, S, causal, None).any(-1).expand(B, H, S)
    do = do * rows[..., None]
    args = (D ** -0.5, causal, None, t5)
    out, lse = flash_fwd(q, k, v, mask, *args)
    again, lse2 = flash_fwd(q, k, v, mask, *args)
    dq, _ = flash_bwd_dq(q, k, v, mask, out, lse, do, *args)
    f32 = [x.float() for x in (q, k, v)]
    ref_out, ref_lse = flash_fwd_plain(*f32, mask, *args)
    ref = flash_bwd_plain(*f32, mask, out, ref_lse, do, *args)
    torch.cuda.synchronize()
    limits = flash_limits(q, k, v, mask, ref_lse, do, *args[:3],
                          (ref_out,) + tuple(ref), t5.materialize(S, S))
    return {"lse_err": (lse - ref_lse)[rows].abs().max().item(),
            "excess": [flash_excess(out, ref_out, limits[0], rows),
                       flash_excess(dq, ref[0], limits[1])],
            "same_bits": torch.equal(out, again) and torch.equal(lse, lse2)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,padded,bidirectional", T5_FWD_CASES)
def test_t5_forward_matches_plain(shape, causal, padded, bidirectional):
    _need_card()
    result = t5_forward_compare(shape, causal, padded, bidirectional)
    assert result["lse_err"] <= 1e-4
    assert max(result["excess"]) <= 1.0, result["excess"]
    assert result["same_bits"]


# The int8 GEMM and the fused head against their plain versions' float32
# results of the same bf16 x and int8 (or bf16) weight, in a limit per element:
# |got - want| <= r |want| + 2^-21 (K / 16 + 4) sum_k |x_k| |w_k|. The
# products are exact (an int8 value is a bf16 value) and only the sums round:
# each of the tensor cores' K / 16 steps, the kernel's split-K additions and
# the scale's product err by a few float32 ulps of a magnitude bounded by
# sum |x| |w|; r = 2^-7 covers a bf16 output's rounding (half an ulp is up to
# u = 2^-8 of it, and the float32 sums it rounds differ in their last bits)
# and is 1e-6 for a float32 output. The fused head's logits
# never leave the chip, so its tokens must equal the plain argmax on every
# row whose top-two gap exceeds twice the row's largest limit, and its
# log-probabilities lie within twice that plus 1e-5 (exp, log and the sum over
# the vocabulary in float32). A rolled scale or a result shifted by one column
# falls far outside these limits.
INT8_SHAPES = [   # (M, K, N): llama_1b's decode, speculative and prompt rows
    (M, K, N) for M in (8, 72, 1024)
    for K, N in ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
                 (2048, 32000))]
INT8_RAGGED = [(8, 256, 2192), (130, 48, 515)]
# the decode kernel (M <= 80) and the switch to the prompt's (81): one row,
# two n8 tiles, M = 80 and 81 at a narrow weight, and K whose 256-deep steps
# (the last one cut short) the cluster's blocks split unevenly
INT8_DECODE = [(M, 2048, 2048) for M in (1, 16)] + \
    [(M, 2048, 256) for M in (80, 81)] + [(8, 2320, 768), (72, 1040, 300)]
# the prompt kernel (M > 80): each x tile it picks (64, 128, 192, 256 rows),
# M, N and K ragged against them, rows of y 16-byte aligned (a TMA store)
# and not (plain stores)
INT8_PROMPT = [(81, 2048, 2048), (130, 2048, 5632), (256, 2048, 2048),
               (1000, 2320, 515), (1000, 2320, 2048), (1000, 1040, 5632),
               (2000, 1040, 30000), (2048, 1040, 300)]
# the fused heads (N, E, V): llama_1b's decode, speculative and prompt rows;
# the switch from the decode kernel to the wgmma kernels (after 8 rows of a
# bf16 head, 16 of an int8 one) and the decode kernel's own limit (80); a
# vocabulary ragged against every tile (64 and 128 rows, 256 columns) and
# one below a single tile; t5_base's head
HEAD_SHAPES = [(N, 2048, 32000) for N in (8, 72, 1024)] + [(8, 256, 2192)] + \
    [(N, 2048, 32000) for N in (1, 9, 16, 17, 80, 81)] + \
    [(N, 2048, 32000 + 37) for N in (8, 72, 1024)] + \
    [(N, 256, 40) for N in (8, 200)] + \
    [(N, 768, 32128) for N in (8, 1024)]
# Planted equal maxima: x row TIE_ROWS[N][j] has its head rows a and b of
# TIE_PAIRS[j] equal (and far above the rest), on both sides of a decode
# tile (64 rows), an int8 prompt tile (128) and its halves, a bf16 prompt
# tile (256 columns), the merge's 32-way interleave of partials (2048), within
# a tile, and at both ends of the vocabulary; TIE_ROWS spread over the x
# tiles of each N
TIE_PAIRS = [(63, 64), (127, 128), (255, 256), (2047, 2048), (4095, 4096),
             (300, 301), (10, 31990), (16383, 16384)]
TIE_ROWS = {8: list(range(8)), 72: [0, 9, 17, 33, 40, 55, 64, 71],
            1024: [0, 127, 128, 255, 256, 511, 900, 1023]}


def int8_limits(x, w, want, bf16_out: bool):
    """Per-element limits for x (M, K), the float32 weight the kernel reads
    (dequantized, or bf16 values) w (N, K) and the float32 result ``want``."""
    K = x.shape[1]
    sums = torch.matmul(x.float().abs(), w.abs().t())
    return (2.0 ** -7 if bf16_out else 1e-6) * want.abs() + \
        2.0 ** -21 * (K / 16 + 4) * sums


def int8_excess(got, want, limit) -> float:
    return ((got.float() - want).abs() / limit).max().item()


def int8_compare(M, K, N, out_dtype) -> dict:
    """One launch of the int8 kernel against int8_matmul_plain: the excess
    over the limits, that of a rolled scale and of a one-column shift, and
    whether a second launch gave the same bits."""
    from pasero_torch.ops.quantize import (QTensor, dequantize, int8_matmul,
                                           int8_matmul_plain)
    x, t = int8_inputs(M, K, N)
    got = int8_matmul(x, t, out_dtype)
    want = int8_matmul_plain(x, t.q, t.scale, torch.float32)
    limit = int8_limits(x, dequantize(t), want, out_dtype == torch.bfloat16)
    bad = int8_matmul(x, QTensor(t.q, t.scale.roll(1)), out_dtype)
    again = int8_matmul(x, t, out_dtype)
    torch.cuda.synchronize()
    return {"excess": int8_excess(got, want, limit),
            "same_bits": torch.equal(got, again),
            "bad_scale_excess": int8_excess(bad, want, limit),
            "shift_excess": int8_excess(got[:, 1:], want[:, :-1],
                                        limit[:, :-1]),
            "max_abs_err": (got.float() - want).abs().max().item()}


def head_compare(N, E, V, q8: bool) -> dict:
    """One run of the fused head (bf16 or int8) against the plain float32
    logits of the same inputs: tokens on the rows whose top-two gap exceeds
    twice their limit, log-probabilities within twice it plus 1e-5; the same
    check on a head given a rolled scale (int8) or a head read one row off
    (bf16)."""
    from pasero_torch.ops.fused_ce import (fused_head_argmax,
                                           fused_head_argmax_plain)
    from pasero_torch.ops.quantize import QTensor, dequantize
    x, t = int8_inputs(N, E, V, seed=1)
    head = t if q8 else dequantize(t, torch.bfloat16)
    w = dequantize(t) if q8 else head.float()
    logits = torch.matmul(x.float(), w.t())
    row_limit = int8_limits(x, w, logits, False).amax(dim=1)
    top2 = logits.topk(2, dim=1).values
    decided = top2[:, 0] - top2[:, 1] > 2 * row_limit
    want_tok, want_lp = fused_head_argmax_plain(x, head)
    del logits

    def excess(tok, lp):
        if not torch.equal(tok[decided], want_tok[decided]):
            return float("inf")
        return ((lp - want_lp).abs() / (2 * row_limit + 1e-5)).max().item()

    tok, lp = fused_head_argmax(x, head)
    bad = (QTensor(t.q, t.scale.roll(1)) if q8
           else torch.cat([head[1:], head[:1]]))
    bad_excess = excess(*fused_head_argmax(x, bad))
    torch.cuda.synchronize()
    return {"excess": excess(tok, lp), "bad_excess": bad_excess,
            "decided": int(decided.sum()),
            "max_abs_err": (lp - want_lp).abs().max().item()}


def head_tie_compare(N, q8: bool, E: int = 2048, V: int = 32000) -> dict:
    """The fused head (bf16 or int8) on a head with TIE_PAIRS planted for
    TIE_ROWS[N]: the tokens of those rows (the lower index of each pair
    wins), whether float64 logits of the same operands do tie there above
    every other row, two calls' bits, and the log-probabilities against the
    plain version's in head_compare's limits."""
    from pasero_torch.ops.fused_ce import (fused_head_argmax,
                                           fused_head_argmax_plain)
    from pasero_torch.ops.quantize import dequantize, quantize
    x, t = int8_inputs(N, E, V, seed=2)
    w = dequantize(t)
    rows = TIE_ROWS[N]
    for n, (a, b) in zip(rows, TIE_PAIRS):
        w[a] = w[b] = x[n].float() * (4 / math.sqrt(E))
    t = quantize(w)
    head = t if q8 else dequantize(t, torch.bfloat16)
    wf = dequantize(t) if q8 else head.float()
    lows = [a for a, _ in TIE_PAIRS]
    exact = (x[rows].double() @ wf.double().t()).cpu()
    top2 = exact.topk(2, dim=1)
    planted = all(sorted(top2.indices[j].tolist()) == list(pair)
                  and top2.values[j, 0] == top2.values[j, 1]
                  for j, pair in enumerate(TIE_PAIRS))
    logits = torch.matmul(x.float(), wf.t())
    row_limit = int8_limits(x, wf, logits, False).amax(dim=1)
    del logits
    _, want_lp = fused_head_argmax_plain(x, head)
    tok, lp = fused_head_argmax(x, head)
    tok2, lp2 = fused_head_argmax(x, head)
    torch.cuda.synchronize()
    return {"planted": planted, "tokens": tok[rows].tolist(), "lows": lows,
            "same_bits": torch.equal(tok, tok2) and torch.equal(lp, lp2),
            "lp_excess": ((lp - want_lp).abs()
                          / (2 * row_limit + 1e-5)).max().item()}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", INT8_SHAPES + INT8_RAGGED + INT8_DECODE
                         + INT8_PROMPT)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_matmul_matches_plain(shape, out_dtype):
    from pasero_torch.ops.quantize import int8_matmul
    _need_card()
    before = int8_matmul.launches
    r = int8_compare(*shape, out_dtype)
    assert int8_matmul.launches == before + 3
    assert r["excess"] <= 1.0, r
    assert r["bad_scale_excess"] > 1.0 and r["shift_excess"] > 1.0, r
    assert r["same_bits"], r


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HEAD_SHAPES)
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_fused_head_matches_plain(shape, q8):
    from pasero_torch.ops.fused_ce import (fused_head_argmax,
                                           fused_head_argmax_q8)
    _need_card()
    counter = fused_head_argmax_q8 if q8 else fused_head_argmax
    before = counter.launches
    r = head_compare(*shape, q8)
    assert counter.launches == before + 2
    assert r["decided"] >= shape[0] // 2, r
    assert r["excess"] <= 1.0, r
    assert r["bad_excess"] > 1.0, r


@pytest.mark.cuda
@pytest.mark.parametrize("N", sorted(TIE_ROWS))
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_fused_head_ties_go_to_the_lowest_index(N, q8):
    from pasero_torch.ops.fused_ce import (fused_head_argmax,
                                           fused_head_argmax_q8)
    _need_card()
    counter = fused_head_argmax_q8 if q8 else fused_head_argmax
    before = counter.launches
    r = head_tie_compare(N, q8)
    assert counter.launches == before + 2
    assert r["planted"], r
    assert r["tokens"] == r["lows"], r
    assert r["same_bits"], r
    assert r["lp_excess"] <= 1.0, r


@pytest.mark.cuda
def test_int8_and_head_wrappers_raise_on_card():
    """float32 x and a K not a multiple of 16 raise before any launch."""
    from pasero_torch.ops.fused_ce import fused_head_argmax
    from pasero_torch.ops.quantize import int8_matmul, quantize
    _need_card()
    t = quantize(torch.randn(32, 40, device="cuda"))
    before = (int8_matmul.launches, fused_head_argmax.launches)
    with pytest.raises(TypeError):
        int8_matmul(torch.zeros(4, 40, device="cuda"), t)
    with pytest.raises(ValueError):
        int8_matmul(torch.zeros(4, 40, device="cuda", dtype=torch.bfloat16), t)
    with pytest.raises(ValueError):
        fused_head_argmax(torch.zeros(4, 40, device="cuda",
                                      dtype=torch.bfloat16),
                          torch.zeros(32, 40, device="cuda"))
    assert (int8_matmul.launches, fused_head_argmax.launches) == before


# The mel kernel against power_mel_plain's float32 result of the same
# waveform, compared on log10 of the mel power floored at 1e-10 (what the
# features keep), in a limit per element. Each DFT sum of n_fft products
# errs by at most about n_fft float32 ulps (u = 2^-24) of sum_n |x_n|
# |basis_nk| in either computation, so the two differ by |d re_k| <= e A_k
# and |d im_k| <= e B_k with e = 2 n_fft u, A = |frames| @ |cos_b| and
# B = |frames| @ |sin_b|. The power then differs by
# dp = 2 (|re| + e A) e A + 2 (|im| + e B) e B + 4 u p, the mel by
# dm = dp @ M + 2 n_freq u mel, and log10 of the floored mel by
# dm / (ln 10 max(mel - dm, 1e-10)) + 4 u |log10 mel|; re, im, p and mel
# are the float64 values. Frames shifted by one hop, or a filterbank with
# one column rolled by one bin, fall far outside these limits on noise.
# Where the waveform is silent, A = B = 0 and both sides give exactly 0.
MEL_SHAPES = [(1, 16000), (1, 480000), (16, 480000), (3, 12345)]


def mel_inputs(B, N, kind="noise", seed=0, device="cuda"):
    """A float32 waveform (B, N): noise at speech-like level, or a 440 Hz
    tone over the first half and silence over the rest."""
    if kind == "tone":
        t = torch.arange(N, device=device, dtype=torch.float64) / 16000
        audio = 0.5 * torch.sin(2 * torch.pi * 440 * t)
        audio[N // 2:] = 0
        return audio.float().expand(B, N).contiguous()
    gen = torch.Generator(device=device).manual_seed(seed)
    return 0.1 * torch.randn(B, N, generator=gen, device=device)


def mel_constants(device="cuda", n_mels=80):
    """(window, mel_w) of Whisper's frontend: the Hann window of 400 points
    and the filterbank."""
    from pasero_torch.ops import mel
    return mel._constants(16000, 400, n_mels, torch.device(device))


def log_mel_power(m):
    return torch.log10(torch.clamp(m.double(), min=1e-10))


def mel_limits(audio, cos_b, sin_b, mel_w, hop=160):
    """(float64 log10 of the mel, the limit of each element)."""
    from pasero_torch.ops.mel import frame_signal
    u = 2.0 ** -24
    n_fft, n_freq = cos_b.shape
    frames = frame_signal(audio.double(), n_fft, hop)[:, :-1]
    c, s, m = cos_b.double(), sin_b.double(), mel_w.double()
    re, im = frames @ c, frames @ s
    A, B = frames.abs() @ c.abs(), frames.abs() @ s.abs()
    del frames
    e = 2 * n_fft * u
    p = re * re + im * im
    dp = 2 * (re.abs() + e * A) * e * A + 2 * (im.abs() + e * B) * e * B \
        + 4 * u * p
    del re, im, A, B
    mel = p @ m
    dm = dp @ m + 2 * n_freq * u * mel
    want = log_mel_power(mel)
    limit = dm / (math.log(10) * torch.clamp(mel - dm, min=1e-10)) \
        + 4 * u * want.abs()
    return want, limit


def mel_excess(got, want, limit) -> float:
    return ((log_mel_power(got) - want).abs() / limit).max().item()


def mel_compare(B, N, kind="noise", n_mels=80) -> dict:
    """One launch of the mel kernel against power_mel_plain, in the limits
    of mel_limits (on the plain version's bases of the window), and the
    excess of frames shifted by one hop, of a filterbank with its middle
    column rolled by one bin and of the window rolled by one sample."""
    from pasero_torch.ops.mel import power_mel, power_mel_plain, window_bases
    audio = mel_inputs(B, N, kind)
    window, mel_w = mel_constants(n_mels=n_mels)
    got = power_mel(audio, window, mel_w)
    plain = power_mel_plain(audio, window, mel_w)
    want, limit = mel_limits(audio, *window_bases(window), mel_w)
    T = want.shape[1]
    shifted = power_mel(audio[:, 160:].contiguous(), window, mel_w)
    rolled_w = mel_w.clone()
    col = n_mels // 2
    rolled_w[:, col] = rolled_w[:, col].roll(1)
    rolled = power_mel(audio, window, rolled_w)
    rolled_window = power_mel(audio, window.roll(1), mel_w)
    torch.cuda.synchronize()
    return {"excess": mel_excess(got, want, limit),
            "plain_excess": mel_excess(plain, want, limit),
            "shift_excess": mel_excess(shifted[:, :T - 2], want[:, :T - 2],
                                       limit[:, :T - 2]),
            "roll_excess": mel_excess(rolled, want, limit),
            "window_excess": mel_excess(rolled_window, want, limit),
            "max_abs_err": (log_mel_power(got)
                            - log_mel_power(plain)).abs().max().item(),
            "frames": T}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MEL_SHAPES)
def test_mel_kernel_matches_plain(shape):
    from pasero_torch.ops.mel import power_mel
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    before = power_mel.launches
    r = mel_compare(*shape)
    assert power_mel.launches == before + 4
    assert r["excess"] <= 1.0 and r["plain_excess"] <= 1.0, r
    assert r["shift_excess"] > 1.0 and r["roll_excess"] > 1.0, r
    assert r["window_excess"] > 1.0, r


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_kernel_holds_on_tone_and_silence(n_mels):
    """Most bins of a pure tone over silence sit at the clamp floor."""
    from pasero_torch.ops.mel import log_mel_spectrogram
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    r = mel_compare(2, 32000, "tone", n_mels)
    assert r["excess"] <= 1.0 and r["plain_excess"] <= 1.0, r
    feats = log_mel_spectrogram(mel_inputs(1, 32000, "tone"), n_mels=n_mels)
    assert (feats[0, 105:] == feats.min()).all()


@pytest.mark.cuda
def test_mel_wrapper_raises_on_card():
    """Types other than float32, more than 128 mel bins and window lengths
    the kernel does not factor raise before any launch."""
    from pasero_torch.ops.mel import power_mel
    _need_card()
    window, mel_w = mel_constants()
    audio = torch.zeros(2, 4000, device="cuda")
    before = power_mel.launches
    with pytest.raises(TypeError):
        power_mel(audio.half(), window, mel_w)
    with pytest.raises(ValueError):
        power_mel(audio, window, torch.zeros(201, 200, device="cuda"))
    with pytest.raises(ValueError):
        power_mel(audio, window[:300].contiguous(),
                  torch.zeros(151, 80, device="cuda"))
    assert power_mel.launches == before
