"""The port's hand-written kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports torch only, so it
also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from pasero_torch.ops.cache_update import (cache_slot_write_,
                                           cache_slot_write_plain)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU version")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((320, 8, 72, 64), torch.bfloat16),   # full-width decode: 16-byte copies
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
              ((130, 48, 515), torch.float32),     # the fp32 FMA path
              ((48, 2048, 330), torch.bfloat16),   # width over one block
              ((64, 36, 100), torch.bfloat16)]     # width not a multiple of 8


# The fused-CE gradients against float32 ones of the same operand values, in
# a limit per element: |got - want| <= rtol |want| + atol + K u S.
# In bf16 the kernels round each dlogits term to bf16 (relative error up to
# u = 2^-8) before the products, as JAX does, so an element's error is a sum
# of rounding errors of its terms a_i (dl * w for dx, dl * x for dW): at most
# u sqrt(m) S for m terms that dominate, S = sqrt(sum a_i^2), and of standard
# deviation u S / sqrt(3) when many terms add. K = 4 covers both, and rtol the
# bf16 rounding of dx. In float32 only the summation order differs.
# Readings on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 4): errors at
# most 0.52 of these limits in bf16 and 0.09 in float32; a backward given
# another row's lse lands at 336x of them or more.
FCE_GRAD_TOL = {torch.bfloat16: (1e-2, 1e-6, 4.0), torch.float32: (1e-4, 1e-6, 0.0)}
U_BF16 = 2.0 ** -8


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", FCE_SHAPES)
@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_fused_ce_kernels_match_plain(shape, dtype, ls):
    """Sums rtol 1e-5; gradients within ``fused_ce_grad_limits`` of the plain
    version's float32 gradients of the same operand values (x and the weight
    rounded to x's type first, so the reference rounds nothing). x has a
    per-row scale, so that the same check rejects the backward given another
    row's lse."""
    from pasero_torch.ops.fused_ce import (fused_ce_bwd, fused_ce_fwd,
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

    a, b = (1.0 - ls) + 0.5, ls
    cs = (wt * (a + b), wt * a, wt * (b / V))
    lse = torch.logsumexp(torch.matmul(x.float(), wb.float().t()), -1)
    limits = fused_ce_grad_limits(x, wb, t, lse, *cs, grads[1])
    excess = [fused_ce_grad_excess(got, want, limit)
              for got, want, limit in zip(grads[0], grads[1], limits)]
    assert max(excess) <= 1.0, excess
    bad = fused_ce_bwd(x, wb, t, fused_ce_fwd(x, wb, t)[0].roll(1), *cs)
    assert min(fused_ce_grad_excess(got, want, limit) for got, want, limit
               in zip(bad, grads[1], limits)) > 1.0


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
