"""The float32 fused cross-entropy's split-TF32 arithmetic, on the CPU.

csrc/fused_ce.cu takes every float32 product on the tensor cores as lo_a
hi_b + hi_a lo_b + hi_a hi_b of ``split_tf32``'s parts, each 32-deep
k-tile's products summed apart and added to the sum with a float32 add. Its
forward reduces each row's 128-column logits tiles to partials and merges
them (``merged_stats_plain``); its backward takes per vocabulary chunk dl
without the targets' -c2 in float32, dW = dl^T x and dx (+)= dl W_c as such
products, and adds each row's target term with one float32 fma (dW's rows
in ascending order). Here that arithmetic runs at two small shapes, one of
several backward chunks, one with a ragged vocabulary and E % 4 != 0, and
is held against JAX's ``fused_cross_entropy`` in float32 (its Pallas
kernels in interpret mode) within the float32 limits the kernels are held
to on the card (STAT_ATOL, STAT_SUM_RTOL and ``fused_ce_grad_limits`` of
tests/test_torch_cuda.py); one TF32 product (hi_a hi_b) must exceed them
F32_TF32_MIN times or more. The card's own sums are checked there.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasero_torch.ops.flash_attention import split_tf32
from pasero_torch.ops.fused_ce import (F32_TILE, _stats, dlogit_coefficients,
                                       merged_stats_plain)
from pasero_tpu.ops.fused_ce import _fwd

from test_torch_cuda import (F32_TF32_MIN, STAT_ATOL, STAT_SUM_RTOL,
                             fused_ce_grad_excess, fused_ce_grad_limits)
from test_torch_fused_ce import jax_run

BK = 32          # the kernels' k-tile
LS = 0.1
# (N, E, V), the backward's chunk of vocabulary rows (the kernels' is 8192)
CASES = [((96, 64, 1000), 256),     # four chunks, the last ragged
         ((130, 38, 515), 8192)]    # one chunk, V % 128 != 0, E padded to 40


def product(a, b, single=False):
    """a @ b.T, a (M, K) and b (N, K), as the kernels take it: per k-tile
    of BK the split products (lo hi and hi lo, then hi hi) summed apart,
    then added to the sum with a float32 add; ``single`` keeps hi hi only,
    one TF32 product."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    out = torch.zeros(a.shape[0], b.shape[0])
    for k0 in range(0, a.shape[1], BK):
        k = slice(k0, k0 + BK)
        part = ah[:, k] @ bh[:, k].T
        if not single:
            part = al[:, k] @ bh[:, k].T + ah[:, k] @ bl[:, k].T + part
        out = out + part
    return out


def fma(c, x, d):
    """c x + d rounded once to float32, as fmaf (the product exact in
    float64)."""
    return (c.double() * x.double() + d.double()).float()


def split_fwd(x, w, t, single=False):
    """(lse, target logit, logits sum) as the forward kernels order them."""
    return merged_stats_plain(product(x, w, single), t, F32_TILE)


def split_bwd(x, w, t, lse, c1, c2, c3, chunk, single=False):
    """(dx, dW) as the backward kernels order them."""
    N, E = x.shape
    V = w.shape[0]
    dx = torch.zeros(N, E)
    dw = torch.empty(V, E)
    for v0 in range(0, V, chunk):
        wc = w[v0:v0 + chunk]
        soft = c1[:, None] * torch.exp(product(x, wc, single) - lse[:, None]) \
            - c3[:, None]
        dwc = product(soft.T, x.T, single)
        for n in range(N):            # rows in ascending order
            if v0 <= t[n] < v0 + len(wc):
                dwc[t[n] - v0] = fma(-c2[n], x[n], dwc[t[n] - v0])
        dw[v0:v0 + len(wc)] = dwc
        part = product(soft, wc.T, single)
        hit = (t >= v0) & (t < v0 + len(wc))
        part[hit] = fma(-c2[hit, None], wc[t[hit] - v0], part[hit])
        dx = dx + part
    return dx, dw


def case(shape, seed=0):
    """Inputs as the card's tests make them (x with a per-row scale), E
    padded with zero columns to a multiple of 4 as the wrapper pads it."""
    N, E, V = shape
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(N, E)) * rng.uniform(0.5, 2.0, (N, 1))
         ).astype(np.float32)
    w = (rng.normal(size=(V, E)) * E ** -0.5).astype(np.float32)
    t = rng.integers(0, V, N).astype(np.int32)
    wt = (rng.random(N) >= 0.2).astype(np.float32)
    pad = (0, -E % 4)
    return (x, w, t, wt, torch.nn.functional.pad(torch.from_numpy(x), pad),
            torch.nn.functional.pad(torch.from_numpy(w), pad))


@pytest.mark.parametrize("shape,chunk", CASES, ids=["chunks", "ragged"])
def test_split_tf32_fused_ce_within_float32_limits(shape, chunk):
    N, E, V = shape
    x, w, t, wt, xp, wp = case(shape)
    tt = torch.from_numpy(t).long()
    loss, nll, den, dx_jax, dw_jax = jax_run(x, np.ascontiguousarray(w.T), t,
                                             wt, LS)
    want_stats = [torch.from_numpy(np.array(a)) for a in
                  _fwd(jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(t))]
    want = (torch.tensor(dx_jax), torch.tensor(dw_jax.T))
    cs = dlogit_coefficients(torch.from_numpy(wt), torch.tensor(1.0),
                             torch.tensor(0.5), LS, V)
    limits = fused_ce_grad_limits(torch.from_numpy(x), torch.from_numpy(w),
                                  tt, None, *cs, want)
    abs_sum = torch.from_numpy(np.abs(x @ w.T).sum(-1))

    def excess(single):
        """The worst statistic and the worst gradient over their limits,
        and the statistics."""
        stats = split_fwd(xp, wp, tt, single)
        err = [(got - ref).abs() for got, ref in zip(stats, want_stats)]
        stat = max(err[0].max().item() / STAT_ATOL,
                   err[1].max().item() / STAT_ATOL,
                   (err[2] / abs_sum).max().item() / STAT_SUM_RTOL)
        grads = split_bwd(xp, wp, tt, stats[0], *cs, chunk, single)
        grad = max(fused_ce_grad_excess(g[:, :E], w_, lim)
                   for g, w_, lim in zip(grads, want, limits))
        return stat, grad, stats

    stat, grad, stats = excess(False)
    assert stat <= 1.0 and grad <= 1.0, (stat, grad)
    # the losses from the statistics, as the wrapper's autograd forms them
    got = _stats(*stats, torch.from_numpy(wt), V, LS)
    np.testing.assert_allclose(got[0].item(), loss, rtol=1e-5)
    np.testing.assert_allclose(got[1].item(), nll, rtol=1e-5)
    assert got[2].item() == float(den)
    assert min(excess(True)[:2]) >= F32_TF32_MIN
