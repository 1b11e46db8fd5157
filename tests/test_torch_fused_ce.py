"""The port's fused cross-entropy against pasero_tpu's, on the same inputs.

On the CPU the port's ``fused_cross_entropy`` is its plain version (float32
logits of operands in x's type, autograd for the gradients); the JAX
function runs its Pallas kernels in interpret mode off the TPU. Inputs come
from numpy seeds; the port takes the head weight as (V, E), JAX as (E, V).

Tolerances: loss and nll sums rtol 1e-5 (both sum float32 products, in
another order); the weight sum exactly; dx and dW rtol 2e-2, atol 2e-5, the
JAX package's own tolerance for its kernels (tests/test_fused_ce.py). With
bf16 x the JAX kernel rounds dlogits to bf16 before the products, the plain
version does not, so its gradients are held at 2e-2 of their largest
magnitude. The backward's own plain version, ``fused_ce_bwd_plain``, rounds
dlogits as the kernels do and is held much closer to JAX's backward kernels
(``test_fused_ce_bwd_plain_matches_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasero_tpu.models.transformer import \
    chunked_cross_entropy as jax_chunked
from pasero_tpu.ops.fused_ce import _bwd_matmuls, _fwd
from pasero_tpu.ops.fused_ce import fused_cross_entropy as jax_fused
from pasero_torch.models.transformer import chunked_cross_entropy
from pasero_torch.ops.fused_ce import (fused_ce_bwd, fused_ce_bwd_plain,
                                       fused_ce_fwd, fused_ce_fwd_plain,
                                       fused_cross_entropy)


def inputs(N, E, V, seed, x_scale=1.0, w_scale=0.05):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(N, E)) * x_scale).astype(np.float32)
    w = (rng.normal(size=(E, V)) * w_scale).astype(np.float32)
    targets = rng.integers(0, V, N).astype(np.int32)
    weights = (rng.random(N) > 0.2).astype(np.float32)
    return x, w, targets, weights


def jax_run(x, w, targets, weights, ls, dtype=jnp.float32):
    def f(x, w):
        loss, nll, den = jax_fused(x.astype(dtype), w, jnp.asarray(targets),
                                   jnp.asarray(weights), ls)
        return loss + 0.5 * nll, (loss, nll, den)
    (_, out), (dx, dw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(v, np.float32) for v in (*out, dx, dw)]


def torch_run(x, w, targets, weights, ls, dtype=torch.float32):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(np.ascontiguousarray(w.T), requires_grad=True)
    loss, nll, den = fused_cross_entropy(xt.to(dtype), wt,
                                         torch.from_numpy(targets),
                                         torch.from_numpy(weights), ls)
    (loss + 0.5 * nll).backward()
    return [v.detach().float().numpy() for v in
            (loss, nll, den, xt.grad, wt.grad.T)]


def check(jax_out, torch_out, grad_rtol=2e-2, grad_atol=2e-5):
    (l0, n0, d0, dx0, dw0), (l1, n1, d1, dx1, dw1) = jax_out, torch_out
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    np.testing.assert_allclose(n1, n0, rtol=1e-5)
    assert float(d1) == float(d0)
    np.testing.assert_allclose(dx1, dx0, rtol=grad_rtol, atol=grad_atol)
    np.testing.assert_allclose(dw1, dw0, rtol=grad_rtol, atol=grad_atol)


@pytest.mark.parametrize("ls", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(64, 32, 100), (130, 48, 515)])
def test_fused_ce_matches_jax(shape, ls):
    args = inputs(*shape, seed=0)
    check(jax_run(*args, ls), torch_run(*args, ls))


@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_fused_ce_split_shape_matches_jax(ls):
    """E = 2048: the shape that takes JAX's split backward (rows 3 and 4 of
    the kernel table share the port's one backward)."""
    args = inputs(48, 2048, 330, seed=2, x_scale=0.1, w_scale=0.02)
    check(jax_run(*args, ls), torch_run(*args, ls))


def test_fused_ce_bf16_matches_jax():
    x, w, t, wt = inputs(256, 64, 1000, seed=1)
    wt[:] = 1.0
    j = jax_run(x, w, t, wt, 0.1, jnp.bfloat16)
    p = torch_run(x, w, t, wt, 0.1, torch.bfloat16)
    np.testing.assert_allclose(p[0], j[0], rtol=1e-5)
    np.testing.assert_allclose(p[1], j[1], rtol=1e-5)
    assert float(p[2]) == float(j[2]) == 256
    for a, b in ((p[3], j[3]), (p[4], j[4])):
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max()


def test_fused_ce_fwd_plain_matches_jax():
    """fused_ce_fwd_plain (the bf16 kernels' order: a partial per row and
    vocabulary tile, merged lane-strided over 32 lanes, then in a butterfly)
    against JAX's forward kernel (interpret mode) on the same float32
    inputs, at the kernels' 256-column tiles (5 partials a row, the last
    ragged) and at 8-column tiles (138 partials: several per lane): lse and
    the target logit within 1e-5, the logits sum within 1e-6 of its row's
    |sum|."""
    x, w, t, _ = inputs(64, 32, 1100, seed=5)
    want = [np.asarray(a) for a in _fwd(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(t))]
    xt, wt = torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T))
    abs_sum = np.abs(x @ w).sum(-1)
    for tile in (256, 8):
        got = [a.numpy() for a in fused_ce_fwd_plain(xt, wt, torch.from_numpy(t),
                                                     tile)]
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
        assert (np.abs(got[2] - want[2]) <= 1e-6 * abs_sum).all()


# (shape, plain chunk, x scale, w scale, dW's rtol): JAX's fused backward
# (_bwd_matmuls) at a small E, with a vocabulary of four chunks and a ragged
# tail; its split backward (_bwd_split, taken at E >= 2048) with three.
BWD_CASES = [((96, 64, 1000), 256, 1.0, 0.05, 2.0 ** -8),
             ((48, 2048, 330), 128, 0.1, 0.02, 1e-5)]


@pytest.mark.parametrize("shape,chunk,x_scale,w_scale,dw_rtol", BWD_CASES)
def test_fused_ce_bwd_plain_matches_jax(shape, chunk, x_scale, w_scale,
                                        dw_rtol):
    """fused_ce_bwd_plain in bf16 against JAX's backward kernels (interpret
    mode) on the same bf16 inputs and float32 lse. Both round dlogits to
    bf16 before float32 products, so they differ by summation order, by one
    bf16 step of dx (both write it in bf16: rtol 2^-7) and of JAX's fused dW,
    whose per-row-block partials are bf16 (rtol 2^-8; the split backward's
    dW is float32: 1e-5), plus atol 2^-10 of the largest magnitude for a
    dlogit that the two logits' summation orders round to neighbouring bf16
    values."""
    N, E, V = shape
    x, w, t, wt = inputs(N, E, V, seed=4, x_scale=x_scale, w_scale=w_scale)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    lse = np.array(_fwd(xb, wb, jnp.asarray(t))[0])
    a, b = 1.5, 0.1        # the backward of loss + 0.5 nll at ls = 0.1
    cs = [wt * (a + b), wt * a, wt * (b / V)]
    want = _bwd_matmuls(xb, wb, jnp.asarray(t), jnp.asarray(lse),
                        *map(jnp.asarray, cs))
    got = fused_ce_bwd_plain(
        torch.tensor(np.asarray(xb, np.float32)).bfloat16(),
        torch.tensor(np.asarray(wb, np.float32).T.copy()).bfloat16(),
        torch.from_numpy(t), *map(torch.from_numpy, [lse] + cs), chunk=chunk)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for g, j, rtol in ((got[0], want[0], 2.0 ** -7),
                       (got[1], np.asarray(want[1], np.float32).T, dw_rtol)):
        g, j = g.float().numpy(), np.asarray(j, np.float32)
        limit = rtol * np.abs(j) + 2.0 ** -10 * np.abs(j).max()
        assert (np.abs(g - j) <= limit).all(), np.abs(g - j).max()


@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_chunked_ce_matches_jax(ls):
    """ce_impl='chunked': checkpointed sequence chunks, T not a multiple of
    the chunk count."""
    B, T, E, V = 3, 13, 24, 77
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, T, E)).astype(np.float32)
    w = (rng.normal(size=(E, V)) * 0.1).astype(np.float32)
    targets = rng.integers(0, V, (B, T)).astype(np.int32)
    weights = (rng.random((B, T)) > 0.3).astype(np.float32)

    def f(x, w):
        loss, nll, den = jax_chunked(x, w, jnp.asarray(targets),
                                     jnp.asarray(weights), ls, num_chunks=4)
        return loss + 0.5 * nll, (loss, nll, den)
    (_, j), jg = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(np.ascontiguousarray(w.T), requires_grad=True)
    p = chunked_cross_entropy(xt, wt, torch.from_numpy(targets),
                              torch.from_numpy(weights), ls, num_chunks=4)
    (p[0] + 0.5 * p[1]).backward()
    np.testing.assert_allclose(p[0].item(), float(j[0]), rtol=1e-5)
    np.testing.assert_allclose(p[1].item(), float(j[1]), rtol=1e-5)
    assert p[2].item() == float(j[2])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg[0]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy().T, np.asarray(jg[1]),
                               rtol=1e-4, atol=1e-6)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch only on the card; the CPU path is the
    plain version, reached through fused_cross_entropy."""
    x = torch.zeros(4, 8)
    w = torch.zeros(5, 8)
    t = torch.zeros(4, dtype=torch.long)
    before = (fused_ce_fwd.launches, fused_ce_bwd.launches)
    with pytest.raises(ValueError, match="no fused-CE kernel"):
        fused_ce_fwd(x, w, t)
    with pytest.raises(ValueError, match="no fused-CE kernel"):
        fused_ce_bwd(x, w, t, *[torch.zeros(4)] * 4)
    assert (fused_ce_fwd.launches, fused_ce_bwd.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "targets"])
def test_bad_inputs_raise(bad):
    x, w = torch.zeros(4, 8), torch.zeros(5, 8)
    t, wt = torch.zeros(4, dtype=torch.long), torch.ones(4)
    if bad == "dtype":
        x = x.half()
    elif bad == "shape":
        w = torch.zeros(5, 7)
    else:
        t = t.float()
    with pytest.raises((TypeError, ValueError)):
        fused_cross_entropy(x, w, t, wt, 0.1)
