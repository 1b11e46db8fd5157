"""The port's T5 pieces against pasero_tpu's: the bucket of every distance,
the materialized bias, and the plain version of the T5 flash attention
(which CPU tensors take) against JAX ``flash_attention(..., t5_bias=)``,
whose streamed Pallas kernels run interpreted on the CPU; and the plain
version without a bias and with a dense bias against JAX's streamed
kernels, forced with PASERO_FLASH_STREAM_LIMIT=0 as
tests/test_flash_attention.py::test_streaming_matches_resident forces them.

Inputs are float32 from a numpy seed, fed to both. Tolerances: the buckets
and the bias bit for bit (the same float32 log, the same table entries);
T5 out within 2e-4 and dq, dk, dv and the table's gradient within 3e-3,
absolute and relative, as tests/test_flash_t5.py holds JAX's in-kernel
bias to its materialized one, except the case at a head dim the kernels do
not take (D = 100, padded to 128 on every device), held within 1e-5
absolute as flash_attention's padding is; the streamed kernels within 1e-5
absolute,
as tests/test_torch_alibi.py holds the resident ones (both sides compute in
float32 and differ only in summation order). Padded query rows are out of
the comparison of out and their upstream gradient is zero, as in a model.
Each JAX reference is computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pasero_tpu.ops.flash_attention as jax_fa
from pasero_tpu.models import positional as jax_positional
from pasero_torch.models.positional import (t5_bias_from_table, t5_bucket,
                                            t5_distance_buckets,
                                            t5_far_tiles)
from pasero_torch.ops.flash_attention import T5Bias, flash_attention

# (rtol, atol) of out and of the gradients, per case (see the docstring)
T5_TOL = ((2e-4, 2e-4), (3e-3, 3e-3))
PADDED_TOL = ((0, 1e-5), (0, 1e-5))
STREAM_ATOL = 1e-5
NB = 32

T5_CASES = {   # (B, H, Hkv, S, D), Sq, causal, window, bidirectional, maxd,
    # tolerances; tests/test_flash_t5.py's shapes: ragged rows, a mask, GQA
    "encoder_padded_gqa": ((2, 4, 2, 128, 32), 100, False, None, True, 64,
                           T5_TOL),
    "decoder_window_gqa": ((2, 4, 2, 128, 32), 128, True, 48, False, 128,
                           T5_TOL),
    # a head dim the kernels do not take, padded to 128 (llama_3b's 100)
    "encoder_padded_d100": ((2, 2, 2, 40, 100), 32, False, None, True, 128,
                            PADDED_TOL),
}
STREAM_CASES = {   # (B, H, Hkv, S, D), causal, bias (b0, h0) or None
    "no_bias_gqa": ((2, 4, 2, 128, 32), True, None),
    "bias_1xH_padded": ((2, 4, 4, 96, 32), False, (1, 4)),
}


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("nb,maxd", [(32, 128), (32, 64)])
def test_distance_buckets_match_jax_bit_for_bit(bidirectional, nb, maxd):
    """Every distance in +-65535: t5_bucket, and the per-distance index read
    at k - q + Sq - 1, for a square and for an unequal (Sq, Sk)."""
    rel = np.arange(-65535, 65536, dtype=np.int32)               # q - k
    want = np.asarray(jax.jit(lambda r: jax_positional.t5_bucket(
        r, bidirectional, nb, maxd))(jnp.asarray(rel)))
    np.testing.assert_array_equal(t5_bucket(rel, bidirectional, nb, maxd),
                                  want)
    index = t5_distance_buckets(65536, 65536, bidirectional, nb, maxd)
    assert index.dtype == torch.int32 and index.shape == (2 * 65536 - 1,)
    np.testing.assert_array_equal(index.numpy()[65535 - rel], want)
    Sq, Sk = 300, 70000
    index = t5_distance_buckets(Sq, Sk, bidirectional, nb, maxd).numpy()
    q, k = np.array([0, 17, 299, 299]), np.array([65000, 5, 0, 65834])
    np.testing.assert_array_equal(index[k - q + Sq - 1],
                                  want[65535 - (k - q)])


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("nb,maxd", [(32, 128), (32, 64)])
def test_each_bucket_is_one_run_of_distances(bidirectional, nb, maxd):
    """The T5 dq kernel sums its table's gradient by runs of consecutive
    distances (csrc/flash_bwd.cu, DEMB_LD): every bucket of the index must
    be one contiguous run, at every distance t5_base (32 buckets, 128) and
    t5-mini meet, here all of +-65535."""
    index = t5_distance_buckets(65536, 65536, bidirectional, nb,
                                maxd).numpy()
    starts = np.flatnonzero(np.diff(index)) + 1
    runs = index[np.concatenate([[0], starts])]
    assert len(np.unique(runs)) == len(runs)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_far_tile_plan_matches_a_scan_of_the_index(bidirectional):
    """``t5_far_tiles`` against a brute-force scan of the index of t5_base's
    (and t5-mini's) 32 buckets up to 128: at every tile offset k0 - q0 (a
    multiple of 64), the plan calls a tile far on a side exactly when all
    127 of its distances, clamped into the index, lie in that side's end
    bucket; at t5_base's encoder (512) and decoder (128) lengths, t5-mini's
    (256), an unequal pair and 32768."""
    for Sq, Sk in ((512, 512), (128, 128), (256, 256), (100, 300),
                   (32768, 32768)):
        index = t5_distance_buckets(Sq, Sk, bidirectional, 32, 128).numpy()
        neg, pos, b_neg, b_pos = t5_far_tiles(Sq, Sk, bidirectional, 32, 128)
        assert (b_neg, b_pos) == (index[0], index[-1])
        offsets = np.arange(-(Sq // 64 + 3) * 64, (Sk // 64 + 3) * 64, 64)
        d = offsets[:, None] + np.arange(-63, 64)[None, :]
        tiles = index[np.clip(d + Sq - 1, 0, Sq + Sk - 2)]
        np.testing.assert_array_equal(offsets <= neg,
                                      (tiles == b_neg).all(axis=1))
        np.testing.assert_array_equal(offsets >= pos,
                                      (tiles == b_pos).all(axis=1))


@pytest.mark.parametrize("bidirectional", [True, False])
def test_bias_from_table_matches_jax(bidirectional):
    """Positions as a decode over a cache gives them: negative slots of a
    left-padded prompt and distances far past max_distance."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(NB, 3)).astype(np.float32)
    q_pos = rng.integers(-40, 700, (2, 5)).astype(np.int32)
    k_pos = rng.integers(-40, 700, (2, 9)).astype(np.int32)
    want = jax_positional.t5_bias_from_table(
        jnp.asarray(table), jnp.asarray(q_pos), jnp.asarray(k_pos),
        bidirectional, NB, 128)
    got = t5_bias_from_table(torch.from_numpy(table), torch.from_numpy(q_pos),
                             torch.from_numpy(k_pos), bidirectional, NB, 128)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def t5_inputs(case, seed=0):
    (B, H, Hkv, S, D), Sq, causal, window, bidirectional, maxd, _ = \
        T5_CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Hkv, Sq, D)).astype(np.float32)
            for _ in range(2))
    table = (0.5 * rng.normal(size=(NB, H))).astype(np.float32)
    g = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    lengths = np.array([Sq * 4 // 5, Sq]) if Sq < S else np.full(B, Sq)
    valid = np.arange(Sq)[None, :] < lengths[:, None]             # (B, Sq)
    g = g * valid[:, None, :, None]
    mask = np.broadcast_to(valid[:, None, None, :], (B, 1, Sq, Sq))
    kw = dict(scale=0.2, causal=causal, window=window)
    return (q, k, v, table, g, mask, valid, kw,
            (bidirectional, NB, maxd))


@pytest.fixture(scope="module")
def jax_t5():
    """JAX's out and gradients (q, k, v, table) of every T5 case."""
    results = {}
    for case in T5_CASES:
        q, k, v, table, g, mask, _, kw, meta = t5_inputs(case)

        def loss(q, k, v, table):
            out = jax_fa.flash_attention(q, k, v, mask=jnp.asarray(mask),
                                         t5_bias=jax_fa.T5Bias(table, *meta),
                                         **kw)
            return jnp.sum(out * g), out

        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True))(q, k, v, table)
        results[case] = [np.asarray(out)] + [np.asarray(x) for x in grads]
    return results


@pytest.mark.parametrize("case", list(T5_CASES))
def test_t5_flash_matches_jax(case, jax_t5):
    """out, dq, dk, dv and the (num_buckets, H) table gradient."""
    q, k, v, table, g, mask, valid, kw, meta = t5_inputs(case)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, table)]
    out = flash_attention(*leaves[:3], mask=torch.from_numpy(mask.copy()),
                          t5_bias=T5Bias(leaves[3], *meta), **kw)
    (out * torch.from_numpy(g)).sum().backward()
    want = jax_t5[case]
    rows = valid[:, None, :, None]
    (out_rtol, out_atol), (rtol, atol) = T5_CASES[case][-1]
    np.testing.assert_allclose(out.detach().numpy() * rows, want[0] * rows,
                               rtol=out_rtol, atol=out_atol)
    for name, w, leaf in zip(("dq", "dk", "dv", "dtable"), want[1:], leaves):
        assert leaf.grad.shape == w.shape, name
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=rtol, atol=atol,
                                   err_msg=name)


def stream_inputs(case, seed=1):
    (B, H, Hkv, S, D), causal, bias_shape = STREAM_CASES[case]
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(B, H, S, D)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
            for _ in range(2))
    bias = None
    lengths = np.full(B, S)
    if bias_shape is not None:
        bias = (2 * rng.normal(size=bias_shape + (S, S))).astype(np.float32)
        lengths = rng.integers(S // 2, S, B)
    mask = np.arange(S)[None, :] < lengths[:, None]
    return q, k, v, g, bias, mask[:, None, None, :], D ** -0.5, causal


@pytest.fixture(scope="module")
def jax_streamed():
    """JAX's out and gradients of every STREAM_CASES case through its
    streamed kernels (_fwd_stream, _bwd_stream)."""
    results = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PASERO_FLASH_STREAM_LIMIT", "0")
        for case in STREAM_CASES:
            q, k, v, g, bias, mask, scale, causal = stream_inputs(case)
            assert jax_fa._use_streaming(q.shape[2], q.shape[3], q.dtype)
            args = [q, k, v] + ([bias] if bias is not None else [])

            def loss(q, k, v, bias=None):
                out = jax_fa.flash_attention(q, k, v, mask=jnp.asarray(mask),
                                             bias=bias, scale=scale,
                                             causal=causal)
                return jnp.sum(out * g), out

            (_, out), grads = jax.jit(jax.value_and_grad(
                loss, argnums=tuple(range(len(args))), has_aux=True))(*args)
            results[case] = [np.asarray(out)] + [np.asarray(x)
                                                 for x in grads]
    return results


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_plain_flash_matches_jax_streamed_kernels(case, jax_streamed):
    q, k, v, g, bias, mask, scale, causal = stream_inputs(case)
    arrays = [q, k, v] + ([bias] if bias is not None else [])
    leaves = [torch.from_numpy(x).requires_grad_() for x in arrays]
    out = flash_attention(*leaves[:3], mask=torch.from_numpy(mask),
                          bias=leaves[3] if bias is not None else None,
                          scale=scale, causal=causal)
    (out * torch.from_numpy(g)).sum().backward()
    want = jax_streamed[case]
    got = [out.detach().numpy()] + [x.grad.numpy() for x in leaves]
    for name, w, t in zip(("out", "dq", "dk", "dv", "dbias"), want, got):
        assert t.shape == w.shape, name
        assert np.abs(w - t).max() <= STREAM_ATOL, (name,
                                                    np.abs(w - t).max())


def test_flash_refuses_a_bias_with_a_t5_table_and_a_wrong_table():
    q = torch.zeros(2, 4, 8, 16)
    table = torch.zeros(NB, 4)
    with pytest.raises(ValueError, match="not both"):
        flash_attention(q, q, q, bias=torch.zeros(1, 4, 8, 8),
                        t5_bias=T5Bias(table))
    with pytest.raises(ValueError, match="T5 table"):
        flash_attention(q, q, q, t5_bias=T5Bias(torch.zeros(NB, 3)))
