"""The port's ALiBi pieces against pasero_tpu's: the slopes and the bias, and
the plain version of the biased flash attention (which CPU tensors take)
against JAX ``flash_attention(..., bias=)``, the Pallas kernels in interpret
mode as tests/test_flash_attention.py runs them.

Inputs are float32 from a numpy seed, fed to both. Tolerances: atol 1e-6 on
the bias (the same float32 products); atol 1e-5 on out, dq, dk, dv and
dbias (both sides compute in float32 and differ only in summation order).
Rows that see no key (a sliding window past the padding) are out of the
comparison of out, and their upstream gradient is zero, as in a model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pasero_tpu.ops.flash_attention as jax_fa
from pasero_tpu.models import positional as jax_positional
from pasero_torch.models.attention import MultiheadAttention
from pasero_torch.models.positional import alibi_bias, alibi_slopes
from pasero_torch.ops.flash_attention import flash_attention, visible

ATOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode():
    jax_fa.INTERPRET = True
    yield
    jax_fa.INTERPRET = False


def positions(B=2, S=11, seed=0):
    """Right-padded rows' positions (the padding repeats the last one)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(S // 2, S + 1, B)
    mask = np.arange(S)[None] < lengths[:, None]
    return np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32), mask


@pytest.mark.parametrize("heads", [4, 12])
@pytest.mark.parametrize("max_bias", [8, 16])
def test_alibi_slopes_match_jax(heads, max_bias):
    np.testing.assert_array_equal(alibi_slopes(heads, max_bias),
                                  jax_positional.alibi_slopes(heads, max_bias))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("max_bias", [8, 16])
def test_alibi_bias_matches_jax(causal, max_bias):
    """Causal, and the non-causal half-head bias; queries against a longer
    key axis, as at decode over a cache."""
    q_pos, _ = positions()
    k_pos = np.concatenate([q_pos - 3, q_pos], axis=1)
    want = jax_positional.alibi_bias(5, jnp.asarray(q_pos), jnp.asarray(k_pos),
                                     max_bias=max_bias, causal=causal)
    got = alibi_bias(5, torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                     max_bias, causal=causal)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(np.asarray(want) - got.numpy()).max() <= 1e-6


@pytest.mark.parametrize("causal", [True, False])
def test_alibi_bias_rows_are_padded_for_the_kernels(causal):
    """At 11 and 22 keys the bias's rows lie 12 and 24 floats apart, a
    multiple of four (the flash kernels' TMA needs 16-byte rows), its
    planes Sq rows apart, as the CUDA wrappers read it without a copy; the
    values are JAX's."""
    from pasero_torch.ops.flash_attention import _rows_apart
    q_pos, _ = positions()
    for k_pos, ld in ((q_pos, 12), (np.concatenate([q_pos - 3, q_pos], 1), 24)):
        got = alibi_bias(5, torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                         causal=causal)
        assert got.stride() == (5 * 11 * ld, 11 * ld, ld, 1)
        assert _rows_apart(got) == ld
        want = jax_positional.alibi_bias(5, jnp.asarray(q_pos),
                                         jnp.asarray(k_pos), causal=causal)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


CASES = {   # (B, H, Hkv, S, D), causal, window, padded, bias (b0, h0)
    "shared_1x1": ((2, 4, 4, 40, 16), True, None, False, (1, 1)),
    "per_head_1xH": ((2, 4, 2, 40, 16), True, None, True, (1, 4)),
    "per_sample_Bx1": ((2, 4, 2, 33, 16), False, None, True, (2, 1)),
    "full_BxH": ((2, 4, 4, 48, 16), True, None, True, (2, 4)),
    "gqa4_window_padded": ((1, 4, 1, 64, 16), True, 9, True, (1, 4)),
}


def inputs(B, H, Hkv, S, D, padded, bias_shape, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    g = rng.normal(size=(B, H, S, D)).astype(np.float32)
    bias = (2 * rng.normal(size=bias_shape + (S, S))).astype(np.float32)
    lengths = rng.integers(S // 2, S, B) if padded else np.full(B, S)
    mask = np.arange(S)[None, :] < lengths[:, None]          # (B, S) keys
    return q, k, v, g, bias, mask[:, None, None, :]


def run_both(q, k, v, g, bias, mask, scale, causal, window):
    """(out, dq, dk, dv, dbias) of JAX's and of the port's flash attention,
    with g zeroed on the rows that see no key; and those rows."""
    B, H, S = q.shape[:3]
    rows = visible(torch.from_numpy(mask[:, 0, 0]), S, causal, window
                   ).any(-1).expand(B, H, S).numpy()
    g = g * rows[..., None]

    def jax_loss(q, k, v, bias):
        out = jax_fa.flash_attention(q, k, v, mask=jnp.asarray(mask),
                                     bias=bias, scale=scale, causal=causal,
                                     window=window)
        return jnp.sum(out * g), out

    (_, out_j), grads_j = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v, bias)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    out_t = flash_attention(*leaves[:3], mask=torch.from_numpy(mask),
                            bias=leaves[3], scale=scale, causal=causal,
                            window=window)
    (out_t * torch.from_numpy(g)).sum().backward()
    want = [np.asarray(out_j)] + [np.asarray(x) for x in grads_j]
    got = [out_t.detach().numpy()] + [x.grad.numpy() for x in leaves]
    return want, got, rows


def assert_close(want, got, rows):
    assert np.abs(want[0] - got[0])[rows].max() <= ATOL
    for name, w, t in zip(("dq", "dk", "dv", "dbias"), want[1:], got[1:]):
        assert t.shape == w.shape, name
        assert np.abs(w - t).max() <= ATOL, (name, np.abs(w - t).max())


@pytest.mark.parametrize("case", list(CASES))
def test_biased_flash_matches_jax(case):
    (B, H, Hkv, S, D), causal, window, padded, bias_shape = CASES[case]
    q, k, v, g, bias, mask = inputs(B, H, Hkv, S, D, padded, bias_shape)
    assert_close(*run_both(q, k, v, g, bias, mask, D ** -0.5, causal,
                           window))


def test_encoder_alibi_row_of_only_large_negative_bias():
    """The encoder's half-head ALiBi over padded rows: the last real query
    of a right-context head sees only -1e9 entries, and gets an ordinary
    softmax over them (the mean of the visible values), as in JAX, not the
    out = 0 of a row with no key."""
    B, H, S, D = 2, 4, 24, 16
    rng = np.random.default_rng(5)
    pos, key_mask = positions(B, S, seed=5)
    bias = np.array(jax_positional.alibi_bias(
        H, jnp.asarray(pos), jnp.asarray(pos), causal=False))
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, H, S, D)).astype(np.float32)
            for _ in range(2))
    g = rng.normal(size=(B, H, S, D)).astype(np.float32)
    mask = key_mask[:, None, None, :]
    want, got, rows = run_both(q, k, v, g, bias, mask, D ** -0.5, False, None)
    assert_close(want, got, rows)
    for b in range(B):
        last = int(key_mask[b].sum()) - 1
        assert (bias[b, H - 1, last][key_mask[b]] == -1e9).all()
        mean = v[b, H - 1][key_mask[b]].mean(0)
        np.testing.assert_allclose(got[0][b, H - 1, last], mean, atol=1e-5)


def test_auto_kernel_rule_takes_no_flash_for_a_bias_below_4096_squared():
    """JAX's rule (attention.py:270-281): grouped K/V heads take flash from
    1024^2 scores only without a bias; a biased attention from 4096^2 or
    with ``attention_kernel: flash``."""
    gqa = MultiheadAttention(64, 4, kv_heads=2, causal=True)
    assert gqa.use_flash(2048, 2048, decode=False)
    assert not gqa.use_flash(2048, 2048, decode=False, biased=True)
    assert gqa.use_flash(4096, 4096, decode=False, biased=True)
    assert not gqa.use_flash(4096, 4096, decode=True, biased=True)
    forced = MultiheadAttention(64, 4, kernel="flash")
    assert forced.use_flash(8, 8, decode=False, biased=True)


def test_flash_refuses_a_bias_of_another_shape():
    q = torch.zeros(2, 4, 8, 16)
    for shape in ((3, 4, 8, 8), (2, 2, 8, 8), (1, 1, 8, 7), (4, 8, 8)):
        with pytest.raises(ValueError, match="bias"):
            flash_attention(q, q, q, bias=torch.zeros(shape))
