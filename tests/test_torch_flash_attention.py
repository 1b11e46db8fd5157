"""The port's flash attention (its plain version, which CPU tensors take)
against JAX ``flash_attention`` (the Pallas kernels in interpret mode, as
tests/test_flash_attention.py runs them), forward and gradients.

Head dims the kernels do not take (16, 48, 80) go through the padding to
the next kernel head dim that the port applies on every device, as JAX pads
them; the D = 80 case (bloom_3b's head) carries ALiBi's causal bias.

Inputs are float32 from a numpy seed, fed to both. Tolerance: atol 1e-5 on
out, dq, dk and dv — both sides compute in float32 and differ only in
summation order (blockwise online softmax in JAX, a dense softmax here).
Rows that see no key (a sliding window past the padding) are out of the
comparison of out: JAX leaves them to its block order. Their upstream
gradient is zero, as in a model, where the loss weights a padded row 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pasero_tpu.ops.flash_attention as jax_fa
from pasero_torch.models.positional import alibi_bias
from pasero_torch.ops.flash_attention import (flash_attention, key_mask,
                                              padded_head_dim, visible)

ATOL = 1e-5

CASES = {   # (B, H, Hkv, S, D), causal, window, padded[, "alibi"]
    "group1_causal": ((2, 2, 2, 40, 16), True, None, False),
    "group2_causal_padded": ((2, 4, 2, 48, 16), True, None, True),
    "group4_full_padded": ((2, 4, 1, 33, 16), False, None, True),
    "group2_window_padded": ((1, 4, 2, 64, 16), True, 9, True),
    "unaligned_d48": ((1, 2, 1, 21, 48), True, None, False),
    "alibi_padded_d80": ((2, 4, 4, 24, 80), True, None, True, "alibi"),
}


@pytest.fixture(autouse=True)
def interpret_mode():
    jax_fa.INTERPRET = True
    yield
    jax_fa.INTERPRET = False


def inputs(B, H, Hkv, S, D, padded, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    g = rng.normal(size=(B, H, S, D)).astype(np.float32)
    lengths = rng.integers(S // 2, S, B) if padded else np.full(B, S)
    mask = np.arange(S)[None, :] < lengths[:, None]          # (B, S) keys
    return q, k, v, g, mask[:, None, None, :]                # (B, 1, 1, S)


def alibi(H, mask):
    """ALiBi's causal float32 bias (B, H, S, S) of a (B, 1, 1, S) key mask's
    positions, as numpy."""
    pos = torch.from_numpy(np.maximum(np.cumsum(mask[:, 0, 0], 1) - 1, 0))
    return alibi_bias(H, pos, pos).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_gradients_match_jax(case):
    (B, H, Hkv, S, D), causal, window, padded, *kind = CASES[case]
    q, k, v, g, mask = inputs(B, H, Hkv, S, D, padded)
    bias = alibi(H, mask) if kind else None
    scale = D ** -0.5
    rows = visible(torch.from_numpy(mask[:, 0, 0]), S, causal, window
                   ).any(-1).expand(B, H, S).numpy()
    g = g * rows[..., None]

    def jax_loss(q, k, v):
        out = jax_fa.flash_attention(q, k, v, mask=jnp.asarray(mask),
                                     bias=None if bias is None
                                     else jnp.asarray(bias), scale=scale,
                                     causal=causal, window=window)
        return jnp.sum(out * g), out

    (_, out_j), grads_j = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                             has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out_t = flash_attention(qt, kt, vt, mask=torch.from_numpy(mask),
                            bias=None if bias is None
                            else torch.from_numpy(bias),
                            scale=scale, causal=causal, window=window)
    (out_t * torch.from_numpy(g)).sum().backward()

    err = np.abs(np.asarray(out_j) - out_t.detach().numpy())[rows]
    assert err.max() <= ATOL, err.max()
    for want, got in zip(grads_j, (qt.grad, kt.grad, vt.grad)):
        assert got.shape == want.shape
        assert np.abs(np.asarray(want) - got.numpy()).max() <= ATOL


def test_head_dims_pad_to_the_next_kernel_head_dim():
    """Every head dim up to 128 pads to the smallest of 32, 64 and 128 that
    holds it; past 128 it stays (the kernels refuse it)."""
    assert [padded_head_dim(D) for D in (16, 32, 48, 64, 80, 96, 100, 112,
                                         128, 160)] == \
        [32, 32, 64, 64, 128, 128, 128, 128, 128, 160]


def test_key_mask_is_any_over_queries():
    """A causal (B, 1, S, S) mask reduces to all keys kept; a padding mask
    to its key row."""
    S = 6
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool))[None, None]
    assert key_mask(causal.expand(2, 1, S, S), 2, S, S).all()
    pad = torch.arange(S)[None] < torch.tensor([[4], [6]])
    got = key_mask(pad[:, None, None, :], 2, S, S)
    assert torch.equal(got, pad)


def test_row_without_keys_gives_zero():
    """A row whose keys are all masked gives out = 0 and no gradient, where
    JAX's l == 0 guard leaves it finite."""
    q = torch.randn(1, 1, 4, 8, requires_grad=True)
    kv = torch.randn(1, 1, 4, 8, requires_grad=True)
    mask = torch.tensor([[True, False, False, False]])[:, None, None, :]
    out = flash_attention(q, kv, kv, mask=mask, causal=True, window=2)
    assert torch.equal(out[0, 0, 2:], torch.zeros(2, 8))
    out.sum().backward()
    assert torch.isfinite(q.grad).all() and torch.isfinite(kv.grad).all()
    assert torch.equal(q.grad[0, 0, 2:], torch.zeros(2, 8))


def test_launch_counts_name_the_float32_instances():
    """Every kernel's float32 instance counts apart under ``*_f32``, and
    reset_launch_counts zeroes them all."""
    from pasero_torch.ops import flash_attention as fa
    counts = fa.launch_counts()
    bf16 = [n for n in counts if not n.endswith("_f32")]
    assert sorted(n + "_f32" for n in bf16) == \
        sorted(n for n in counts if n.endswith("_f32"))
    assert {"flash_fwd_f32", "flash_fwd_bias_f32", "flash_fwd_t5_f32",
            "flash_bwd_dbias_f32", "flash_bwd_demb_f32",
            "flash_bwd_dq_t5_demb_f32"} <= set(counts)
    fa.flash_fwd.t5_launches_f32 += 1
    fa.flash_bwd_dq.t5_demb_launches_f32 += 1
    after = fa.launch_counts()
    assert after["flash_fwd_t5_f32"] == counts["flash_fwd_t5_f32"] + 1
    assert after["flash_bwd_dq_t5_demb_f32"] == \
        counts["flash_bwd_dq_t5_demb_f32"] + 1
    fa.reset_launch_counts()
    assert not any(fa.launch_counts().values())


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_table_gradient_comes_from_the_dq_kernel(dtype, monkeypatch):
    """In both types the kernels' backward takes T5's table gradient from
    the dq launch (``table_grad``) and calls no separate demb kernel, which
    refuses every call; a dense bias still takes the dbias kernel."""
    from pasero_torch.ops import flash_attention as fa
    calls = []

    def dq(*args, table_grad=False):
        calls.append(("dq", table_grad))
        grads = (torch.zeros(1), torch.zeros(1))
        return grads + (torch.ones(1),) if table_grad else grads

    def dkv(*args):
        calls.append(("dkv",))
        return torch.zeros(1), torch.zeros(1)

    def dbias(*args):
        calls.append(("dbias",))
        return torch.full((1,), 2.0)
    monkeypatch.setattr(fa, "flash_bwd_dq", dq)
    monkeypatch.setattr(fa, "flash_bwd_dkv", dkv)
    monkeypatch.setattr(fa, "flash_bwd_dbias", dbias)
    x = torch.zeros((1, 1, 4, 32), dtype=dtype)
    args = (x, x, x, None, x, None, x, 1.0, False, None)
    t5 = fa.T5Bias(torch.zeros(32, 1))
    assert fa._cuda_backward(*args, t5, True)[3].item() == 1.0
    assert calls == [("dq", True), ("dkv",)]
    calls.clear()
    assert fa._cuda_backward(*args, torch.zeros(1, 1, 4, 4), True)[3] \
        .item() == 2.0
    assert calls == [("dq", False), ("dkv",), ("dbias",)]
    with pytest.raises(TypeError, match="table_grad"):
        fa.flash_bwd_demb(*args[:4], t5, x, None, None, 1.0, False, None)
