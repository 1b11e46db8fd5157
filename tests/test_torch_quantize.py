"""The port's weight-only int8 quantization against pasero_tpu's.

``quantize`` gives JAX's int8 values and scales bit for bit (after the
transpose of a flax (in, out) kernel into the port's (out, in) layout);
``quantize_params`` picks the same weights, by the same name rule and size
floor, on deen-mini2 and on a small Llama with an untied head, and
``quantized_bytes`` counts the same bytes. The products' plain versions
against JAX's Pallas kernel (in interpret mode on the CPU): float32 within
1e-5 of the sum of the terms' magnitudes, sum |x_k| |w_k| (the same float32
products, summed in another order; relative to the result itself an output
near zero by cancellation would be held to rounding it cannot keep),
bfloat16 outputs within one bfloat16 step (2^-7 relative) of each other:
two float32 sums that differ in their last bits may round to neighbours.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pasero_tpu import checkpoints as jax_checkpoints
from pasero_tpu.ops import quantize as jq
from pasero_torch.decoding.generator import TextGenerator
from pasero_torch.ops import quantize as tq

from test_torch_decoder_only import pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "models", "deen-mini2")


def test_quantize_is_bitwise_jax():
    rng = np.random.default_rng(0)
    # columns of wildly different magnitudes, a zero column (the 1e-8 floor)
    # and values that round half way
    w = rng.normal(size=(96, 40)).astype(np.float32)
    w *= np.logspace(-3, 3, 40)[None, :].astype(np.float32)
    w[:, 3] = 0.0
    w[:4, 5] = [127.0, 0.5, -0.5, 1.5]
    want = jq.quantize(jnp.asarray(w), axis=0)        # flax (in, out) kernel
    got = tq.quantize(torch.from_numpy(w.T.copy()))    # the port's (out, in)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q).T)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale)[0])
    table = jq.quantize(jnp.asarray(w), axis=1)        # a (vocab, embed) table
    got = tq.quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(table.q))
    np.testing.assert_array_equal(got.scale.numpy(),
                                  np.asarray(table.scale)[:, 0])
    np.testing.assert_array_equal(tq.dequantize(got).numpy(),
                                  np.asarray(jq.dequantize(table)))


def _jax_quantized(params, min_size):
    """{flax module path: QTensor} of JAX's quantize_params, and its count
    and byte counts."""
    new, count = jq.quantize_params(params, min_size=min_size)
    flat = traverse_util.flatten_dict(new, sep="/")
    chosen = {k.rsplit("/", 1)[0]: v for k, v in flat.items()
              if isinstance(v, jq.QTensor)}
    return chosen, count, jq.quantized_bytes(new)


def _port_quantized(model, min_size):
    count = tq.quantize_params(model, min_size=min_size)
    chosen = {}
    for name, module in model.named_modules():
        for attr in ("weight", "embedding"):
            value = module.__dict__.get(attr)
            if isinstance(value, tq.QTensor):
                chosen[name.replace(".", "/")] = value
    return chosen, count, tq.quantized_bytes(model)


def _models(which):
    """(flax params, the port's float32 model) on the same weights."""
    if which == "deen-mini2":
        gen = TextGenerator.build(MODEL, device="cpu", dtype="float32")
        params = jax_checkpoints.unflatten_params(
            jax_checkpoints.load_flat(gen.cfg.ckpt))
        return params, gen.model
    _, params, model = pair("xla", decoder_layers=1, embed_dim=256,
                            decoder_ffn_dim=512)
    return params, model


@pytest.mark.parametrize("which", ["deen-mini2", "llama"])
@pytest.mark.parametrize("min_size", [0, None])
def test_quantize_params_picks_jax_weights(which, min_size, monkeypatch):
    """The same modules, count, int8 values, scales and bytes, at
    min_size 0 and at the default floor (1 << 16, or the environment's)."""
    monkeypatch.delenv("PASERO_QUANTIZE_MIN_SIZE", raising=False)
    params, model = _models(which)
    want, want_n, want_bytes = _jax_quantized(params, min_size)
    got, got_n, got_bytes = _port_quantized(model, min_size)
    assert got_n == want_n == len(want) > 0
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        q, scale = np.asarray(t.q), np.asarray(t.scale)
        if scale.shape[0] == 1:         # a column-quantized (in, out) kernel
            q, scale = q.T, scale.T
        np.testing.assert_array_equal(got[name].q.numpy(), q, err_msg=name)
        np.testing.assert_array_equal(got[name].scale.numpy(), scale[:, 0],
                                      err_msg=name)
    assert got_bytes == tuple(want_bytes)


def assert_close_to_sum(got, want, x, w, rtol=1e-5):
    """|got - want| <= rtol * (|x| . |w|), element by element."""
    limit = rtol * (np.abs(x) @ np.abs(w))
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert (err <= limit).all(), (err / limit).max()


def _product_inputs(M, K, N, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)      # flax (in, out)
    return x, w


@pytest.mark.parametrize("M,K,N", [
    (8, 512, 1024),     # decode rows
    (3, 100, 2192),     # ragged K and N (deen-mini2's vocabulary)
    (300, 256, 96),     # ragged rows
])
def test_int8_matmul_plain_matches_jax(M, K, N):
    x, w = _product_inputs(M, K, N)
    want = np.asarray(jq.int8_matmul(jnp.asarray(x),
                                     jq.quantize(jnp.asarray(w), axis=0)))
    t = tq.quantize(torch.from_numpy(w.T.copy()))
    got = tq.int8_matmul(torch.from_numpy(x), t)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    assert_close_to_sum(got.numpy(), want, x,
                        tq.dequantize(t).numpy().T)
    # the tied head's orientation: a row-quantized (V, E) table
    table = w.T.copy()
    want = np.asarray(jq.int8_matmul_t(jnp.asarray(x),
                                       jq.quantize(jnp.asarray(table), axis=1),
                                       out_dtype=jnp.float32))
    t = tq.quantize(torch.from_numpy(table))
    got = tq.int8_matmul_t(torch.from_numpy(x), t, out_dtype=torch.float32)
    assert_close_to_sum(got.numpy(), want, x, tq.dequantize(t).numpy().T)


def test_int8_matmul_bf16_and_leading_dims():
    """bfloat16 x and output, leading dims kept: one bf16 rounding of
    float32 sums that agree to their last bits, so within one bf16 step."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 256)).astype(np.float32)
    w = rng.normal(size=(256, 512)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jq.int8_matmul(xb, jq.quantize(jnp.asarray(w), axis=0)),
                      np.float32)
    got = tq.int8_matmul(torch.from_numpy(np.asarray(xb, np.float32)).bfloat16(),
                         tq.quantize(torch.from_numpy(w.T.copy())))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 5, 512)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


def test_embedding_lookup_matches_jax():
    rng = np.random.default_rng(5)
    table = rng.normal(size=(64, 32)).astype(np.float32)
    ids = np.array([[0, 5, 63], [7, 7, 1]])
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jq.embedding_lookup(jq.quantize(jnp.asarray(table), axis=1),
                                   jnp.asarray(ids), jdt)
        got = tq.embedding_lookup(tq.quantize(torch.from_numpy(table)),
                                  torch.from_numpy(ids), tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_int8_kernel_wrapper_refuses_what_it_does_not_take():
    """On a non-CPU tensor the wrapper launches or raises: a float32 x, a K
    that is not a multiple of 16 or a device without a kernel raise before
    any launch (no fallback to the plain version)."""
    t = tq.quantize(torch.randn(32, 40))
    before = tq.int8_matmul.launches
    with pytest.raises(TypeError):
        tq._int8_matmul_cuda(torch.zeros(4, 40), t.q, t.scale, torch.float32)
    with pytest.raises(ValueError):
        tq._int8_matmul_cuda(torch.zeros(4, 40, dtype=torch.bfloat16), t.q,
                             t.scale, torch.bfloat16)
    with pytest.raises(ValueError):
        tq.int8_matmul(torch.zeros(4, 40, device="meta"), t)
    assert tq.int8_matmul.launches == before


def test_bench_int8_weights_are_llama_1b_decode_weights():
    """The int8 timing script's decoder call (pasero_torch/scripts/
    bench_int8.py) sums llama_1b's Linear weights as quantize_params picks
    them: per layer q, k, v, o, gate, up and down, and the untied head over
    bench_decode's 32000-word vocabulary, each as (K, N)."""
    from pasero_torch.config import get_model_cls
    from pasero_torch.scripts.bench_decode import LMWorkload
    from pasero_torch.scripts.bench_int8 import LAYERS, LLAMA_1B_WEIGHTS
    cfg = get_model_cls("llama_1b")[1]()
    E, F, L = cfg.embed_dim, cfg.decoder_ffn_dim, cfg.decoder_layers
    kv = cfg.attention_heads_kv * E // cfg.decoder_attention_heads
    assert not cfg.tied_output_projection and LAYERS == L
    assert LLAMA_1B_WEIGHTS == {(E, E): 2 * L, (E, kv): 2 * L, (E, F): 2 * L,
                                (F, E): L, (E, LMWorkload.VOCAB): 1}
    assert min(K * N for K, N in LLAMA_1B_WEIGHTS) >= 1 << 16
