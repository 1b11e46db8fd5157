"""The port's T5 model against pasero_tpu's, in float32, on the same inputs
and flax-initialized weights.

A small T5 (t5_base cut to 2 + 2 layers of width 64, 4 heads, GeGLU FFN
128: T5 buckets on both sides, pre-norm RMSNorm, no biases, no attention
scaling, the inf guard, an untied head): logits and parameter gradients,
both tables' among them, with the ``xla`` and the ``flash`` attention, each
against JAX's ``xla`` model (the flash kernels' own parity with JAX's
in-kernel T5 path is tests/test_torch_t5.py's); greedy and beam-4 decoding
through the KV cache with the decoder's bias materialized over the cache
slots (lineage beams); checkpoints across the packages, the tables'
``rel_embedding`` leaves kept as they are.

Tolerances: max-abs 1e-4 on logits; each parameter gradient within 1e-5 +
1e-4 of its largest magnitude (float32, summation order only); tokens and
lengths identical, scores within 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import traverse_util

from pasero_tpu import checkpoints as jax_checkpoints
from pasero_tpu.config import get_model_config_cls as jax_config_cls
from pasero_tpu.decoding.search import beam_search as jax_beam_search
from pasero_tpu.decoding.search import sample_decode as jax_sample_decode
from pasero_tpu.models.transformer import Transformer as JaxTransformer
from pasero_torch import checkpoints
from pasero_torch.config import get_model_config_cls as torch_config_cls
from pasero_torch.decoding import search
from pasero_torch.models.attention import MultiheadAttention
from pasero_torch.models.positional import T5RelativeBias
from pasero_torch.models.transformer import Transformer
from pasero_torch.training import shift_targets

ATOL = 1e-4
VOCAB = 61
MAX_NEW = 10
SMALL = dict(encoder_layers=2, decoder_layers=2, embed_dim=64,
             encoder_ffn_dim=128, decoder_ffn_dim=128,
             encoder_attention_heads=4, decoder_attention_heads=4)
TABLES = ("encoder/t5_bias/rel_embedding", "decoder/t5_bias/rel_embedding")


def configs(**overrides):
    out = []
    for cls in (jax_config_cls("t5_base"), torch_config_cls("t5_base")):
        cfg = cls(strict=False, **overrides)
        cfg.set_defaults("translation")
        cfg.dropout = 0.0
        out.append(cfg)
    return out


@functools.lru_cache(maxsize=None)
def jax_pair(seed=0):
    """A flax-initialized small JAX T5 (``xla`` attention) and its
    parameters, made once."""
    jcfg, _ = configs(**SMALL)
    jmodel = JaxTransformer(jcfg, src_vocab_size=VOCAB, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(seed), **{
        k: jnp.zeros((1, 4), jnp.int32)
        for k in ("src_tokens", "decoder_input")})["params"]
    params = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))
    return jcfg, jmodel, params


def port(kernel):
    """The port of jax_pair's model, whose attention takes ``kernel``."""
    jcfg, _, params = jax_pair()
    _, tcfg = configs(**SMALL)
    tmodel = Transformer(tcfg, VOCAB, dtype=torch.float32, kernel=kernel)
    tmodel.load_state_dict(checkpoints.params_to_state_dict(
        traverse_util.flatten_dict(params, sep="/")))
    return tmodel.eval()


def tokens(pad, seed, B=3, T=12):
    """Right-padded rows."""
    rng = np.random.default_rng(seed)
    out = rng.integers(4, VOCAB, (B, T)).astype(np.int32)
    out[1, T * 2 // 3:] = pad
    out[2, T // 2:] = pad
    return out


def test_config_carries_the_archs_options():
    cfg = configs()[1]
    assert (cfg.encoder_positional_encoding, cfg.decoder_positional_encoding,
            cfg.activation_fn, cfg.rms_norm, cfg.has_bias, cfg.scale_attn,
            cfg.check_inf, cfg.tied_output_projection) == \
        ("t5", "t5", "geglu", True, False, False, True, False)
    model = port("xla")
    assert model.encoder.t5_bias.bidirectional
    assert not model.decoder.t5_bias.bidirectional


@functools.lru_cache(maxsize=None)
def jax_logits_and_grads():
    """JAX's logits, summed loss and parameter gradients (the ``xla``
    attention, jitted once; both of the port's kernels are held against
    them)."""
    jcfg, jmodel, params = jax_pair()
    src = tokens(jcfg.padding_idx, seed=1, T=14)
    dec = tokens(jcfg.padding_idx, seed=2, T=9)
    targets = np.asarray(shift_targets(torch.from_numpy(dec),
                                       jcfg.padding_idx))
    inputs = dict(src_tokens=jnp.asarray(src), decoder_input=jnp.asarray(dec))

    def loss_fn(p):
        return jmodel.apply({"params": p}, targets=jnp.asarray(targets),
                            **inputs)["loss_sum"]

    logits = jax.jit(lambda p: jmodel.apply({"params": p}, **inputs)[
        "logits"])(params)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return src, dec, targets, np.asarray(logits), float(loss), \
        jax_checkpoints.flatten_params(grads)


@pytest.mark.parametrize("kernel", ["xla", "flash"])
def test_logits_and_gradients_match_jax(kernel):
    src, dec, targets, want_logits, loss_j, want = jax_logits_and_grads()
    tmodel = port(kernel)
    src_t, dec_t = torch.from_numpy(src), torch.from_numpy(dec)
    with torch.no_grad():
        got = tmodel(src_t, dec_t)["logits"]
    assert np.abs(want_logits - got.numpy()).max() <= ATOL
    tmodel.train()
    loss_t = tmodel(src_t, dec_t, targets=torch.from_numpy(targets))[
        "loss_sum"]
    loss_t.backward()
    assert loss_t.item() == pytest.approx(loss_j, rel=1e-5)
    got = checkpoints.state_dict_to_params(
        {k: p.grad for k, p in tmodel.named_parameters()})
    assert sorted(got) == sorted(want) and set(TABLES) <= set(got)
    for key, value in want.items():
        atol = 1e-5 + 1e-4 * np.abs(value).max()
        np.testing.assert_allclose(got[key], value, rtol=0, atol=atol,
                                   err_msg=key)
    # the encoder's table learns; JAX's unidirectional buckets give every
    # visible key of a causal row bucket 0, a constant per row, so the
    # decoder's gradient is rounding noise (ROADMAP.md C.10)
    assert np.abs(got[TABLES[0]]).max() > 1e-3
    assert np.abs(got[TABLES[1]]).max() < 1e-4


def test_checkpoints_load_across_packages(tmp_path):
    """A JAX checkpoint loads into the port and the port's into JAX with no
    missing or unexpected keys; the tables come back unchanged, (32, H) and
    not transposed."""
    _, _, params = jax_pair()
    tmodel = port("xla")
    path = str(tmp_path / "jax.npz")
    flat = jax_checkpoints.flatten_params(params)
    checkpoints.save_flat(path, flat)
    fresh = Transformer(tmodel.cfg, VOCAB, dtype=torch.float32)
    checkpoints.load_into(fresh, path)
    back = checkpoints.state_dict_to_params(fresh.state_dict())
    assert sorted(back) == sorted(flat)
    for key in TABLES:
        assert back[key].shape == (32, 4)
        np.testing.assert_array_equal(back[key], flat[key])
    out = str(tmp_path / "port.npz")
    checkpoints.save_flat(out, back)
    _, missing, unexpected = jax_checkpoints.load_params(out, params)
    assert not missing and not unexpected


def test_t5_attention_builds_at_full_width():
    """t5_base's self-attention and tables (on the meta device)."""
    cfg = configs()[1]
    with torch.device("meta"):
        attn = MultiheadAttention(cfg.embed_dim, cfg.encoder_attention_heads,
                                  use_bias=cfg.has_bias,
                                  scale_attn=cfg.scale_attn)
        table = T5RelativeBias(cfg.encoder_attention_heads, True)
    assert attn.head_dim == 64 and attn.scale == 1.0
    assert tuple(table.rel_embedding.shape) == (32, 12)


# -- decoding through the cache ------------------------------------------------

@pytest.mark.parametrize("beam_size", [1, 4], ids=["greedy", "beam4"])
def test_decoding_matches_jax(beam_size):
    """Greedy (sample_decode) and beam 4 (lineage attention) with the
    decoder's T5 bias over the cache slots, from the running cache index."""
    jcfg, _, params = jax_pair()
    tmodel = port("xla")
    src = tokens(jcfg.padding_idx, seed=7, T=10)
    src_mask = src != jcfg.padding_idx
    prompt = np.full((3, 1), jcfg.eos_idx, np.int32)
    common = dict(max_new=MAX_NEW, eos_idx=jcfg.eos_idx,
                  pad_idx=jcfg.padding_idx)
    if beam_size > 1:
        jfn, tfn, common["beam_size"] = jax_beam_search, search.beam_search, \
            beam_size
    else:
        jfn, tfn, common["greedy"] = jax_sample_decode, search.sample_decode, \
            True
    jmodel = JaxTransformer(jcfg, src_vocab_size=VOCAB, dtype=jnp.float32,
                            self_cache_len=1 + MAX_NEW, cross_cache_len=10)

    @jax.jit
    def run(params, src, src_mask, prompt):
        enc, enc_mask = jmodel.apply({"params": params}, src,
                                     src_mask=src_mask,
                                     method=JaxTransformer.encode)
        return jfn(jmodel, params, prompt, prompt > -1, encoder_out=enc,
                   encoder_mask=enc_mask, **common)

    want = {k: np.asarray(v) for k, v in run(
        params, jnp.asarray(src), jnp.asarray(src_mask),
        jnp.asarray(prompt)).items()}
    with torch.inference_mode():
        enc, enc_mask = tmodel.encode(torch.from_numpy(src).long(),
                                      torch.from_numpy(src_mask))
        prompt_t = torch.from_numpy(prompt).long()
        got = tfn(tmodel, prompt_t, prompt_t > -1, encoder_out=enc,
                  encoder_mask=enc_mask, **common)
    got = {k: v.numpy() for k, v in got.items() if k != "model_calls"}
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert np.abs(got["scores"] - want["scores"]).max() <= ATOL
