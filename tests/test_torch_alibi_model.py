"""The port's ALiBi models against pasero_tpu's, in float32, on the same
inputs and flax-initialized weights.

A small Bloom-shaped (bloom_560m cut to 2 layers of width 64: ALiBi, a
LayerNorm after the embeddings, gelu_tanh, biases, no BOS) and MPT-shaped
(mpt_7b_65k cut the same way: ALiBi with max_bias 16, max_qkv 6, no
projection or norm biases) decoder-only model: logits and parameter
gradients with the ``xla`` and the ``flash`` attention, each against JAX's
``xla`` model (tests/test_torch_alibi.py holds the flash attention against
JAX's Pallas kernels in interpret mode); greedy and speculative decoding
through the KV cache, where the bias is built from the cache's running
step; an encoder-decoder model with ALiBi on both sides (the encoder's
half-head bias) in a full forward, against JAX's model with the same kernel
(the flash one's Pallas kernels in interpret mode), and in beam search; each
package's checkpoint loading into the other.

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

import pasero_tpu.ops.flash_attention as jax_fa
from pasero_tpu import checkpoints as jax_checkpoints
from pasero_tpu.config import get_model_config_cls as jax_config_cls
from pasero_tpu.decoding.search import beam_search as jax_beam_search
from pasero_tpu.decoding.search import sample_decode as jax_sample_decode
from pasero_tpu.decoding.search import \
    speculative_greedy_decode as jax_speculative
from pasero_tpu.models.transformer import Transformer as JaxTransformer
from pasero_torch import checkpoints
from pasero_torch.config import get_model_config_cls as torch_config_cls
from pasero_torch.decoding import search
from pasero_torch.models.attention import MultiheadAttention
from pasero_torch.models.transformer import Transformer
from pasero_torch.training import shift_targets

ATOL = 1e-4
VOCAB = 61
MAX_NEW = 10
SMALL = dict(decoder_layers=2, embed_dim=64, decoder_attention_heads=4,
             decoder_ffn_dim=128)
ARCHS = ["bloom_560m", "mpt_7b_65k"]


@pytest.fixture(autouse=True)
def interpret_mode():
    jax_fa.INTERPRET = True
    yield
    jax_fa.INTERPRET = False


def configs(arch, task="language_modeling", **overrides):
    out = []
    for cls in (jax_config_cls(arch), torch_config_cls(arch)):
        cfg = cls(strict=False, **overrides)
        cfg.set_defaults(task)
        cfg.dropout = 0.0
        out.append(cfg)
    return out


def flax_init(jmodel, seed, **inputs):
    params = jmodel.init(jax.random.PRNGKey(seed), **{
        k: jnp.zeros((1, 4), jnp.int32) for k in inputs})["params"]
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))


@functools.lru_cache(maxsize=None)
def jax_pair(arch, seed):
    """A flax-initialized small decoder-only JAX model (``xla`` attention)
    and its parameters, made once per arch and seed."""
    jcfg, _ = configs(arch, **SMALL)
    jmodel = JaxTransformer(jcfg, src_vocab_size=VOCAB, dtype=jnp.float32)
    return jcfg, jmodel, flax_init(jmodel, seed, decoder_input=None)


def pair(arch, kernel, seed=0):
    """A flax-initialized small decoder-only model and its port, whose
    attention takes ``kernel``."""
    jcfg, jmodel, params = jax_pair(arch, seed)
    _, tcfg = configs(arch, **SMALL)
    tmodel = Transformer(tcfg, VOCAB, dtype=torch.float32, kernel=kernel)
    tmodel.load_state_dict(checkpoints.params_to_state_dict(
        traverse_util.flatten_dict(params, sep="/")))
    return jcfg, jmodel, params, tmodel.eval()


def tokens(pad, seed=0, B=3, T=12):
    """Right-padded rows."""
    rng = np.random.default_rng(seed)
    dec = rng.integers(4, VOCAB, (B, T)).astype(np.int32)
    dec[1, 8:] = pad
    dec[2, 5:] = pad
    return dec


def test_configs_carry_the_archs_options():
    bloom, mpt = (configs(arch)[1] for arch in ARCHS)
    assert (bloom.decoder_positional_encoding, bloom.decoder_embed_norm,
            bloom.activation_fn, bloom.bos_idx) == ("alibi", True,
                                                    "gelu_tanh", -1)
    assert (mpt.decoder_positional_encoding, mpt.has_bias, mpt.norm_bias,
            mpt.max_qkv, mpt.alibi_max_bias) == ("alibi", False, False, 6.0,
                                                 16)


@functools.lru_cache(maxsize=None)
def jax_logits_and_grads(arch):
    """JAX's logits, summed loss and parameter gradients of ``tokens`` (the
    ``xla`` attention, jitted once per arch; both of the port's kernels are
    held against them)."""
    jcfg, jmodel, params = jax_pair(arch, 0)
    dec = tokens(jcfg.padding_idx)
    targets = np.asarray(shift_targets(torch.from_numpy(dec),
                                       jcfg.padding_idx))

    def loss_fn(p):
        return jmodel.apply({"params": p}, decoder_input=jnp.asarray(dec),
                            targets=jnp.asarray(targets))["loss_sum"]

    logits = jax.jit(lambda p: jmodel.apply(
        {"params": p}, decoder_input=jnp.asarray(dec))["logits"])(params)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return dec, targets, np.asarray(logits), float(loss), \
        jax_checkpoints.flatten_params(grads)


@pytest.mark.parametrize("kernel", ["xla", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_gradients_match_jax(arch, kernel):
    dec, targets, want_logits, loss_j, want = jax_logits_and_grads(arch)
    tmodel = pair(arch, kernel)[3]
    with torch.no_grad():
        got = tmodel(None, torch.from_numpy(dec))["logits"]
    assert np.abs(want_logits - got.numpy()).max() <= ATOL
    tmodel.train()
    loss_t = tmodel(None, torch.from_numpy(dec),
                    targets=torch.from_numpy(targets))["loss_sum"]
    loss_t.backward()
    assert loss_t.item() == pytest.approx(loss_j, rel=1e-5)
    got = checkpoints.state_dict_to_params(
        {k: p.grad for k, p in tmodel.named_parameters()})
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        atol = 1e-5 + 1e-4 * np.abs(value).max()
        np.testing.assert_allclose(got[key], value, rtol=0, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_load_across_packages(arch, tmp_path):
    """A JAX checkpoint loads into the port and the port's into JAX with no
    missing or unexpected keys (ALiBi adds no parameter)."""
    _, _, params, tmodel = pair(arch, "xla", seed=2)
    path = str(tmp_path / "jax.npz")
    flat = jax_checkpoints.flatten_params(params)
    checkpoints.save_flat(path, flat)
    port = Transformer(tmodel.cfg, VOCAB, dtype=torch.float32)
    checkpoints.load_into(port, path)
    assert sorted(checkpoints.state_dict_to_params(port.state_dict())) == \
        sorted(flat)
    back = str(tmp_path / "port.npz")
    checkpoints.save_flat(back, checkpoints.state_dict_to_params(
        port.state_dict()))
    _, missing, unexpected = jax_checkpoints.load_params(back, params)
    assert not missing and not unexpected


@pytest.mark.parametrize("arch", ["bloom_560m", "mpt_7b"])
def test_attention_builds_at_full_width(arch):
    """The full configs' self-attention (on the meta device: no memory)."""
    _, cfg = configs(arch)
    with torch.device("meta"):
        attn = MultiheadAttention(cfg.embed_dim, cfg.decoder_attention_heads,
                                  use_bias=cfg.has_bias, causal=True,
                                  max_qkv=cfg.max_qkv)
    assert attn.head_dim in (64, 128)


# -- decoding through the cache ------------------------------------------------

def prompts(pad, seed=3, P=16):
    """Left-padded copy-heavy rows."""
    rng = np.random.default_rng(seed)
    phrase = list(rng.integers(4, VOCAB, 5))
    rows = [phrase * 3, phrase * 2 + [7], list(rng.integers(4, VOCAB, 7))]
    prompt = np.full((3, P), pad, np.int32)
    for i, row in enumerate(rows):
        prompt[i, P - len(row):] = row
    return prompt, prompt != pad


def run_jax(jcfg, params, prompt, mask, fn, extra_slots=0, **kw):
    model = JaxTransformer(jcfg, src_vocab_size=VOCAB, dtype=jnp.float32,
                           self_cache_len=prompt.shape[1] + MAX_NEW
                           + extra_slots)
    run = jax.jit(lambda p, pr, pm: fn(model, p, pr, pm, max_new=MAX_NEW,
                                       eos_idx=jcfg.eos_idx,
                                       pad_idx=jcfg.padding_idx, **kw))
    out = run(params, jnp.asarray(prompt), jnp.asarray(mask))
    return {k: np.asarray(v) for k, v in out.items()}


def run_port(tmodel, prompt, mask, fn, **kw):
    with torch.inference_mode():
        out = fn(tmodel, torch.from_numpy(prompt).long(),
                 torch.from_numpy(mask), max_new=MAX_NEW,
                 eos_idx=tmodel.cfg.eos_idx, pad_idx=tmodel.cfg.padding_idx,
                 **kw)
    calls = out.pop("model_calls")
    return {k: v.numpy() for k, v in out.items()}, calls


def same_output(got, want):
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert np.abs(got["scores"] - want["scores"]).max() <= ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_and_speculative_match_jax(arch):
    """Greedy decoding and speculative decoding (drafts of 4, the cache and
    its ALiBi step rewound after each partly accepted chunk) give JAX's
    tokens, and speculative gives greedy's."""
    jcfg, _, params, tmodel = pair(arch, "xla", seed=3)
    prompt, mask = prompts(jcfg.padding_idx)
    want = run_jax(jcfg, params, prompt, mask, jax_sample_decode,
                   greedy=True)
    greedy, greedy_calls = run_port(tmodel, prompt, mask,
                                    search.sample_decode, greedy=True)
    same_output(greedy, want)
    K = 4
    want = run_jax(jcfg, params, prompt, mask, jax_speculative,
                   extra_slots=K + 1, draft_len=K)
    spec, calls = run_port(tmodel, prompt, mask,
                           search.speculative_greedy_decode, draft_len=K)
    same_output(spec, want)
    same_output(spec, greedy)
    assert calls == int(want["model_calls"]) and calls < greedy_calls


# -- encoder-decoder -------------------------------------------------------------

ENC_DEC = dict(encoder_layers=2, decoder_layers=2, embed_dim=64,
               encoder_ffn_dim=128, decoder_ffn_dim=128,
               encoder_attention_heads=4, decoder_attention_heads=4,
               encoder_positional_encoding="alibi",
               decoder_positional_encoding="alibi", encoder_prenorm=True,
               decoder_prenorm=True)


@functools.lru_cache(maxsize=None)
def jax_enc_dec():
    """A flax-initialized small encoder-decoder JAX model's config and
    parameters."""
    jcfg, _ = configs("transformer", "translation", **ENC_DEC)
    jmodel = JaxTransformer(jcfg, src_vocab_size=VOCAB, dtype=jnp.float32)
    return jcfg, flax_init(jmodel, 4, src_tokens=None, decoder_input=None)


def enc_dec_pair(kernel):
    """JAX's encoder-decoder model's config and parameters, and its port,
    whose attention takes ``kernel``."""
    jcfg, params = jax_enc_dec()
    _, tcfg = configs("transformer", "translation", **ENC_DEC)
    tmodel = Transformer(tcfg, VOCAB, dtype=torch.float32, kernel=kernel)
    tmodel.load_state_dict(checkpoints.params_to_state_dict(
        traverse_util.flatten_dict(params, sep="/")))
    return jcfg, params, tmodel.eval()


@pytest.mark.parametrize("kernel", ["xla", "flash"])
def test_encoder_decoder_logits_match_jax(kernel):
    """Against JAX's model with the same kernel: the two differ on the
    encoder's rows of only -1e9 entries, whose softmax the flash kernels
    take over the present keys and the ``xla`` attention over all keys
    (its mask fills -1e9 as well)."""
    jcfg, params, tmodel = enc_dec_pair(kernel)
    src = tokens(jcfg.padding_idx, seed=5, T=14)
    dec = tokens(jcfg.padding_idx, seed=6, T=9)
    jmodel = JaxTransformer(jcfg, src_vocab_size=VOCAB, dtype=jnp.float32,
                            kernel=kernel)
    want = jax.jit(lambda p: jmodel.apply(
        {"params": p}, src_tokens=jnp.asarray(src),
        decoder_input=jnp.asarray(dec))["logits"])(params)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(src), torch.from_numpy(dec))["logits"]
    assert np.abs(np.asarray(want) - got.numpy()).max() <= ATOL


def test_encoder_decoder_beam_search_matches_jax():
    """Beam 4 through lineage attention with the decoder's ALiBi bias over
    the cache slots."""
    jcfg, params, tmodel = enc_dec_pair("xla")
    src = tokens(jcfg.padding_idx, seed=7, T=10)
    src_mask = src != jcfg.padding_idx
    prompt = np.full((3, 1), jcfg.eos_idx, np.int32)
    common = dict(max_new=MAX_NEW, eos_idx=jcfg.eos_idx,
                  pad_idx=jcfg.padding_idx, beam_size=4)
    jmodel = JaxTransformer(jcfg, src_vocab_size=VOCAB, dtype=jnp.float32,
                            self_cache_len=1 + MAX_NEW, cross_cache_len=10)

    @jax.jit
    def run(params, src, src_mask, prompt):
        enc, enc_mask = jmodel.apply({"params": params}, src,
                                     src_mask=src_mask,
                                     method=JaxTransformer.encode)
        return jax_beam_search(jmodel, params, prompt, prompt > -1,
                               encoder_out=enc, encoder_mask=enc_mask,
                               **common)

    want = {k: np.asarray(v) for k, v in run(
        params, jnp.asarray(src), jnp.asarray(src_mask),
        jnp.asarray(prompt)).items()}
    with torch.inference_mode():
        enc, enc_mask = tmodel.encode(torch.from_numpy(src).long(),
                                      torch.from_numpy(src_mask))
        prompt_t = torch.from_numpy(prompt).long()
        got = search.beam_search(tmodel, prompt_t, prompt_t > -1,
                                 encoder_out=enc, encoder_mask=enc_mask,
                                 **common)
    got = {k: v.numpy() for k, v in got.items() if k != "model_calls"}
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert np.abs(got["scores"] - want["scores"]).max() <= ATOL
