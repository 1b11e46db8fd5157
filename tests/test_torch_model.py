"""The port's Transformer against pasero_tpu's, in float32, on the same weights.

Tolerance: max-abs 1e-4 on logits and activations — both sides compute in
float32 and differ only in summation order."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import traverse_util

from pasero_tpu.config import get_model_config_cls as jax_config_cls
from pasero_tpu.models.attention import lineage_attention as jax_lineage
from pasero_tpu.models.transformer import Transformer as JaxTransformer
from pasero_torch import checkpoints
from pasero_torch.config import get_model_config_cls as torch_config_cls
from pasero_torch.models.attention import lineage_attention
from pasero_torch.models.transformer import Transformer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI2 = os.path.join(ROOT, "models", "deen-mini2")
ATOL = 1e-4

SMALL = dict(encoder_layers=2, decoder_layers=2, embed_dim=64,
             encoder_ffn_dim=128, decoder_ffn_dim=128,
             encoder_attention_heads=4, decoder_attention_heads=4)
VARIANTS = {
    "post_sinusoidal_tied_relu": {},
    "pre_learned_untied_gelu": dict(
        encoder_prenorm=True, decoder_prenorm=True,
        encoder_positional_encoding="learned",
        decoder_positional_encoding="learned",
        tied_output_projection=False, shared_embeddings=False,
        activation_fn="gelu"),
}


def configs(arch="transformer", **overrides):
    out = []
    for cls in (jax_config_cls(arch), torch_config_cls(arch)):
        cfg = cls(strict=False, **overrides)
        cfg.set_defaults("translation")
        cfg.dropout = 0.0
        out.append(cfg)
    return out


def small_pair(variant, vocab=97, seed=0):
    """A flax-initialized small model and its port, same weights."""
    jcfg, tcfg = configs(**SMALL, **VARIANTS[variant])
    jmodel = JaxTransformer(jcfg, src_vocab_size=vocab, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         src_tokens=jnp.zeros((1, 4), jnp.int32),
                         decoder_input=jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))
    flat = traverse_util.flatten_dict(params, sep="/")
    tmodel = Transformer(tcfg, vocab, dtype=torch.float32)
    tmodel.load_state_dict(checkpoints.params_to_state_dict(flat))
    return jcfg, jmodel, params, tmodel.eval(), vocab


def mini2_pair():
    with open(os.path.join(MINI2, "config.json")) as f:
        data = json.load(f)
    arch = data.pop("arch")
    jcfg, tcfg = configs(arch, **data)
    flat = checkpoints.load_flat(os.path.join(MINI2, "model_1000.npz"))
    vocab = flat["shared_embed/embedding"].shape[0]
    jmodel = JaxTransformer(jcfg, src_vocab_size=vocab, dtype=jnp.float32)
    tmodel = Transformer(tcfg, vocab, dtype=torch.float32)
    tmodel.load_state_dict(checkpoints.params_to_state_dict(flat))
    return (jcfg, jmodel, traverse_util.unflatten_dict(flat, sep="/"),
            tmodel.eval(), vocab)


PAIRS = {"mini2": mini2_pair,
         **{v: (lambda v=v: small_pair(v)) for v in VARIANTS}}


def batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(4, vocab, (3, 11))
    src[1, 7:] = 1                      # right-padded source rows
    dec = rng.integers(4, vocab, (3, 9))
    dec[:, 0] = 2
    dec[2, 5:] = 1
    return src, dec


def close(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= ATOL, np.abs(a - b).max()


@pytest.mark.parametrize("pair", list(PAIRS))
def test_encoder_and_full_forward(pair):
    jcfg, jmodel, params, tmodel, vocab = PAIRS[pair]()
    src, dec = batch(vocab)
    enc_j, mask_j = jmodel.apply({"params": params}, jnp.asarray(src),
                                 method=JaxTransformer.encode)
    logits_j = jmodel.apply({"params": params}, src_tokens=jnp.asarray(src),
                            decoder_input=jnp.asarray(dec))["logits"]
    with torch.no_grad():
        enc_t, mask_t = tmodel.encode(torch.from_numpy(src))
        logits_t = tmodel(torch.from_numpy(src),
                          torch.from_numpy(dec))["logits"]
    close(enc_j, enc_t)
    np.testing.assert_array_equal(np.asarray(mask_j), mask_t.numpy())
    close(logits_j, logits_t)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_decode_step_left_padded_prompt_and_cached_steps(pair):
    jcfg, _, params, tmodel, vocab = PAIRS[pair]()
    src, _ = batch(vocab, seed=1)
    B, P, steps = src.shape[0], 6, 5
    rng = np.random.default_rng(2)
    prompt_len = np.array([1, 4, 6])
    prompt = np.full((B, P), 1)
    prompt_mask = np.zeros((B, P), bool)
    for b, n in enumerate(prompt_len):
        prompt[b, P - n:] = rng.integers(4, vocab, n)
        prompt_mask[b, P - n:] = True
    positions = np.arange(P)[None] - (P - prompt_len)[:, None]
    pad_valid = np.concatenate([prompt_mask, np.ones((B, steps), bool)], 1)
    tokens = rng.integers(4, vocab, (steps, B, 1))

    jmodel = JaxTransformer(jcfg, src_vocab_size=vocab, dtype=jnp.float32,
                            self_cache_len=P + steps,
                            cross_cache_len=src.shape[1])
    enc, enc_mask = jmodel.apply({"params": params}, jnp.asarray(src),
                                 method=JaxTransformer.encode)
    common = dict(encoder_out=enc, encoder_mask=enc_mask,
                  self_kv_mask=jnp.asarray(pad_valid),
                  method=JaxTransformer.decode_step, mutable=["cache"])
    logits, mut = jmodel.apply({"params": params}, jnp.asarray(prompt),
                               positions=jnp.asarray(positions),
                               tgt_mask=jnp.ones((B, P), bool), **common)
    jax_logits = [np.asarray(logits[:, -1])]
    for s in range(steps):
        logits, mut = jmodel.apply(
            {"params": params, "cache": mut["cache"]}, jnp.asarray(tokens[s]),
            positions=jnp.asarray(prompt_len + s)[:, None],
            tgt_mask=jnp.ones((B, 1), bool), **common)
        jax_logits.append(np.asarray(logits[:, -1]))

    with torch.no_grad():
        enc_t, enc_mask_t = tmodel.encode(torch.from_numpy(src))
        cache = tmodel.make_cache(B, P + steps)
        kv = torch.from_numpy(pad_valid)
        logits = tmodel.decode_step(
            torch.from_numpy(prompt), cache, encoder_out=enc_t,
            encoder_mask=enc_mask_t, positions=torch.from_numpy(positions),
            tgt_mask=torch.ones(B, P, dtype=torch.bool), self_kv_mask=kv)
        torch_logits = [logits[:, -1]]
        for s in range(steps):
            logits = tmodel.decode_step(
                torch.from_numpy(tokens[s]), cache, encoder_mask=enc_mask_t,
                positions=torch.from_numpy(prompt_len + s)[:, None],
                tgt_mask=torch.ones(B, 1, dtype=torch.bool), self_kv_mask=kv)
            torch_logits.append(logits[:, -1])
    assert cache[0][0].index == P + steps
    for want, got in zip(jax_logits, torch_logits):
        close(want, got)


@pytest.mark.parametrize("seed", [0, 1])
def test_lineage_attention(seed):
    rng = np.random.default_rng(seed)
    B, K, H, L, D = 2, 3, 4, 7, 8
    q = rng.normal(size=(B * K, H, 1, D)).astype(np.float32)
    k = rng.normal(size=(B * K, H, L, D)).astype(np.float32)
    v = rng.normal(size=(B * K, H, L, D)).astype(np.float32)
    lineage = rng.integers(0, K, (B, K, L)).astype(np.int32)
    mask = rng.random((B * K, 1, 1, L)) > 0.2
    mask[..., -1] = True
    want = jax_lineage(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(lineage), mask=jnp.asarray(mask),
                       scale=D ** -0.5)
    got = lineage_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(lineage),
                            mask=torch.from_numpy(mask), scale=D ** -0.5)
    close(want, got)
