"""The port's beam search and greedy decoding against pasero_tpu's, in
float32 on deen-mini2, over 16 lines of examples/deen-mini/data/test.de.

Tokens and lengths must be identical; scores agree to max-abs 1e-4 (float32
on both sides, summation order differs). Only hypotheses scored above
NEG_INF/2 are compared: padding rows score -1e9 and differ by tie order
alone."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasero_tpu import checkpoints as jax_checkpoints
from pasero_tpu.decoding.search import beam_search as jax_beam_search
from pasero_tpu.decoding.search import sample_decode as jax_sample_decode
from pasero_tpu.models.transformer import Transformer as JaxTransformer
from pasero_torch.decoding.generator import TextGenerator
from pasero_torch.decoding.search import NEG_INF, beam_search, sample_decode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "models", "deen-mini2")
DATA = os.path.join(ROOT, "examples", "deen-mini", "data")
MAX_NEW = 64
ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    gen = TextGenerator.build(MODEL, device="cpu", dtype="float32")
    assert gen.dtype == torch.float32
    with open(os.path.join(DATA, "test.de")) as f:
        lines = [next(f).strip() for _ in range(16)]
    meta = gen.task.make_meta()
    samples = [gen.task.preprocess(gen.task.input_to_sample(l, meta))
               for l in lines]
    batch = gen._prepare_batch(samples)
    B, P = batch["prompt"].shape
    S = batch["src_tokens"].shape[1]
    jmodel = JaxTransformer(gen.model_cfg, src_vocab_size=gen.src_vocab_size,
                            self_cache_len=P + MAX_NEW, cross_cache_len=S,
                            dtype=jnp.float32)
    params = jax_checkpoints.unflatten_params(
        jax_checkpoints.load_flat(gen.cfg.ckpt))
    common = dict(max_new=MAX_NEW, eos_idx=gen.task.eos_idx,
                  pad_idx=gen.task.padding_idx)
    return gen, batch, jmodel, params, common


def run_jax(setup, search, **opts):
    gen, batch, jmodel, params, common = setup

    @jax.jit
    def run(params, src, src_mask, prompt, prompt_mask):
        enc, enc_mask = jmodel.apply({"params": params}, src,
                                     src_mask=src_mask,
                                     method=JaxTransformer.encode)
        return search(jmodel, params, prompt, prompt_mask, encoder_out=enc,
                      encoder_mask=enc_mask, **common, **opts)

    out = run(params, jnp.asarray(batch["src_tokens"]),
              jnp.asarray(batch["src_mask"]), jnp.asarray(batch["prompt"]),
              jnp.asarray(batch["prompt_mask"]))
    return {k: np.asarray(v) for k, v in out.items()}


def run_torch(setup, search, **opts):
    gen, batch, _, _, common = setup
    with torch.inference_mode():
        enc, enc_mask = gen.model.encode(
            torch.from_numpy(batch["src_tokens"]).long(),
            torch.from_numpy(batch["src_mask"]))
        out = search(gen.model, torch.from_numpy(batch["prompt"]).long(),
                     torch.from_numpy(batch["prompt_mask"]),
                     encoder_out=enc, encoder_mask=enc_mask, **common, **opts)
    return {k: v.numpy() for k, v in out.items() if k != "model_calls"}


def test_beam5_lineage_matches_jax(setup):
    want = run_jax(setup, jax_beam_search, beam_size=5)
    got = run_torch(setup, beam_search, beam_size=5)
    live = want["scores"] > NEG_INF / 2
    real_rows = setup[1]["src_mask"].any(1)
    assert live[real_rows].all()
    np.testing.assert_array_equal(got["scores"] > NEG_INF / 2, live)
    np.testing.assert_array_equal(got["tokens"][live], want["tokens"][live])
    np.testing.assert_array_equal(got["lengths"][live], want["lengths"][live])
    assert np.abs(got["scores"][live] - want["scores"][live]).max() <= ATOL
    assert np.abs(got["positional_scores"][live]
                  - want["positional_scores"][live]).max() <= ATOL


def test_greedy_matches_jax(setup):
    want = run_jax(setup, jax_sample_decode, greedy=True)
    got = run_torch(setup, sample_decode, greedy=True)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert np.abs(got["scores"] - want["scores"]).max() <= ATOL


def test_stable_topk_keeps_lax_tie_order():
    from pasero_torch.decoding.search import _stable_topk
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 1.0]], np.float32)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(x), 4)
    vals, idx = _stable_topk(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))
