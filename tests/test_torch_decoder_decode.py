"""Decoder-only serving and int8 decoding of the port against pasero_tpu.

On a small Llama (the llama_7b arch cut to 2 layers of width 64, 4 query over
2 K/V heads, untied head) with flax-initialized weights, in float32: greedy,
int8 greedy (every Linear and the head quantized, min_size 0), fused-head
greedy (``PASERO_FUSED_HEAD=1``; JAX's Pallas kernels in interpret mode) and
speculative greedy decoding give the tokens and lengths of JAX's
``sample_decode`` / ``speculative_greedy_decode`` on the same weights, scores
within 1e-4; speculative decoding gives greedy decoding's tokens.

Sampling draws differ in their bits between the frameworks, so distributions
are compared: top-k 1 sampling is greedy decoding; every token JAX's
``_apply_sampling_filters`` draws over 2000 keys lies in the port's filtered
support, and both packages' 2000 draws agree with the port's filtered softmax
by a chi-square test whose statistic must stay below its 1 - 1e-6 quantile
(bins of expected count under 5 merged).

The dialogue task's preprocessing gives JAX's ids and prompt mask on three
conversations, and its float32 decode JAX's tokens.

Golden files, the JAX TextGenerator's outputs on the CPU (bfloat16), are
committed in pasero_torch/testdata and regenerated with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_decoder_decode.py

- ``lm_mini2_greedy.jax.txt``: greedy continuations (max_output_len 24) of
  the first four words of the first 32 lines of deen-mini's test.en by
  ``pasero_torch/testdata/lm-mini2`` (``lm_mini.yaml`` trained 1000 steps by
  the JAX training CLI with ``--attention-kernel xla``);
- ``lm_mini2_greedy_int8_fused.jax.txt``: the same with ``--quantize int8``,
  ``PASERO_FUSED_HEAD=1`` and ``PASERO_QUANTIZE_MIN_SIZE=0``;
- ``lm_mini2_dialogue.jax.txt``: one ``dialogue`` decode (chatml);
- ``deen_mini2_test_beam5_int8.jax.txt``: deen-mini2's beam-5 output on
  test.de with ``--quantize int8``.

The port's bfloat16 decodes on the CPU must match them on at least 30 of 32
and 57 of 60 lines (bf16 rounds at other places in the two frameworks), and
its speculative decode must equal its greedy decode on all 32.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch
from flax import traverse_util

from pasero_tpu import checkpoints as jax_checkpoints
from pasero_tpu.decoding.search import _apply_sampling_filters as jax_filters
from pasero_tpu.decoding.search import sample_decode as jax_sample_decode
from pasero_tpu.decoding.search import \
    speculative_greedy_decode as jax_speculative
from pasero_tpu.models.transformer import Transformer as JaxTransformer
from pasero_tpu.ops import quantize as jq
from pasero_torch import checkpoints
from pasero_torch.decoding import search
from pasero_torch.decoding.generator import TextGenerator
from pasero_torch.models.transformer import Transformer
from pasero_torch.ops import quantize as tq

from test_torch_decoder_only import VOCAB, configs, flax_params
from test_torch_train_cli import one_intra_op_thread

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "pasero_torch", "testdata")
LM = os.path.join(TESTDATA, "lm-mini2")
MT = os.path.join(ROOT, "models", "deen-mini2")
DATA = os.path.join(ROOT, "examples", "deen-mini", "data")
INT8_FUSED_ENV = {"PASERO_FUSED_HEAD": "1", "PASERO_QUANTIZE_MIN_SIZE": "0"}
DIALOGUE_INPUT = "Thomas works until"
GOLDENS = {
    "lm_mini2_greedy.jax.txt": ("greedy", {}),
    "lm_mini2_greedy_int8_fused.jax.txt": ("greedy", INT8_FUSED_ENV),
    "lm_mini2_dialogue.jax.txt": ("dialogue", {}),
    "deen_mini2_test_beam5_int8.jax.txt": ("mt_int8", {}),
}
MIN_LM_MATCH = 30
MIN_MT_MATCH = 57
MAX_NEW = 10
PAD, BOS, EOS = 0, 1, 2        # the Llama arch's
ATOL = 1e-4


def read_lines(path):
    with open(path) as f:
        return [line.rstrip("\n") for line in f]


def lm_prompts():
    """The first four words of the first 32 lines of deen-mini's test.en."""
    return [" ".join(line.split()[:4])
            for line in read_lines(os.path.join(DATA, "test.en"))[:32]]


def mt_inputs():
    return [l.strip() for l in read_lines(os.path.join(DATA, "test.de"))]


def decode(generator_cls, which, **kwargs):
    """One golden file's decode with ``generator_cls`` (either package's
    TextGenerator)."""
    if which == "greedy":
        return generator_cls.build(LM, max_output_len=24, **kwargs).decode(
            lm_prompts())
    if which == "dialogue":
        return generator_cls.build(LM, task="dialogue", max_output_len=24,
                                   **kwargs).decode([DIALOGUE_INPUT])
    return generator_cls.build(MT, quantize="int8", **kwargs).decode(
        mt_inputs())


def jax_golden(name):
    """The JAX TextGenerator's output for a golden file."""
    from pasero_tpu.decoding.generator import TextGenerator as JaxGenerator
    which, env = GOLDENS[name]
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return decode(JaxGenerator, which,
                      **({"quantize": "int8"} if env else {}))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden_files_are_current(name):
    assert jax_golden(name) == read_lines(os.path.join(TESTDATA, name))


@pytest.mark.parametrize("name,minimum", [
    ("lm_mini2_greedy.jax.txt", MIN_LM_MATCH),
    ("lm_mini2_greedy_int8_fused.jax.txt", MIN_LM_MATCH),
    ("deen_mini2_test_beam5_int8.jax.txt", MIN_MT_MATCH)])
def test_port_generator_matches_golden(name, minimum, monkeypatch):
    which, env = GOLDENS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with one_intra_op_thread():
        hyps = decode(TextGenerator, which, device="cpu",
                      **({"quantize": "int8"} if env else {}))
    golden = read_lines(os.path.join(TESTDATA, name))
    same = sum(h == g for h, g in zip(hyps, golden))
    print(f"{name}: the port (bf16, CPU) matches on {same}/{len(golden)}")
    assert len(hyps) == len(golden) and same >= minimum


def test_speculative_generator_is_greedy():
    greedy = decode(TextGenerator, "greedy", device="cpu")
    spec = decode(TextGenerator, "greedy", device="cpu", speculative=True,
                  speculative_draft_len=8)
    assert spec == greedy and all(greedy)


def test_dialogue_decode_matches_jax_in_float32():
    """Two chatml conversations of lm-mini2, prepared by the port's dialogue
    task, through JAX's and the port's greedy ``sample_decode`` in float32
    with the task's stop sequence (the JAX TextGenerator computes in bf16
    whatever its ``dtype``, so the search functions are compared here)."""
    gen = TextGenerator.build(LM, device="cpu", task="dialogue",
                              dtype="float32")
    meta = gen.task.make_meta()
    samples = [gen.task.preprocess(gen.task.input_to_sample(text, meta))
               for text in (DIALOGUE_INPUT, "User: Hello\nAssistant: The "
                            "flight to\nUser: Where?\nAssistant:")]
    batch = gen._prepare_batch(samples)
    stops = tuple(tuple(int(i) for i in s)
                  for s in gen.task.preprocessor.bin_stop_sequences)
    assert stops
    common = dict(max_new=24, eos_idx=gen.task.eos_idx,
                  pad_idx=gen.task.padding_idx, stop_sequences=stops)
    jmodel = JaxTransformer(gen.model_cfg, src_vocab_size=gen.src_vocab_size,
                            self_cache_len=batch["prompt"].shape[1] + 24,
                            dtype=jnp.float32)
    params = jax_checkpoints.unflatten_params(
        jax_checkpoints.load_flat(gen.cfg.ckpt))
    want = jax.jit(lambda p, pr, pm: jax_sample_decode(
        jmodel, p, pr, pm, **common))(params, jnp.asarray(batch["prompt"]),
                                      jnp.asarray(batch["prompt_mask"]))
    with torch.inference_mode():
        got = search.sample_decode(
            gen.model, torch.from_numpy(batch["prompt"]).long(),
            torch.from_numpy(batch["prompt_mask"]), **common)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(),
                                  np.asarray(want["lengths"]))


# -- the small Llama against the JAX search functions -------------------------

@pytest.fixture(scope="module")
def tiny():
    """(JAX config, flax params, the port's float32 state dict) of a small
    Llama with flax-initialized weights, and a left-aligned copy-heavy prompt
    batch."""
    jcfg, _ = configs()
    params = flax_params(JaxTransformer(jcfg, src_vocab_size=VOCAB,
                                        dtype=jnp.float32), seed=3)
    state = checkpoints.params_to_state_dict(
        traverse_util.flatten_dict(params, sep="/"))
    rng = np.random.default_rng(3)
    phrase = list(rng.integers(3, VOCAB, 5))
    rows = [[BOS] + phrase * 3, [BOS] + phrase * 2,
            [BOS] + list(rng.integers(3, VOCAB, 7))]
    P = 16
    prompt = np.full((3, P), PAD, np.int32)
    for i, row in enumerate(rows):
        prompt[i, P - len(row):] = row
    return jcfg, params, state, prompt, prompt != PAD


def port_model(state, quantize=False):
    _, tcfg = configs()
    model = Transformer(tcfg, VOCAB, dtype=torch.float32, kernel="xla")
    model.load_state_dict(state)
    if quantize:
        # 7 Linear layers in each of 2 layers, the head and the token table
        assert tq.quantize_params(model, min_size=0) == 2 * 7 + 2
    return model.eval()


def run_jax(tiny, fn, quantize=False, extra_slots=0, **kw):
    jcfg, params, _, prompt, mask = tiny
    if quantize:
        params, _ = jq.quantize_params(params, min_size=0)
    model = JaxTransformer(jcfg, src_vocab_size=VOCAB, dtype=jnp.float32,
                           self_cache_len=prompt.shape[1] + MAX_NEW
                           + extra_slots)
    run = jax.jit(lambda p, pr, pm: fn(model, p, pr, pm, max_new=MAX_NEW,
                                       eos_idx=EOS, pad_idx=PAD, **kw))
    out = run(params, jnp.asarray(prompt), jnp.asarray(mask))
    return {k: np.asarray(v) for k, v in out.items()}


def run_port(tiny, fn, quantize=False, **kw):
    *_, state, prompt, mask = tiny
    with torch.inference_mode():
        out = fn(port_model(state, quantize), torch.from_numpy(prompt).long(),
                 torch.from_numpy(mask), max_new=MAX_NEW, eos_idx=EOS,
                 pad_idx=PAD, **kw)
    calls = out.pop("model_calls")
    return {k: v.numpy() for k, v in out.items()}, calls


def same_output(got, want):
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert np.abs(got["scores"] - want["scores"]).max() <= ATOL


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["logits", "fused"])
def test_greedy_matches_jax(tiny, quantize, fused, monkeypatch):
    monkeypatch.setenv("PASERO_FUSED_HEAD", "1" if fused else "0")
    want = run_jax(tiny, jax_sample_decode, quantize, greedy=True)
    got, _ = run_port(tiny, search.sample_decode, quantize, greedy=True)
    same_output(got, want)


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["logits", "fused"])
def test_speculative_matches_jax_and_greedy(tiny, quantize, fused,
                                            monkeypatch):
    """The tokens of JAX's speculative decoder, and of greedy decoding, in
    fewer decoder calls on the copy-heavy rows."""
    monkeypatch.setenv("PASERO_FUSED_HEAD", "1" if fused else "0")
    K = 4
    want = run_jax(tiny, jax_speculative, quantize, extra_slots=K + 1,
                   draft_len=K)
    got, calls = run_port(tiny, search.speculative_greedy_decode, quantize,
                          draft_len=K)
    same_output(got, want)
    assert calls == int(want["model_calls"])
    greedy, greedy_calls = run_port(tiny, search.sample_decode, quantize,
                                    greedy=True)
    same_output(got, greedy)
    assert calls <= greedy_calls


def test_decode_step_argmax_head_is_argmax_of_logits(tiny):
    """``decode_step(head="argmax")`` returns the argmax and log-probability
    of the logits the same call would return."""
    *_, state, prompt, mask = tiny
    model = port_model(state)
    ids = torch.from_numpy(prompt).long()
    _, positions, pad_valid = search._prompt_state(
        ids, torch.from_numpy(mask), 4)
    kw = dict(positions=positions, tgt_mask=torch.ones_like(ids, dtype=bool),
              self_kv_mask=pad_valid)
    with torch.inference_mode():
        logits = model.decode_step(ids, model.make_cache(3, 20), **kw)
        tok, lp = model.decode_step(ids, model.make_cache(3, 20),
                                    head="argmax", **kw)
    assert torch.equal(tok, logits.argmax(-1))
    want = torch.log_softmax(logits, -1).gather(-1, tok[..., None])[..., 0]
    assert (lp - want).abs().max() <= 1e-5


# -- sampling -----------------------------------------------------------------

def test_top_k_one_sampling_is_greedy(tiny):
    generator = torch.Generator().manual_seed(0)
    greedy, _ = run_port(tiny, search.sample_decode, greedy=True)
    sampled, _ = run_port(tiny, search.sample_decode, greedy=False, top_k=1,
                          temperature=0.7, generator=generator)
    np.testing.assert_array_equal(sampled["tokens"], greedy["tokens"])


DRAWS = 2000
CHI2_QUANTILE = 1 - 1e-6


def chi_square(draws, probs):
    """(statistic, its 1 - 1e-6 quantile) of ``draws`` against ``probs``, with
    the bins of expected count under 5 merged into one."""
    expected = probs * len(draws)
    observed = np.bincount(draws, minlength=len(probs)).astype(np.float64)
    big = expected >= 5
    exp = np.append(expected[big], expected[~big].sum())
    obs = np.append(observed[big], observed[~big].sum())
    if exp[-1] < 5:          # too little mass left to be a bin of its own
        exp[-2] += exp[-1]
        obs[-2] += obs[-1]
        exp, obs = exp[:-1], obs[:-1]
    stat = ((obs - exp) ** 2 / exp).sum()
    return stat, scipy.stats.chi2.ppf(CHI2_QUANTILE, len(exp) - 1)


@pytest.mark.parametrize("temperature,top_k,top_p,penalty", [
    (1.0, 0, 1.0, 1.0),      # the softmax itself
    (0.7, 10, 1.0, 1.0),     # top-k
    (1.2, 0, 0.8, 1.0),      # top-p
    (0.8, 20, 0.9, 1.3),     # all of them and the repeat penalty
])
def test_sampling_distribution_matches_jax(temperature, top_k, top_p,
                                           penalty):
    rng = np.random.default_rng(11)
    logits = (rng.normal(size=(1, VOCAB)) * 2).astype(np.float32)
    seen = np.array([[5, 9, 9, 30]])
    cfg = (temperature, top_k, top_p, penalty, False)
    probs = torch.softmax(search._sampling_logits(
        search._penalize(torch.from_numpy(logits), torch.from_numpy(seen),
                         penalty), temperature, top_k, top_p), -1)[0]
    probs = probs.double().numpy()
    support = probs > 0
    if top_k and top_p == 1.0:
        assert support.sum() == top_k

    keys = jax.random.split(jax.random.PRNGKey(0), DRAWS)
    jax_draws = np.asarray(jax.vmap(lambda k: jax_filters(
        jnp.asarray(logits), jnp.asarray(seen), cfg, k)[0][0])(keys))
    assert support[jax_draws].all(), sorted(set(jax_draws[~support[jax_draws]]))
    generator = torch.Generator().manual_seed(0)
    port_draws, logprobs = search._apply_sampling_filters(
        torch.from_numpy(logits).repeat(DRAWS, 1),
        torch.from_numpy(seen).repeat(DRAWS, 1), cfg, generator)
    port_draws = port_draws.numpy()
    assert support[port_draws].all()
    # the score of a draw is its unfiltered log-probability, as in JAX
    np.testing.assert_allclose(
        logprobs.numpy(), torch.log_softmax(torch.from_numpy(logits), -1)[
            0, port_draws].numpy(), rtol=0, atol=1e-6)
    for draws in (jax_draws, port_draws):
        stat, limit = chi_square(draws, probs)
        assert stat <= limit, (stat, limit)


def test_sampling_generator_is_reproducible():
    gen = TextGenerator.build(LM, device="cpu", max_output_len=12,
                              sampling=True, sampling_topk=5, seed=7)
    first = gen.decode(lm_prompts()[:6])
    again = TextGenerator.build(LM, device="cpu", max_output_len=12,
                                sampling=True, sampling_topk=5,
                                seed=7).decode(lm_prompts()[:6])
    assert first == again and all(first)


# -- dialogue and batches -------------------------------------------------------

CONVERSATIONS = [
    ("chatml", "Where does Thomas work?", False),
    ("zephyr", ["Hello", "The flight to Berlin", "Where?"], False),
    ("llama-2", [{"role": "system", "content": "Be brief."},
                 {"role": "user", "content": "Where does Thomas work?"},
                 {"role": "assistant", "content": "In Berlin."}], True),
]


@pytest.mark.parametrize("template,conversation,append_eos", CONVERSATIONS)
def test_dialogue_preprocess_matches_jax(template, conversation, append_eos):
    from pasero_tpu.config import DecodingAPIConfig as JaxConfig
    from pasero_tpu.decoding.generator import TextGenerator as JaxGenerator
    from pasero_torch.config import DecodingAPIConfig
    opts = dict(model=LM, task="dialogue", chat_template=template,
                strict=True)
    tasks = [JaxGenerator(JaxConfig(**opts), start=False).task,
             TextGenerator(DecodingAPIConfig(**opts), device="cpu",
                           start=False).task]
    out = [task.preprocess(task.input_to_sample(conversation,
                                                task.make_meta()),
                           append_eos=append_eos) for task in tasks]
    np.testing.assert_array_equal(out[1]["decoder_input"],
                                  out[0]["decoder_input"])
    np.testing.assert_array_equal(out[1]["prompt_mask"], out[0]["prompt_mask"])


def test_decoder_only_batch_has_no_source():
    """_prepare_batch follows JAX's: rows padded to a multiple of 4, a source
    batch only for an encoder-decoder model."""
    for model, text in ((LM, "Thomas works"), (MT, "Guten Morgen.")):
        gen = TextGenerator.build(model, device="cpu")
        meta = gen.task.make_meta()
        samples = [gen.task.preprocess(gen.task.input_to_sample(text, meta))]
        batch = gen._prepare_batch(samples)
        assert batch["prompt"].shape[0] == 4
        assert ("src_tokens" in batch) == (model == MT)


def test_decode_cli_on_a_language_model(tmp_path, monkeypatch):
    """python -m pasero_torch.cli.decode on lm-mini2 with --quantize int8 and
    --speculative decodes every line as the TextGenerator does and logs the
    kernels' launch counts (zero on the CPU: the plain versions run)."""
    monkeypatch.setenv("PASERO_QUANTIZE_MIN_SIZE", "0")
    src = tmp_path / "prompts.en"
    src.write_text("\n".join(lm_prompts()[:4]) + "\n")
    proc = subprocess.run(
        [sys.executable, "-m", "pasero_torch.cli.decode", LM, "-i", str(src),
         "--quantize", "int8", "--speculative", "--max-output-len", "16",
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    want = TextGenerator.build(LM, device="cpu", quantize="int8",
                               speculative=True, max_output_len=16).decode(
        lm_prompts()[:4])
    assert proc.stdout.strip().splitlines() == want
    assert "quantized 16 weights to int8" in proc.stderr, proc.stderr
    assert ("launches | int8_matmul 0 | fused_head_argmax 0 | "
            "fused_head_argmax_q8 0") in proc.stderr, proc.stderr


def write_goldens():
    """Regenerate the golden files with the JAX TextGenerator on the CPU."""
    for name in sorted(GOLDENS):
        path = os.path.join(TESTDATA, name)
        with open(path, "w") as f:
            f.write("\n".join(jax_golden(name)) + "\n")
        print(f"wrote {path}")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    jax.config.update("jax_platforms", "cpu")
    write_goldens()
