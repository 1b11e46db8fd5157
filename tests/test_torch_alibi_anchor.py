"""The alibi-mini anchor: the port's bfloat16 decodes and its training CLI
against the JAX package's committed outputs, on the CPU.

``pasero_torch/testdata/alibi-mini`` is a Bloom-shaped language model
(``pasero_torch/testdata/alibi_mini.yaml``: bloom_560m cut to 2 layers of
width 128, 4 heads, FFN 256, ALiBi, a LayerNorm after the embeddings,
gelu_tanh, no BOS) on the English side of deen-mini, trained 1000 steps by
the JAX training CLI on the CPU (147 s of wall time):

    JAX_PLATFORMS=cpu python -m cli.train \\
        --config pasero_torch/testdata/alibi_mini.yaml --model-dir $TMP \\
        --max-steps 1000 --warmup 100 --valid-interval 250 \\
        --log-interval 50 --attention-kernel xla

(validation nll 0.63 at step 1000). Committed: ``model_best.npz`` (which is
``model_1000.npz``), config, dictionary, bpecodes and inference.yaml.

Golden files in ``pasero_torch/testdata``, regenerated on the CPU with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_alibi_anchor.py

- ``alibi_mini_greedy.jax.txt``: the JAX TextGenerator's greedy
  continuations (bfloat16, max_output_len 24) of the 32 four-word prompts
  that lm-mini2 uses (the first four words of the first 32 lines of
  deen-mini's test.en);
- ``alibi_mini_train20.jax.json``: the JAX training CLI's 20 per-step losses
  on alibi_mini.yaml (flash attention: the Pallas kernels in interpret mode)
  from the weights of ``random_state(model, 0)``, with the flags of
  tests/test_torch_train_cli.py.

Gates on the CPU: all 32 lines equal to the golden, speculative decoding
equal to greedy decoding on all 32, and all 20 losses within 0.05 % (the
port's plain flash version against JAX's interpret-mode kernels, both in
bfloat16 activations).
"""

import json
import os

import pytest

from test_torch_train_cli import ROOT, STEPS, run_cli, train_flags

TESTDATA = os.path.join(ROOT, "pasero_torch", "testdata")
ANCHOR = os.path.join(TESTDATA, "alibi-mini")
CONFIG = os.path.join(TESTDATA, "alibi_mini.yaml")
GREEDY = os.path.join(TESTDATA, "alibi_mini_greedy.jax.txt")
TRAIN = os.path.join(TESTDATA, "alibi_mini_train20.jax.json")
DATA = os.path.join(ROOT, "examples", "deen-mini", "data")
LOSS_RTOL = 5e-4
MAX_OUTPUT_LEN = 24


def read_lines(path):
    with open(path) as f:
        return [line.rstrip("\n") for line in f]


def prompts():
    """The first four words of the first 32 lines of deen-mini's test.en."""
    return [" ".join(line.split()[:4])
            for line in read_lines(os.path.join(DATA, "test.en"))[:32]]


def decode(generator_cls, **kwargs):
    return generator_cls.build(ANCHOR, max_output_len=MAX_OUTPUT_LEN,
                               **kwargs).decode(prompts())


@pytest.fixture(scope="module")
def greedy():
    from pasero_torch.decoding.generator import TextGenerator
    return decode(TextGenerator, device="cpu")


def test_port_greedy_matches_golden(greedy):
    golden = read_lines(GREEDY)
    same = sum(h == g for h, g in zip(greedy, golden))
    assert len(greedy) == len(golden) == 32 and same == 32, same


def test_speculative_is_greedy(greedy):
    from pasero_torch.decoding.generator import TextGenerator
    spec = decode(TextGenerator, device="cpu", speculative=True,
                  speculative_draft_len=8)
    assert spec == greedy and all(greedy)


def test_port_cli_matches_jax_losses(tmp_path):
    with open(TRAIN) as f:
        golden = json.load(f)["steps"]
    # one intra-op thread: the tiny model gains little from more, and a
    # pool of threads stalls when the test workers share the cores
    logs, model_dir, out = run_cli("pasero_torch.cli.train", str(tmp_path),
                                   ["--device", "cpu"],
                                   env={"OMP_NUM_THREADS": "1"},
                                   config=CONFIG)
    assert [s["step"] for s in logs] == [s["step"] for s in golden] == \
        list(range(1, STEPS + 1))
    for got, want in zip(logs, golden):
        for key in ("loss", "nll_loss"):
            assert abs(got[key] - want[key]) <= LOSS_RTOL * abs(want[key]), \
                (got, want)
        assert got["lr"] == want["lr"], (got, want)
    assert os.path.exists(os.path.join(model_dir, "model_20.npz"))


def regenerate():
    """Write both golden files with the JAX package on the CPU."""
    import tempfile

    import jax
    jax.config.update("jax_platforms", "cpu")
    from pasero_tpu.decoding.generator import TextGenerator as JaxGenerator
    with open(GREEDY, "w") as f:
        f.write("\n".join(decode(JaxGenerator)) + "\n")
    print(f"wrote {GREEDY}")
    with tempfile.TemporaryDirectory() as tmp:
        logs, _, _ = run_cli("cli.train", tmp, env={"JAX_PLATFORMS": "cpu"},
                             config=CONFIG)
    assert [s["step"] for s in logs] == list(range(1, STEPS + 1)), logs
    flags = train_flags("<model_dir>", "<init.npz>", CONFIG)
    with open(TRAIN, "w") as f:
        json.dump({"command": "python -m cli.train (pasero_tpu) on the CPU",
                   "initial_weights": "random_state(model, seed 0) of "
                                      "pasero_torch.scripts.bench_decode",
                   "flags": [os.path.relpath(a, ROOT)
                             if a.startswith(ROOT) else a for a in flags],
                   "steps": logs}, f, indent=1)
    print(f"wrote {TRAIN}")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, ROOT)
    regenerate()
