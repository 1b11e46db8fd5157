"""The t5-mini anchor: the port's bfloat16 decodes and its training CLI
against the JAX package's committed outputs, on the CPU.

``pasero_torch/testdata/t5-mini`` is a T5-shaped de->en translation model
(``pasero_torch/testdata/t5_mini.yaml``: t5_base cut to 2 + 2 layers of
width 128, 4 heads of 32, GeGLU FFN 256, RMSNorm, no biases, no attention
scaling, T5 buckets on both sides, an untied head) on deen-mini, trained
1000 steps by the JAX training CLI on the CPU (698 s of wall time):

    JAX_PLATFORMS=cpu python -m cli.train \\
        --config pasero_torch/testdata/t5_mini.yaml --model-dir $TMP \\
        --max-steps 1000 --warmup 100 --valid-interval 250 \\
        --log-interval 50 --attention-kernel xla --batch-size 4096

with ``metrics: [bleu, chrf]`` (valid BLEU 92.08, chrF 95.23 at step 1000;
the YAML's 20-step runs take batches of 1024 tokens and validate without
decoding, so JAX's interpreted kernels produce their losses in minutes). Committed: ``model_1000.npz`` as
``model_best.npz``, dictionary, bpecodes, inference.yaml and config.json,
whose ``attention_kernel`` is set to ``flash`` so that both generators
encode through their T5 flash path.

Golden files in ``pasero_torch/testdata``, regenerated on the CPU with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_t5_anchor.py

- ``t5_mini_greedy.jax.txt`` and ``t5_mini_beam5.jax.txt``: the JAX
  TextGenerator's bfloat16 greedy and beam-5 translations of the 60 lines of
  deen-mini's test.de (its encoder through JAX's in-kernel T5 flash path,
  the Pallas kernels interpreted);
- ``t5_mini_train20.jax.json``: the JAX training CLI's 20 per-step losses on
  t5_mini.yaml (flash attention: the streamed T5 kernels interpreted) from
  the weights of ``random_state(model, 0)``, with the flags of
  tests/test_torch_train_cli.py.

Gates on the CPU: at least 57 of the 60 lines of each decode equal to the
golden (bfloat16 rounds at other places in the two frameworks), and all 20
losses within 1 %, the card's gate (chip_smoke.py's TRAIN_RTOL): JAX's
interpreted kernels round P and dS to bfloat16 where the port's plain
version keeps float32, and T5's unscaled attention (scale 1) makes the
softmax of seeded weights sharp, so the losses part by up to 0.47 % (step
14) while the first 8 agree within 0.03 %.
"""

import json
import os

import pytest

from test_torch_train_cli import (ONE_THREAD, ROOT, STEPS, one_intra_op_thread,
                                  run_cli, train_flags)

TESTDATA = os.path.join(ROOT, "pasero_torch", "testdata")
ANCHOR = os.path.join(TESTDATA, "t5-mini")
CONFIG = os.path.join(TESTDATA, "t5_mini.yaml")
GOLDEN = {beam: os.path.join(TESTDATA, f"t5_mini_{name}.jax.txt")
          for beam, name in ((1, "greedy"), (5, "beam5"))}
TRAIN = os.path.join(TESTDATA, "t5_mini_train20.jax.json")
DATA = os.path.join(ROOT, "examples", "deen-mini", "data")
MIN_MATCH = 57
LOSS_RTOL = 0.01


def read_lines(path):
    with open(path) as f:
        return [line.rstrip("\n") for line in f]


def sources():
    return [line.strip() for line in read_lines(os.path.join(DATA,
                                                             "test.de"))]


def decode(generator_cls, beam_size, **kwargs):
    return generator_cls.build(ANCHOR, beam_size=beam_size,
                               **kwargs).decode(sources())


@pytest.mark.parametrize("beam_size", [1, 5], ids=["greedy", "beam5"])
def test_port_decode_matches_golden(beam_size):
    from pasero_torch.decoding.generator import TextGenerator
    with one_intra_op_thread():
        hyps = decode(TextGenerator, beam_size, device="cpu")
    golden = read_lines(GOLDEN[beam_size])
    same = sum(h == g for h, g in zip(hyps, golden))
    assert len(hyps) == len(golden) == 60 and same >= MIN_MATCH, same


def test_port_cli_matches_jax_losses(tmp_path):
    with open(TRAIN) as f:
        golden = json.load(f)["steps"]
    logs, model_dir, _ = run_cli("pasero_torch.cli.train", str(tmp_path),
                                 ["--device", "cpu"], env=ONE_THREAD,
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
    """Write the three golden files with the JAX package on the CPU."""
    import tempfile

    import jax
    jax.config.update("jax_platforms", "cpu")
    from pasero_tpu.decoding.generator import TextGenerator as JaxGenerator
    for beam, path in GOLDEN.items():
        with open(path, "w") as f:
            f.write("\n".join(decode(JaxGenerator, beam)) + "\n")
        print(f"wrote {path}")
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
