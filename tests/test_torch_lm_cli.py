"""The port's training CLI on a decoder-only language model against the JAX
training CLI's losses.

Both CLIs train ``pasero_torch/testdata/lm_mini.yaml`` (a 2-layer Llama of
width 128 with grouped K/V heads and flash attention, on the English side of
deen-mini) from the same initial weights, numpy seed 0 through
``random_state``, with the flags of tests/test_torch_train_cli.py: dropout
0, a 10-step warmup, 20 steps, logged every step. JAX's attention runs its
Pallas flash kernels (in interpret mode on the CPU), the port's the plain
version of its CUDA kernels.

The JAX training CLI's per-step losses, nll and gnorm are committed in
``pasero_torch/testdata/lm_mini_train20.jax.json``; regenerate them on the
CPU with

    JAX_PLATFORMS=cpu python tests/test_torch_lm_cli.py

Tolerance: 1 % relative on the losses of the first 5 steps — both compute
in bfloat16, and bf16 rounds at other places in the two frameworks.

``pasero_torch/testdata/lm_mini_f32_train20.cpu.json`` holds the port's own
CLI's 20 losses on the same config and flags with ``--dtype float32
--valid-interval 10 --save-interval 10 --device cpu``: the golden of
chip_smoke.py's float32 run on the card, whose flash attention takes the
float32 kernels (the JAX CLI builds every model in bf16, so it has no
float32 run to compare with). Regenerate it on the CPU with

    JAX_PLATFORMS=cpu python tests/test_torch_lm_cli.py --f32
"""

import json
import os

import pytest

from test_torch_train_cli import ROOT, RTOL, STEPS, run_cli, train_flags

CONFIG = os.path.join(ROOT, "pasero_torch", "testdata", "lm_mini.yaml")
GOLDEN = os.path.join(ROOT, "pasero_torch", "testdata",
                      "lm_mini_train20.jax.json")
F32_GOLDEN = os.path.join(ROOT, "pasero_torch", "testdata",
                          "lm_mini_f32_train20.cpu.json")
# the flags of the float32 run beside train_flags', in chip_smoke.py too
F32_FLAGS = ["--dtype", "float32", "--valid-interval", "10",
             "--save-interval", "10"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Five steps of the port's CLI on the CPU, validated at the fifth."""
    return run_cli("pasero_torch.cli.train",
                   str(tmp_path_factory.mktemp("lm")),
                   ["--device", "cpu", "--max-steps", "5",
                    "--valid-interval", "5"], config=CONFIG)


def test_port_lm_cli_matches_jax_losses(trained):
    with open(GOLDEN) as f:
        golden = json.load(f)["steps"]
    logs, model_dir, out = trained
    assert [s["step"] for s in logs] == list(range(1, 6))
    for got, want in zip(logs, golden[:5]):
        for key in ("loss", "nll_loss"):
            assert abs(got[key] - want[key]) <= RTOL * abs(want[key]), \
                (got, want)
        assert got["lr"] == want["lr"], (got, want)
    # validation is the loss only: a language model's task names no metrics
    assert "valid | valid.en | valid_loss" in out
    for name in ("model_5.npz", "config.json", "dict.txt"):
        assert os.path.exists(os.path.join(model_dir, name)), name


def test_decoding_a_language_model(trained):
    """TextGenerator decodes the CLI's decoder-only checkpoint: greedy and
    speculative decoding give the same continuation of every prompt."""
    from pasero_torch.decoding.generator import TextGenerator
    model_dir = trained[1]
    prompts = ["The flight to", "Thomas works until eight"]
    greedy = TextGenerator.build(model_dir, ckpt="model_5.npz", device="cpu",
                                 max_output_len=8)
    assert greedy.model_cfg.model_type == "decoder"
    hyps = greedy.decode(prompts, return_scores=True)
    assert len(hyps) == 2 and all(0 < len(h[0]["tokens"]) <= 8 for h in hyps)
    spec = TextGenerator.build(model_dir, ckpt="model_5.npz", device="cpu",
                               max_output_len=8, speculative=True)
    assert [h[0]["tokens"] for h in spec.decode(prompts, return_scores=True)] \
        == [h[0]["tokens"] for h in hyps]


def regenerate():
    """Run the JAX training CLI with the test's flags on the CPU and write the
    golden file."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        logs, _, _ = run_cli("cli.train", tmp, env={"JAX_PLATFORMS": "cpu"},
                             config=CONFIG)
    assert [s["step"] for s in logs] == list(range(1, STEPS + 1)), logs
    flags = train_flags("<model_dir>", "<init.npz>", CONFIG)
    with open(GOLDEN, "w") as f:
        json.dump({"command": "python -m cli.train (pasero_tpu) on the CPU",
                   "initial_weights": "random_state(model, seed 0) of "
                                      "pasero_torch.scripts.bench_decode",
                   "flags": [os.path.relpath(a, ROOT)
                             if a.startswith(ROOT) else a for a in flags],
                   "steps": logs}, f, indent=1)
    print(f"wrote {GOLDEN}")


def regenerate_f32():
    """Run the port's training CLI on the CPU in float32 and write the
    float32 golden file."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        logs, _, _ = run_cli("pasero_torch.cli.train", tmp,
                             F32_FLAGS + ["--device", "cpu"], config=CONFIG)
    assert [s["step"] for s in logs] == list(range(1, STEPS + 1)), logs
    flags = train_flags("<model_dir>", "<init.npz>", CONFIG) + F32_FLAGS
    with open(F32_GOLDEN, "w") as f:
        json.dump({"command": "python -m pasero_torch.cli.train --device cpu",
                   "initial_weights": "random_state(model, seed 0) of "
                                      "pasero_torch.scripts.bench_decode",
                   "flags": [os.path.relpath(a, ROOT)
                             if a.startswith(ROOT) else a for a in flags],
                   "steps": logs}, f, indent=1)
    print(f"wrote {F32_GOLDEN}")


if __name__ == "__main__":
    import sys
    if "--f32" in sys.argv:
        regenerate_f32()
    else:
        regenerate()
