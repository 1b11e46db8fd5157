"""The port's TextGenerator and decode CLI against the JAX TextGenerator.

The JAX generator's beam-5 output on the 60 lines of
examples/deen-mini/data/test.de is committed as
pasero_torch/testdata/deen_mini2_test_beam5.jax.txt; regenerate it with

    JAX_PLATFORMS=cpu python tests/test_torch_generator.py

Both generators compute in bfloat16 with float32 parameters; bf16 rounds at
other places in the two frameworks, so the port must match the JAX output on
at least 57 of the 60 lines (not all).
"""

import os
import subprocess
import sys

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "models", "deen-mini2")
DATA = os.path.join(ROOT, "examples", "deen-mini", "data")
GOLDEN = os.path.join(ROOT, "pasero_torch", "testdata",
                      "deen_mini2_test_beam5.jax.txt")
MIN_MATCH = 57


def read_lines(path):
    with open(path) as f:
        return [line.rstrip("\n") for line in f]


def jax_beam5_output():
    from pasero_tpu.decoding.generator import TextGenerator
    generator = TextGenerator.build(MODEL)
    return generator.decode([l.strip() for l in read_lines(
        os.path.join(DATA, "test.de"))])


def test_golden_file_is_current():
    assert jax_beam5_output() == read_lines(GOLDEN)


def test_port_generator_matches_golden():
    from pasero_torch.decoding.generator import TextGenerator
    from test_torch_train_cli import one_intra_op_thread
    generator = TextGenerator.build(MODEL, device="cpu")
    assert generator.device.type == "cpu"
    lines = [l.strip() for l in read_lines(os.path.join(DATA, "test.de"))]
    with one_intra_op_thread():
        hyps = generator.decode(lines)
    golden = read_lines(GOLDEN)
    same = sum(h == g for h, g in zip(hyps, golden))
    print(f"port TextGenerator (bf16, CPU) matches the JAX output on "
          f"{same}/{len(golden)} lines")
    assert len(hyps) == len(golden) == 60
    assert same >= MIN_MATCH


def test_decode_cli_prints_bleu(tmp_path):
    src, ref = tmp_path / "test.de", tmp_path / "test.en"
    src.write_text("\n".join(read_lines(os.path.join(DATA, "test.de"))[:8]) + "\n")
    ref.write_text("\n".join(read_lines(os.path.join(DATA, "test.en"))[:8]) + "\n")
    proc = subprocess.run(
        [sys.executable, "-m", "pasero_torch.cli.decode", MODEL, "-i",
         str(src), "-r", str(ref), "--beam-size", "5", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    hyps = proc.stdout.strip().splitlines()
    assert len(hyps) == 8 and all(hyps)
    assert "bleu" in proc.stderr, proc.stderr


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as f:
        f.write("\n".join(jax_beam5_output()) + "\n")
    print(f"wrote {GOLDEN}")
