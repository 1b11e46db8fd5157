"""The port's training CLI against the JAX training CLI's losses on deen-mini2.

Both CLIs train ``models/deen-mini2/training.yaml`` (with the model
directory in a temporary directory) from the same initial weights, numpy
seed 0 through ``random_state``, saved as a flat npz and passed with --ckpt;
dropout 0, a 10-step warmup, 20 steps, logged every step. The data order is
the same in both: the copied datasets and samplers draw from numpy seeded
with the config's seed.

The JAX training CLI's per-step losses, nll and gnorm are committed in
``pasero_torch/testdata/deen_mini_train20.jax.json``; regenerate them on the
CPU with

    JAX_PLATFORMS=cpu python tests/test_torch_train_cli.py

Tolerance: 1 % relative on the losses of the first 5 steps — both compute
in bfloat16, and bf16 rounds at other places in the two frameworks.
"""

import contextlib
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "models", "deen-mini2", "training.yaml")
GOLDEN = os.path.join(ROOT, "pasero_torch", "testdata",
                      "deen_mini_train20.jax.json")
STEPS = 20
RTOL = 0.01
LOG_LINE = re.compile(r"step (\d+) \| loss ([\d.]+) \| nll_loss ([\d.]+) \|"
                      r".*\| gnorm ([\d.]+) \| lr ([\d.e+-]+)")


# The environment of a CLI run by a test: one intra-op thread, as
# ``one_intra_op_thread`` gives a test's own torch calls.
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


@contextlib.contextmanager
def one_intra_op_thread():
    """torch on one intra-op thread inside the block: a pool of threads
    stalls when the suite's test workers share the cores (a decode of 60
    lines that takes 3 s alone took minutes in the suite)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def train_flags(model_dir: str, ckpt: str, config: str = CONFIG) -> list:
    return ["--config", config, "--model-dir", model_dir, "--ckpt", ckpt,
            "--dropout", "0", "--log-interval", "1", "--warmup", "10",
            "--max-steps", str(STEPS),
            "--line-index-path", os.path.join(model_dir, "line_index.bin")]


def write_initial_weights(path: str, config: str = CONFIG) -> None:
    """The port's model for the config, weights from numpy seed 0, saved in
    the flat checkpoint format both packages read."""
    sys.path.insert(0, ROOT)
    from pasero_torch import checkpoints
    from pasero_torch.config import TrainingConfig, get_model_cls, get_task_cls
    from pasero_torch.scripts.bench_decode import random_state
    cfg = TrainingConfig("--config", config, "--model-dir",
                         os.path.dirname(path))
    task = get_task_cls(cfg.task)(cfg.data_dir, cfg.task_cfg)
    task.setup_for_model(cfg.model_cfg)
    model_cls, _ = get_model_cls(cfg.arch)
    model = model_cls(cfg.model_cfg,
                      src_vocab_size=(task.encoder_num_embeddings
                                      or task.decoder_num_embeddings),
                      tgt_vocab_size=task.decoder_num_embeddings)
    checkpoints.save_flat(path, checkpoints.state_dict_to_params(
        random_state(model, 0)))


def parse_log(text: str) -> list:
    """[{"step", "loss", "nll_loss", "gnorm", "lr"}] from the CLIs'
    ``step N | loss …`` log lines."""
    out = []
    for m in LOG_LINE.finditer(text):
        out.append({"step": int(m.group(1)), "loss": float(m.group(2)),
                    "nll_loss": float(m.group(3)),
                    "gnorm": float(m.group(4)), "lr": float(m.group(5))})
    return out


def run_cli(module: str, workdir: str, extra=(), env=None,
            config: str = CONFIG) -> tuple:
    """Run ``python -m module`` with the test's flags; returns (per-step
    logs, model directory, output)."""
    model_dir = os.path.join(workdir, "model")
    os.makedirs(model_dir, exist_ok=True)
    ckpt = os.path.join(workdir, "init.npz")
    if not os.path.exists(ckpt):
        write_initial_weights(ckpt, config)
    proc = subprocess.run(
        [sys.executable, "-m", module, *train_flags(model_dir, ckpt, config),
         *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTHONPATH": ROOT, **(env or {})})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = proc.stdout + proc.stderr
    return parse_log(out), model_dir, out


def test_port_cli_matches_jax_losses(tmp_path):
    with open(GOLDEN) as f:
        golden = json.load(f)["steps"]
    logs, model_dir, _ = run_cli("pasero_torch.cli.train", str(tmp_path),
                                 ["--device", "cpu"])
    assert [s["step"] for s in logs] == list(range(1, STEPS + 1))
    for got, want in zip(logs[:5], golden[:5]):
        for key in ("loss", "nll_loss"):
            assert abs(got[key] - want[key]) <= RTOL * abs(want[key]), \
                (got, want)
        assert got["lr"] == want["lr"], (got, want)
    # training went on: the loss falls, and the last checkpoint is written
    assert logs[-1]["loss"] < logs[0]["loss"] - 0.5
    for name in ("model_20.npz", "optimizer_20.npz", "state_20.json",
                 "config.json", "inference.yaml", "dict.txt"):
        assert os.path.exists(os.path.join(model_dir, name)), name


def test_sigterm_saves_latest_and_resume_continues(tmp_path):
    """SIGTERM saves model_latest (with optimizer and state) and exits 143;
    the next run resumes at that step and discards the interrupt files."""
    import signal
    import time
    model_dir = str(tmp_path / "model")
    ckpt = str(tmp_path / "init.npz")
    write_initial_weights(ckpt)
    flags = train_flags(model_dir, ckpt)
    flags[flags.index("--max-steps") + 1] = "1000"
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.Popen(
        [sys.executable, "-m", "pasero_torch.cli.train", *flags, "--device",
         "cpu"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    seen = ""
    deadline = time.time() + 300
    while "step 3 |" not in seen and time.time() < deadline:
        seen += proc.stdout.readline()
    proc.send_signal(signal.SIGTERM)
    seen += proc.communicate(timeout=300)[0]
    assert proc.returncode == 143, seen[-2000:]
    state = json.load(open(os.path.join(model_dir, "state_latest.json")))
    assert state["step"] >= 3
    assert os.path.exists(os.path.join(model_dir, "optimizer_latest.npz"))

    flags[flags.index("--max-steps") + 1] = str(state["step"] + 1)
    out = subprocess.run(
        [sys.executable, "-m", "pasero_torch.cli.train", *flags, "--device",
         "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    logs = parse_log(out.stdout + out.stderr)
    assert [s["step"] for s in logs] == [state["step"] + 1]
    assert f"resumed at step {state['step']}" in out.stderr
    assert not os.path.exists(os.path.join(model_dir, "model_latest.npz"))


def regenerate():
    """Run the JAX training CLI with the test's flags on the CPU and write the
    golden file."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        logs, _, _ = run_cli("cli.train", tmp, env={"JAX_PLATFORMS": "cpu"})
    assert [s["step"] for s in logs] == list(range(1, STEPS + 1)), logs
    flags = train_flags("<model_dir>", "<init.npz>")
    with open(GOLDEN, "w") as f:
        json.dump({"command": "python -m cli.train (pasero_tpu) on the CPU",
                   "initial_weights": "random_state(model, seed 0) of "
                                      "pasero_torch.scripts.bench_decode",
                   "flags": [os.path.relpath(a, ROOT)
                             if a.startswith(ROOT) else a for a in flags],
                   "steps": logs}, f, indent=1)
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    regenerate()
