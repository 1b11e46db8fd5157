#!/usr/bin/env python3
"""Full-width training benchmark and profile of the PyTorch port on one card
(the port's counterpart of bench.py).

Transformer-base MT (``get_model_config_cls("transformer")()`` with the
translation defaults and dropout 0.1), a 32000-word vocabulary, weights from
numpy seed 0, a synthetic batch of B = 128 sentences with S = T = 128
tokens in bfloat16, driven through ``Trainer.train_step`` (forward with the
fused cross-entropy kernels, backward, clip, Adam). Prints target tokens/s
(B x T per micro-batch, as bench.py counts), ms per step and peak device
memory; with --profile, also the device's busy share over a few steps and
the device time of the largest operations, from the chrome trace of
torch.profiler (written to build/profile_train.json).

    python -m pasero_torch.scripts.bench_train [--steps 20] [--profile]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import time

import numpy as np
import torch

from .bench_decode import ROOT, random_state, trace_profile

VOCAB, BATCH, SRC_LEN, TGT_LEN = 32000, 128, 128, 128   # bench.py's shape
SEED = 0


class Workload:
    """A seeded transformer-base, its Trainer and a synthetic batch."""

    def __init__(self):
        from pasero_torch.config import TrainingConfig, get_model_config_cls
        from pasero_torch.models.transformer import Transformer
        from pasero_torch.training import Trainer
        model_cfg = get_model_config_cls("transformer")()
        model_cfg.set_defaults("translation")
        model_cfg.dropout = 0.1
        model = Transformer(model_cfg, src_vocab_size=VOCAB,
                            dtype=torch.bfloat16)
        model.load_state_dict(random_state(model, SEED))
        # no data and no checkpoints: the directory stays empty. A 10-step
        # warmup lets the loss fall within the first steps.
        empty = os.path.join(ROOT, "build", "bench_train")
        os.makedirs(empty, exist_ok=True)
        cfg = TrainingConfig("--data-dir", empty, "--model-dir", empty,
                             "-s", "de", "-t", "en", "--max-steps", "1000000",
                             "--valid-interval", "1000000", "--seed",
                             str(SEED), "--warmup", "10")
        self.trainer = Trainer(cfg, None, model, device="cuda")
        self.model_cfg = model_cfg
        rng = np.random.default_rng(SEED)
        dec = rng.integers(4, VOCAB, (BATCH, TGT_LEN))
        dec[:, 0] = model_cfg.bos_idx
        self.batch = {
            "src_tokens": rng.integers(4, VOCAB, (BATCH, SRC_LEN)),
            "src_mask": np.ones((BATCH, SRC_LEN), bool),
            "decoder_input": dec,
            "target_mask": np.ones((BATCH, TGT_LEN), bool),
            "prompt_mask": np.zeros((BATCH, TGT_LEN), bool),
        }
        self.batches = itertools.repeat(self.batch)
        self.tokens_per_step = BATCH * TGT_LEN

    def step(self) -> dict:
        return self.trainer.train_step(self.batches)

    def run(self, steps: int) -> tuple:
        """(per-step logs, seconds) of ``steps`` updates, synchronized."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = [self.step() for _ in range(steps)]
        torch.cuda.synchronize()
        return logs, time.perf_counter() - t0


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this benchmark measures a CUDA card and none is "
                         "available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    work = Workload()
    work.run(3)                                       # warm-up
    torch.cuda.reset_peak_memory_stats()
    logs, seconds = work.run(args.steps)
    result = {"card": smi, "batch": BATCH, "src_len": SRC_LEN,
              "tgt_len": TGT_LEN, "vocab": VOCAB, "steps": args.steps,
              "seconds": seconds,
              "target_tok_per_s": work.tokens_per_step * args.steps / seconds,
              "ms_per_step": seconds * 1e3 / args.steps,
              "peak_memory_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
              "first_loss": logs[0]["loss"], "last_loss": logs[-1]["loss"]}
    if args.profile:
        result["profile"] = trace_profile(
            lambda: work.run(3), os.path.join(ROOT, "build",
                                              "profile_train.json"),
            ("fused_ce::fwd_kernel", "fused_ce::bwd_kernel"))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
