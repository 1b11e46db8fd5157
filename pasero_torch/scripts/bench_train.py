#!/usr/bin/env python3
"""Full-width training benchmark and profile of the PyTorch port on one card.

Two workloads, each driven through ``Trainer.train_step`` (forward, backward,
clip, Adam) with weights from numpy seed 0 and a synthetic batch, the model
in bfloat16 (``--dtype float32``: in float32, whose attention takes the
float32 flash kernels of csrc/flash_f32.cu where the workload's takes the
flash kernels):

- ``--model transformer`` (the default, bench.py's shape): transformer-base
  MT (the translation defaults, dropout 0.1), a 32000-word vocabulary, B = 128
  sentences with S = T = 128 tokens; the loss through the fused
  cross-entropy kernels;
- ``--model llama_1b`` (scripts/bench_1b.py's training shape):
  ``get_model_cls("llama_1b")`` with the language-modeling defaults and
  dropout 0, a 32000-word vocabulary, B = 4 rows of T = 2048 tokens drawn by
  numpy seed 0; attention through the flash kernels (``auto`` picks them for
  its grouped K/V heads at this length), the loss through the fused CE.
  JAX's benchmark steps with adafactor; the port's trainer uses the Adam of
  its config;
- ``--model bloom_560m``: the bloom_560m arch (24 layers, width 1024, 16
  heads, FFN 4096, ALiBi) with the language-modeling defaults and dropout
  0, Bloom's vocabulary of 250880, B = 4 rows of T = 2048 tokens drawn by
  numpy seed 0; ``attention_kernel: flash`` (``auto`` keeps a biased
  attention on the plain path below 4096^2 scores), so every layer runs the
  biased flash kernels with the ALiBi bias, and the loss runs through the
  fused CE;
- ``--model t5_base``: the t5_base arch (12 + 12 layers, width 768, 12
  heads of 64, GeGLU FFN 2048, T5 buckets on both sides) with the
  translation defaults and dropout 0, T5's vocabulary of 32128, B = 32
  sentences of S = 512 source and T = 128 target tokens (FLAN-T5's
  fine-tuning shape) drawn by numpy seed 0; ``attention_kernel: flash``, so
  every self-attention runs the T5 flash kernels with the table (the T5 dq
  kernel also summing the table's gradient) and every cross-attention the
  bias-free ones, and the loss runs through the fused CE;
- ``--model whisper_base``: the whisper_base arch with the speech-translation
  defaults and dropout 0, Whisper's vocabulary of 51865, B = 16 utterances
  of 3000 log-mel frames (30 s; seeded normal features) into the
  convolution subsampler and 1500 encoder positions, and T = 128 target
  tokens; attention on the plain path (``auto`` keeps 8 dense heads at 1500
  keys there), the loss through the fused CE.

Prints target tokens/s (B x T per micro-batch), ms per step and peak device
memory; with --profile, also the device's busy share over a few steps and
the device time of the largest operations, from the chrome trace of
torch.profiler (written to build/profile_train.json), and the device ms per
step of the FFN activation beside ``F.gelu(approximate="tanh")``
(``activation_ms``).

    python -m pasero_torch.scripts.bench_train
        [--model llama_1b|bloom_560m|t5_base|whisper_base]
        [--dtype float32] [--steps 20] [--profile]
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

VOCAB = 32000
SEED = 0
# arch, task, dropout, batch, source length, target length, vocabulary
SHAPES = {"transformer": ("transformer", "translation", 0.1, 128, 128, 128,
                          VOCAB),
          "llama_1b": ("llama_1b", "language_modeling", 0.0, 4, 0, 2048,
                       VOCAB),
          "bloom_560m": ("bloom_560m", "language_modeling", 0.0, 4, 0, 2048,
                         250880),
          "t5_base": ("t5_base", "translation", 0.0, 32, 512, 128, 32128),
          "whisper_base": ("whisper_base", "speech_translation", 0.0, 16,
                           3000, 128, 51865)}
# workloads whose attention kernel is set, not left to ``auto``
ATTENTION = {"bloom_560m": "flash", "t5_base": "flash"}
# the port's kernels by a part of their names in a trace, each kernel under
# one key: the fused-CE forward's product and merge and the backward's three
# products by their epilogues (bf16's by the epilogues' bf16 instances, the
# float32 products as tf32_gemm_kernel<epilogue, and the float32 split
# pass), dbias (flash::), and flash_bwd.cu's forward, dq and dk/dv by their
# first template argument, the bias kind: 0 none, 1 a dense bias, 2 T5's
# table (whose dq kernel also sums the table's gradient), and their float32
# twins of flash_f32.cu (flash_f32::)
KERNELS = ("fused_ce::FwdEpilogue", "fused_ce::fwd_combine_kernel",
           "fused_ce::DlogitsEpilogue<__nv_bfloat16",
           "fused_ce::DwEpilogue<false>", "fused_ce::DxEpilogue",
           "tf32_gemm_kernel<fused_ce::FwdChunkEpilogue",
           "tf32_gemm_kernel<fused_ce::DlogitsEpilogue",
           "tf32_gemm_kernel<fused_ce::DwEpilogue",
           "tf32_gemm_kernel<fused_ce::DxAddEpilogue",
           "fused_ce::tf32::split_kernel", "flash::dbias_kernel",
           "flash_f32::dbias_kernel") + tuple(
               f"{space}::{name}_kernel<{kind},"
               for space in ("flash_bwd", "flash_f32")
               for kind in (0, 1, 2) for name in ("fwd", "dq", "dkv"))


class Workload:
    """A seeded model of ``SHAPES[name]``, its Trainer and a synthetic
    batch."""

    def __init__(self, name: str = "transformer", dtype: str = "bfloat16"):
        from pasero_torch.config import TrainingConfig, get_model_cls
        from pasero_torch.training import Trainer
        arch, task, dropout, batch, src_len, tgt_len, vocab = SHAPES[name]
        model_cls, cfg_cls = get_model_cls(arch)
        model_cfg = cfg_cls()
        model_cfg.set_defaults(task)
        model_cfg.dropout = dropout
        model_cfg.attention_kernel = ATTENTION.get(
            name, model_cfg.attention_kernel)
        model = model_cls(model_cfg, src_vocab_size=vocab,
                          dtype=getattr(torch, dtype))
        model.load_state_dict(random_state(model, SEED))
        # no data and no checkpoints: the directory stays empty. A 10-step
        # warmup lets the loss fall within the first steps.
        empty = os.path.join(ROOT, "build", "bench_train")
        os.makedirs(empty, exist_ok=True)
        langs = {"translation": ["-s", "de", "-t", "en"],
                 "speech_translation": ["-s", "en", "-t", "en",
                                        "--allow-monolingual"]}.get(task, [])
        cfg = TrainingConfig("--task", task, "--data-dir", empty,
                             "--model-dir", empty, *langs, "--max-steps",
                             "1000000", "--valid-interval", "1000000",
                             "--seed", str(SEED), "--warmup", "10",
                             "--dtype", dtype)
        self.trainer = Trainer(cfg, None, model, device="cuda")
        self.model_cfg = model_cfg
        self.layers = model_cfg.decoder_layers
        rng = np.random.default_rng(SEED)
        dec = rng.integers(4, vocab, (batch, tgt_len))
        self.batch = {
            "decoder_input": dec,
            "target_mask": np.ones((batch, tgt_len), bool),
            "prompt_mask": np.zeros((batch, tgt_len), bool),
        }
        if src_len:
            if model_cfg.bos_idx >= 0:    # T5 starts without BOS
                dec[:, 0] = model_cfg.bos_idx
            self.batch["src_tokens"] = (
                rng.standard_normal((batch, src_len, model_cfg.input_dim),
                                    dtype=np.float32)
                if model_cfg.input_dim
                else rng.integers(4, vocab, (batch, src_len)))
            self.batch["src_mask"] = np.ones((batch, src_len), bool)
        self.batches = itertools.repeat(self.batch)
        self.tokens_per_step = batch * tgt_len
        self.dtype = getattr(torch, dtype)

    def step(self) -> dict:
        return self.trainer.train_step(self.batches)

    def run(self, steps: int) -> tuple:
        """(per-step logs, seconds) of ``steps`` updates, synchronized."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = [self.step() for _ in range(steps)]
        torch.cuda.synchronize()
        return logs, time.perf_counter() - t0


def activation_ms(work, iters: int = 20) -> dict:
    """Device ms per step of the decoder's FFN activation at the workload's
    shape, (B T, ffn) in the model's type, forward and backward, times the
    decoder's
    layers: the model's own activation and ``F.gelu(approximate="tanh")`` in
    its place, each timed with CUDA events over ``iters`` calls."""
    import torch.nn.functional as F
    from pasero_torch.models.modules import ACTIVATIONS, GATES
    cfg = work.model_cfg
    own = GATES.get(cfg.activation_fn) or ACTIVATIONS[cfg.activation_fn]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(work.tokens_per_step, cfg.decoder_ffn_dim, device="cuda",
                    generator=gen).to(work.dtype).requires_grad_()
    dy = torch.randn_like(x)
    fns = {cfg.activation_fn: own,
           "F.gelu tanh": lambda t: F.gelu(t, approximate="tanh")}
    result = {}
    for name, fn in fns.items():
        for _ in range(3):
            torch.autograd.grad(fn(x), x, dy)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            torch.autograd.grad(fn(x), x, dy)
        end.record()
        torch.cuda.synchronize()
        result[name] = start.elapsed_time(end) / iters * work.layers
    return {"shape": list(x.shape), "layers": work.layers,
            "ms_per_step": result}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=sorted(SHAPES),
                        default="transformer")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"),
                        default="bfloat16")
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
    work = Workload(args.model, args.dtype)
    work.run(3)                                       # warm-up
    torch.cuda.reset_peak_memory_stats()
    logs, seconds = work.run(args.steps)
    _, _, _, batch, src_len, tgt_len, vocab = SHAPES[args.model]
    result = {"card": smi, "model": args.model, "dtype": args.dtype,
              "batch": batch,
              "src_len": src_len, "tgt_len": tgt_len, "vocab": vocab,
              "steps": args.steps,
              "seconds": seconds,
              "target_tok_per_s": work.tokens_per_step * args.steps / seconds,
              "ms_per_step": seconds * 1e3 / args.steps,
              "peak_memory_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
              "first_loss": logs[0]["loss"], "last_loss": logs[-1]["loss"]}
    if args.profile:
        result["profile"] = trace_profile(
            lambda: work.run(3), os.path.join(ROOT, "build",
                                              "profile_train.json"), KERNELS)
        result["activation"] = activation_ms(work)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
