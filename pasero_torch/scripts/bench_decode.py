#!/usr/bin/env python3
"""Full-width decode benchmark and profile of the PyTorch port on one card
(the counterpart of scripts/bench_decode.py, scripts/profile_decode.py and
scripts/bench_1b.py --decode).

Two workloads, with weights from a numpy seed:

- ``--model transformer`` (the default): transformer-base MT, B sentences of
  source length S, beam K (1 = greedy), a left-aligned prompt bucket of P
  slots holding BOS, and N new tokens, through Transformer.encode and
  beam_search / sample_decode;
- ``--model llama_1b`` (scripts/bench_1b.py --decode's shape): the llama_1b
  arch with the language-modeling defaults and a 32000-word vocabulary, B = 8
  prompts of 128 tokens (``--prompt-style copy``: a 16-token phrase repeated,
  where prompt-lookup drafts verify; ``random``: i.i.d. tokens, where they
  almost never do) and 64 new tokens, greedy through sample_decode or, with
  ``--speculative``, speculative_greedy_decode with drafts of 8; with
  ``--quantize int8`` the weights are quantized after loading
  (ops/quantize.py), with ``--fused-head`` the greedy head is the fused
  argmax kernel (``PASERO_FUSED_HEAD=1``).

Prints output tokens/s, ms per decoder call and peak device memory; with
--profile, also the device's busy share over one decode and the device time
by kernel, from the chrome trace of torch.profiler (written to
build/profile_decode.json).

    python -m pasero_torch.scripts.bench_decode [--batch 64] [--beam 5]
        [--src-len 32] [--prompt-len 8] [--max-new 64] [--vocab 32768]
        [--arch transformer] [--repeats 3] [--profile]
    python -m pasero_torch.scripts.bench_decode --model llama_1b
        [--quantize int8] [--fused-head] [--speculative]
        [--prompt-style copy|random] [--repeats 3] [--profile]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def random_state(model, seed: int) -> dict:
    """Weights from a numpy seed: normal(0, fan_in^-0.5) matrices and
    embeddings, unit norm scales, zero biases."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, value in model.state_dict().items():
        shape = tuple(value.shape)
        if name.endswith("bias"):
            array = np.zeros(shape, np.float32)
        elif len(shape) == 1:
            array = np.ones(shape, np.float32)
        else:
            array = (rng.standard_normal(shape, dtype=np.float32)
                     * shape[-1] ** -0.5)
        state[name] = torch.from_numpy(array)
    return state


class Workload:
    """A seeded model and batch, and one decode over them."""

    def __init__(self, arch="transformer", vocab=32768, batch=64, src_len=32,
                 prompt_len=8, max_new=64, beam=5, seed=0, device="cuda",
                 dtype=torch.bfloat16):
        from pasero_torch.config import get_model_cls
        model_cls, cfg_cls = get_model_cls(arch)
        cfg = cfg_cls()
        cfg.set_defaults("translation")
        model = model_cls(cfg, src_vocab_size=vocab, dtype=dtype)
        model.load_state_dict(random_state(model, seed))
        self.cfg, self.model = cfg, model.to(device).eval()
        self.beam, self.max_new = beam, max_new
        rng = np.random.default_rng(seed)
        self.src = torch.as_tensor(rng.integers(4, vocab, (batch, src_len)),
                                   device=device)
        self.prompt = torch.full((batch, prompt_len), cfg.padding_idx,
                                 device=device)
        self.prompt[:, -1] = cfg.bos_idx                 # left-aligned BOS
        self.prompt_mask = self.prompt != cfg.padding_idx

    @torch.inference_mode()
    def run(self) -> dict:
        from pasero_torch.decoding.search import beam_search, sample_decode
        encoder_out, encoder_mask = self.model.encode(self.src)
        common = dict(max_new=self.max_new, eos_idx=self.cfg.eos_idx,
                      pad_idx=self.cfg.padding_idx, encoder_out=encoder_out,
                      encoder_mask=encoder_mask)
        if self.beam == 1:
            return sample_decode(self.model, self.prompt, self.prompt_mask,
                                 **common)
        return beam_search(self.model, self.prompt, self.prompt_mask,
                           beam_size=self.beam, **common)

    @staticmethod
    def output_tokens(out) -> int:
        lengths = out["lengths"]
        return int((lengths if lengths.dim() == 1 else lengths[:, 0]).sum())


class LMWorkload:
    """llama_1b with seeded weights and a prompt batch of bench_1b's decode,
    and one greedy or speculative decode over them. ``fused_head`` and
    ``speculative`` may be changed between runs; ``quantize()`` turns the
    weights to int8 in place."""

    VOCAB = 32000

    def __init__(self, batch=8, prompt_len=128, max_new=64,
                 prompt_style="copy", draft_len=8, seed=0, device="cuda",
                 dtype=torch.bfloat16):
        from pasero_torch.config import get_model_cls
        model_cls, cfg_cls = get_model_cls("llama_1b")
        cfg = cfg_cls()
        cfg.set_defaults("language_modeling")
        cfg.dropout = 0.0
        model = model_cls(cfg, src_vocab_size=self.VOCAB, dtype=dtype)
        model.load_state_dict(random_state(model, seed))
        self.cfg, self.model = cfg, model.to(device).eval()
        self.max_new, self.draft_len = max_new, draft_len
        self.fused_head = self.speculative = False
        self.quantized, self.quantized_bytes = 0, (0, 0)
        rng = np.random.default_rng(seed)
        if prompt_style == "copy":
            phrase = rng.integers(4, self.VOCAB, 16)
            prompt = np.tile(phrase, (batch, prompt_len // 16))
        elif prompt_style == "random":
            prompt = rng.integers(4, self.VOCAB, (batch, prompt_len))
        else:
            raise ValueError(f"unknown prompt style {prompt_style!r}")
        self.prompt = torch.as_tensor(prompt, device=device)
        self.prompt_mask = torch.ones_like(self.prompt, dtype=torch.bool)

    def quantize(self) -> None:
        from pasero_torch.ops.quantize import quantize_params, quantized_bytes
        self.quantized = quantize_params(self.model)
        self.quantized_bytes = quantized_bytes(self.model)

    @torch.inference_mode()
    def run(self, sampling: Optional[dict] = None) -> dict:
        """One decode: speculative or greedy, or sampling with
        ``sampling = {"top_k": ..., "generator": ...}``."""
        from pasero_torch.decoding.search import (sample_decode,
                                                  speculative_greedy_decode)
        common = dict(max_new=self.max_new, eos_idx=self.cfg.eos_idx,
                      pad_idx=self.cfg.padding_idx)
        saved = os.environ.get("PASERO_FUSED_HEAD")
        os.environ["PASERO_FUSED_HEAD"] = "1" if self.fused_head else "0"
        try:
            if sampling is not None:
                return sample_decode(self.model, self.prompt, self.prompt_mask,
                                     greedy=False, **sampling, **common)
            if self.speculative:
                return speculative_greedy_decode(
                    self.model, self.prompt, self.prompt_mask,
                    draft_len=self.draft_len, **common)
            return sample_decode(self.model, self.prompt, self.prompt_mask,
                                 **common)
        finally:
            if saved is None:
                del os.environ["PASERO_FUSED_HEAD"]
            else:
                os.environ["PASERO_FUSED_HEAD"] = saved

    output_tokens = staticmethod(Workload.output_tokens)


def trace_profile(fn, path: str, kernel_names: tuple = ()) -> dict:
    """Run ``fn`` under torch.profiler and summarize its chrome trace
    (written to ``path``): wall time, the device's busy time and share (the
    union of kernel, copy and memset intervals), the device time of the 15
    largest operations, and launches and mean device time of each kernel
    whose name contains one of ``kernel_names``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    # union of device intervals (microseconds)
    busy, end = 0.0, None
    for s, d in sorted((e["ts"], e["dur"]) for e in device):
        if end is None or s > end:
            busy, end = busy + d, s + d
        elif s + d > end:
            busy, end = busy + s + d - end, s + d
    by_name: dict = {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    kernels = {}
    for key in kernel_names:
        durs = [e["dur"] for e in device if key in e["name"]]
        kernels[key] = {"launches": len(durs),
                        "device_us_mean": sum(durs) / max(len(durs), 1)}
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e3 / (wall * 1e3),
            "device_ops": len(device), "kernels": kernels,
            "top_device_ms": [(name[:90], us / 1e3) for name, us in top]}


# the port's kernels by a part of their names in a trace
KERNELS = {"slot_write": "slot_write_kernel",
           "int8_matmul": "int8_matmul_kernel",
           "fused_head_partials": "partials_kernel",
           "fused_head_combine": "combine_kernel"}


def profile(work, out_dir: str) -> dict:
    """Device busy share and device time by kernel over one decode."""
    out = trace_profile(work.run, os.path.join(out_dir, "profile_decode.json"),
                        tuple(KERNELS.values()))
    found = out.pop("kernels")
    for name, key in KERNELS.items():
        out[f"{name}_launches"] = found[key]["launches"]
        out[f"{name}_device_us_mean"] = found[key]["device_us_mean"]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="transformer",
                        choices=["transformer", "llama_1b"])
    parser.add_argument("--arch", default="transformer",
                        help="the MT arch (--model transformer)")
    parser.add_argument("--batch", type=int)
    parser.add_argument("--beam", type=int, default=5)
    parser.add_argument("--src-len", type=int, default=32)
    parser.add_argument("--prompt-len", type=int)
    parser.add_argument("--max-new", type=int, default=64)
    parser.add_argument("--vocab", type=int, default=32768)
    parser.add_argument("--quantize", choices=["int8"])
    parser.add_argument("--fused-head", action="store_true")
    parser.add_argument("--speculative", action="store_true")
    parser.add_argument("--prompt-style", default="copy",
                        choices=["copy", "random"])
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this benchmark measures a CUDA card and none is "
                         "available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    if args.model == "llama_1b":
        work = LMWorkload(args.batch or 8, args.prompt_len or 128,
                          args.max_new, args.prompt_style)
        work.fused_head, work.speculative = args.fused_head, args.speculative
        if args.quantize:
            work.quantize()
        shape = {"batch": args.batch or 8, "prompt_len": args.prompt_len or 128,
                 "max_new": args.max_new, "vocab": LMWorkload.VOCAB,
                 "quantize": args.quantize, "fused_head": args.fused_head,
                 "speculative": args.speculative,
                 "prompt_style": args.prompt_style,
                 "quantized_weights": work.quantized,
                 "quantized_mib": work.quantized_bytes[0] / 2 ** 20}
    else:
        work = Workload(args.arch, args.vocab, args.batch or 64, args.src_len,
                        args.prompt_len or 8, args.max_new, args.beam)
        shape = {"arch": args.arch, "batch": args.batch or 64,
                 "beam": args.beam, "src_len": args.src_len,
                 "prompt_len": args.prompt_len or 8,
                 "max_new": args.max_new, "vocab": args.vocab}
    work.run()                                       # warm-up
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = work.run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    tokens = work.output_tokens(out)
    best = min(times)
    result = {"card": smi, "model": args.model, **shape,
              "output_tokens": tokens, "model_calls": out["model_calls"],
              "seconds": times, "tok_per_s": tokens / best,
              "ms_per_decoder_call": best * 1e3 / out["model_calls"],
              "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
    if args.profile:
        result["profile"] = profile(work, os.path.join(ROOT, "build"))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
