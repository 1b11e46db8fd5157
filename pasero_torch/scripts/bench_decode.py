#!/usr/bin/env python3
"""Full-width decode benchmark and profile of the PyTorch port on one card
(the counterpart of scripts/bench_decode.py and scripts/profile_decode.py).

Transformer-base MT with weights from a numpy seed: B sentences of source
length S, beam K (1 = greedy), a left-aligned prompt bucket of P slots
holding BOS, and N new tokens, through Transformer.encode and
beam_search / sample_decode. Prints output tokens/s and ms per decoder
call; with --profile, also the device's busy share over one decode and the
device time by kernel, from the chrome trace of torch.profiler (written to
build/profile_decode.json).

    python -m pasero_torch.scripts.bench_decode [--batch 64] [--beam 5]
        [--src-len 32] [--prompt-len 8] [--max-new 64] [--vocab 32768]
        [--arch transformer] [--repeats 3] [--profile]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

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


def profile(work: Workload, out_dir: str) -> dict:
    """Device busy share and device time by kernel over one decode."""
    out = trace_profile(work.run, os.path.join(out_dir, "profile_decode.json"),
                        ("slot_write_kernel",))
    slot = out.pop("kernels")["slot_write_kernel"]
    out["slot_write_launches"] = slot["launches"]
    out["slot_write_device_us_mean"] = slot["device_us_mean"]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", default="transformer")
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--beam", type=int, default=5)
    parser.add_argument("--src-len", type=int, default=32)
    parser.add_argument("--prompt-len", type=int, default=8)
    parser.add_argument("--max-new", type=int, default=64)
    parser.add_argument("--vocab", type=int, default=32768)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this benchmark measures a CUDA card and none is "
                         "available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    work = Workload(args.arch, args.vocab, args.batch, args.src_len,
                    args.prompt_len, args.max_new, args.beam)
    work.run()                                       # warm-up
    times = []
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = work.run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    tokens = work.output_tokens(out)
    best = min(times)
    result = {"card": smi, "arch": args.arch, "batch": args.batch,
              "beam": args.beam, "src_len": args.src_len,
              "prompt_len": args.prompt_len, "max_new": args.max_new,
              "vocab": args.vocab, "output_tokens": tokens,
              "model_calls": out["model_calls"],
              "seconds": times, "tok_per_s": tokens / best,
              "ms_per_decoder_call": best * 1e3 / out["model_calls"]}
    if args.profile:
        result["profile"] = profile(work, os.path.join(ROOT, "build"))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
