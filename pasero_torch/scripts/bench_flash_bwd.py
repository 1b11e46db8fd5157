#!/usr/bin/env python3
"""The flash-attention kernels on one card: device ms per call of the
forward, dq and dk/dv kernels (``flash_fwd``, ``flash_bwd_dq``,
``flash_bwd_dkv``) with a dense bias (ALiBi, the encoder's ALiBi, a seeded
bias shared over the batch, the heads or both), with T5's table and without
a bias, at the training shapes of bloom_560m, t5_base and llama_1b, at long
sequences and at the biased kernels' test shapes.

    python -m pasero_torch.scripts.bench_flash_bwd [--cases bloom_560m ...]
    python -m pasero_torch.scripts.bench_flash_bwd --dtype float32 --parts dq dkv

With ``--dtype float32`` the operands are float32 (the kernels of
csrc/flash_f32.cu) and the cases default to F32_CASES, chip_smoke.py's
F32_TIMED shapes, each timed with its bias only.

Run against another checkout (a parent commit, to compare two versions in
one call) from that checkout's root:

    PYTHONPATH=$PWD python /path/to/pasero_torch/scripts/bench_flash_bwd.py

It uses only the wrappers' public signatures, so it times whatever kernels
that checkout's wrappers launch. Each time is a CUDA graph of back-to-back
calls replayed between CUDA events (host launch costs left out). Prints one
JSON line: the card's name and power limit, then per case a list of its
readings (``--repeats``, the cases timed in turn), each with its shape and,
for the case's bias (if it has one) and without one, the ``--parts`` of the
forward, dq and dk/dv and, with both of the latter, the backward's sum;
with ``--profile``, the device kernels of one call of each part by name. The
part "demb" (T5 cases) is the dq launch that also gives the T5 table's
gradient, in either type: the T5 dq kernel with its demb where the
checkout's ``flash_bwd_dq`` takes ``table_grad`` for that type, else (an
older checkout) the dq kernel and the separate demb kernel together. The
part "dbias" (dense-bias cases) is the dbias kernel.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess

import torch

# (B, H, Hkv, S, D), causal, bias, window: bias "alibi" (per-sample causal
# ALiBi, max bias 8), "alibi16" (max bias 16), "encoder" (the encoder's
# half-head ALiBi, rows of -1e9), "learned_1xH", "Bx1", "1x1" (a seeded
# normal bias shared over the batch, the heads or both), "t5" (a
# bidirectional table), "t5_causal" (a unidirectional one) or None
CASES = {
    "bloom_560m": ((4, 16, 16, 2048, 64), True, "alibi", None),
    "alibi_16500": ((1, 2, 2, 16500, 128), True, "alibi16", None),
    "bias_1xH": ((2, 8, 8, 1000, 128), True, "learned_1xH", None),
    "bias_1xH_window": ((2, 16, 4, 777, 64), True, "learned_1xH", 256),
    "bias_Bx1": ((2, 8, 8, 1000, 128), False, "Bx1", None),
    "bias_1x1": ((3, 4, 2, 45, 32), True, "1x1", None),
    "encoder": ((2, 16, 16, 500, 64), False, "encoder", None),
    # bloom_560m's 8192 tokens a batch at two of the training data's length
    # buckets (data/batching.py's length_buckets), whose keys are not a
    # multiple of 4
    "alibi_bucket_143": ((57, 16, 16, 143, 64), True, "alibi", None),
    "alibi_bucket_315": ((26, 16, 16, 315, 64), True, "alibi", None),
    "t5_base": ((32, 12, 12, 512, 64), False, "t5", None),
    "t5_decoder": ((32, 12, 12, 128, 64), True, "t5_causal", None),
    "t5_32768": ((1, 12, 12, 32768, 64), False, "t5", None),
    "llama_1b": ((4, 32, 4, 2048, 64), True, None, None),
    "llama_32768": ((1, 32, 32, 32768, 128), True, None, None),
}
# float32: chip_smoke.py's F32_TIMED shapes (rows 10 and 13, 9, 12 and 15,
# 11 and 14 of PERF.md's table), and row 15's shape with a bias shared over
# the batch
F32_CASES = {
    "f32_gqa": ((2, 8, 2, 2048, 64), True, None, None),
    "f32_alibi": ((2, 8, 8, 2048, 64), True, "alibi", None),
    "f32_bias_1xH": ((2, 8, 8, 2048, 64), True, "learned_1xH", None),
    "f32_t5": ((8, 12, 12, 512, 64), False, "t5", None),
}
PARTS = ("fwd", "dq", "dkv")
ALL_PARTS = PARTS + ("demb", "dbias")


def device_ms(fn, iters: int, replays: int) -> float:
    """Mean device ms per call of ``fn``: ``iters`` calls in one CUDA graph,
    replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def inputs(B, H, Hkv, S, D, kind, dtype=torch.bfloat16):
    """Seeded q, k, v, dO in ``dtype``, an all-present key mask and the bias
    (None without one)."""
    from pasero_torch.models.positional import alibi_bias
    from pasero_torch.ops.flash_attention import T5Bias
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(B, h, S, D, generator=gen, device="cuda")
                   .to(dtype) for h in (H, Hkv, Hkv, H))
    mask = torch.ones(B, S, dtype=torch.bool, device="cuda")
    if kind is None:
        return q, k, v, do, mask, None
    if kind in ("t5", "t5_causal"):
        table = 0.5 * torch.randn(32, H, generator=gen, device="cuda")
        return q, k, v, do, mask, T5Bias(table, kind == "t5")
    if kind in ("learned_1xH", "Bx1", "1x1"):
        b0, h0 = {"learned_1xH": (1, H), "Bx1": (B, 1), "1x1": (1, 1)}[kind]
        return q, k, v, do, mask, 2 * torch.randn(b0, h0, S, S, generator=gen,
                                                  device="cuda")
    pos = torch.arange(S, device="cuda")[None].expand(B, S)
    return q, k, v, do, mask, alibi_bias(H, pos, pos,
                                         16 if kind == "alibi16" else 8,
                                         causal=kind != "encoder")


def dq_with_table_grad(q, k, v, mask, out, lse, do, args, t5):
    """A call that gives dq and the T5 table's gradient: the dq kernel's own
    demb, or in a checkout without it (for q's type) the dq and the demb
    kernels."""
    from pasero_torch.ops import flash_attention as fa

    def fused():
        return fa.flash_bwd_dq(q, k, v, mask, out, lse, do, *args, t5,
                               table_grad=True)
    if "table_grad" in inspect.signature(fa.flash_bwd_dq).parameters:
        try:   # an older checkout refuses float32 here
            fused()
            return fused
        except ValueError:
            pass

    def both():
        _, delta = fa.flash_bwd_dq(q, k, v, mask, out, lse, do, *args, t5)
        return fa.flash_bwd_demb(q, k, v, mask, t5, do, lse, delta, *args)
    return both


def time_demb(shape, causal=False, kind="t5", readings=3,
              dtype=torch.bfloat16) -> dict:
    """At a T5 shape in ``dtype``, device ms of the dq launch with the
    table's gradient ("fused_ms", ``dq_with_table_grad``) and of the dq
    kernel without it ("dq_ms"), read in turn ``readings`` times,
    medians."""
    from pasero_torch.ops.flash_attention import flash_bwd_dq, flash_fwd
    B, H, Hkv, S, D = shape
    q, k, v, do, mask, t5 = inputs(B, H, Hkv, S, D, kind, dtype)
    args = (D ** -0.5, causal, None)
    n, r = (2, 2) if S > 8192 else (10, 5)
    out, lse = flash_fwd(q, k, v, mask, *args, t5)
    calls = {"fused_ms": dq_with_table_grad(q, k, v, mask, out, lse, do,
                                            args, t5),
             "dq_ms": lambda: flash_bwd_dq(q, k, v, mask, out, lse, do,
                                           *args, t5)}
    times = {name: [] for name in calls}
    for _ in range(readings):
        for name, fn in calls.items():
            times[name].append(device_ms(fn, n, r))
    del q, k, v, do, out, lse, calls
    torch.cuda.empty_cache()
    return {name: statistics.median(ts) for name, ts in times.items()}


def time_case(shape, causal, kind, window=None, parts=PARTS,
              bias_free=True, dtype=torch.bfloat16) -> dict:
    """Device ms of ``parts`` of the forward, dq and dk/dv (and, with both
    of dq and dk/dv, the backward's sum) at one shape in ``dtype``, under
    the key ``kind`` with the bias and, with ``bias_free``, under "none"
    without it."""
    from pasero_torch.ops.flash_attention import (flash_bwd_dbias,
                                                  flash_bwd_dkv, flash_bwd_dq,
                                                  flash_fwd)
    B, H, Hkv, S, D = shape
    q, k, v, do, mask, bias = inputs(B, H, Hkv, S, D, kind, dtype)
    args = (D ** -0.5, causal, window)
    n, r = (2, 2) if S > 8192 else (10, 5)
    res = {"shape": list(shape), "causal": causal, "bias": kind,
           "window": window, "dtype": str(dtype).split(".")[-1]}
    runs = [(kind, bias)] if kind is not None else []
    if bias_free or kind is None:
        runs.append(("none", None))
    for name, b in runs:
        out, lse = flash_fwd(q, k, v, mask, *args, b)
        _, delta = flash_bwd_dq(q, k, v, mask, out, lse, do, *args, b)
        calls = {
            "fwd": lambda: flash_fwd(q, k, v, mask, *args, b),
            "dq": lambda: flash_bwd_dq(q, k, v, mask, out, lse, do, *args, b),
            "dkv": lambda: flash_bwd_dkv(q, k, v, mask, do, lse, delta, *args,
                                         b)}
        if name in ("t5", "t5_causal"):
            calls["demb"] = dq_with_table_grad(q, k, v, mask, out, lse, do,
                                               args, b)
        elif name != "none":
            calls["dbias"] = lambda: flash_bwd_dbias(q, k, v, mask, b, do,
                                                     lse, delta, *args)
        times = {part: device_ms(calls[part], n, r) for part in parts
                 if part in calls}
        if "dq" in times and "dkv" in times:
            times["bwd"] = times["dq"] + times["dkv"]
        res[name] = times
        del out, lse, delta, calls
    del q, k, v, do, bias
    torch.cuda.empty_cache()
    return res


def profile_case(shape, causal, kind, window=None, parts=PARTS,
                 dtype=torch.bfloat16) -> dict:
    """The device kernels that one call of each of ``parts`` launches at
    one shape with the case's bias, by name, with their device ms
    (torch.profiler): which kernels a call runs, and nothing else."""
    from torch.profiler import ProfilerActivity, profile

    from pasero_torch.ops.flash_attention import (flash_bwd_dkv, flash_bwd_dq,
                                                  flash_fwd)
    B, H, Hkv, S, D = shape
    q, k, v, do, mask, bias = inputs(B, H, Hkv, S, D, kind, dtype)
    args = (D ** -0.5, causal, window)
    out, lse = flash_fwd(q, k, v, mask, *args, bias)
    _, delta = flash_bwd_dq(q, k, v, mask, out, lse, do, *args, bias)
    calls = {"fwd": lambda: flash_fwd(q, k, v, mask, *args, bias),
             "dq": lambda: flash_bwd_dq(q, k, v, mask, out, lse, do, *args,
                                        bias),
             "dkv": lambda: flash_bwd_dkv(q, k, v, mask, do, lse, delta,
                                          *args, bias)}
    res = {}
    for part in parts:
        if part not in calls:
            continue
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            calls[part]()
            torch.cuda.synchronize()
        kernels = {}
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                kernels[evt.name] = kernels.get(evt.name, 0.0) + \
                    evt.time_range.elapsed_us() / 1e3
        res[part] = kernels
    del q, k, v, do, out, lse, delta, calls
    torch.cuda.empty_cache()
    return res


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cases", nargs="+",
                        choices=sorted(CASES) + sorted(F32_CASES))
    parser.add_argument("--dtype", choices=("bfloat16", "float32"),
                        default="bfloat16")
    parser.add_argument("--parts", nargs="+", choices=ALL_PARTS,
                        default=PARTS)
    parser.add_argument("--repeats", type=int, default=1,
                        help="time every case this many times in turn")
    parser.add_argument("--profile", action="store_true",
                        help="also name the device kernels of one call of "
                             "each part (torch.profiler)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this benchmark measures a CUDA card and none is "
                         "available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dtype = getattr(torch, args.dtype)
    f32 = dtype == torch.float32
    cases = {**CASES, **F32_CASES}
    names = args.cases or list(F32_CASES if f32 else CASES)
    result = {"card": smi, "cases": {name: [] for name in names}}
    for _ in range(args.repeats):
        for name in names:
            result["cases"][name].append(time_case(
                *cases[name], parts=args.parts, bias_free=not f32,
                dtype=dtype))
    if args.profile:
        result["profile"] = {name: profile_case(*cases[name],
                                                parts=args.parts, dtype=dtype)
                             for name in names}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
