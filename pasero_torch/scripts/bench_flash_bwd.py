#!/usr/bin/env python3
"""The flash-attention kernels on one card: device ms per call of the
forward, dq and dk/dv kernels (``flash_fwd``, ``flash_bwd_dq``,
``flash_bwd_dkv``) with a dense bias (ALiBi, the encoder's ALiBi, a seeded
bias shared over the batch, the heads or both), with T5's table and without
a bias, at the training shapes of bloom_560m, t5_base and llama_1b, at long
sequences and at the biased kernels' test shapes.

    python -m pasero_torch.scripts.bench_flash_bwd [--cases bloom_560m ...]

Run against another checkout (a parent commit, to compare two versions in
one call) from that checkout's root:

    PYTHONPATH=$PWD python /path/to/pasero_torch/scripts/bench_flash_bwd.py

It uses only the wrappers' public signatures, so it times whatever kernels
that checkout's wrappers launch. Each time is a CUDA graph of back-to-back
calls replayed between CUDA events (host launch costs left out). Prints one
JSON line: the card's name and power limit, then per case a list of its
readings (``--repeats``, the cases timed in turn), each with its shape and,
for the case's bias (if it has one) and without one, the ``--parts`` of the
forward, dq and dk/dv and, with both of the latter, the backward's sum. The
part "demb" (T5 cases) is the dq launch that also gives the T5 table's
gradient: the T5 dq kernel with its demb where the checkout's
``flash_bwd_dq`` takes ``table_grad``, else (an older checkout) the dq
kernel and the separate demb kernel together.
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
PARTS = ("fwd", "dq", "dkv")
ALL_PARTS = PARTS + ("demb",)


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


def inputs(B, H, Hkv, S, D, kind):
    """Seeded bf16 q, k, v, dO, an all-present key mask and the bias (None
    without one)."""
    from pasero_torch.models.positional import alibi_bias
    from pasero_torch.ops.flash_attention import T5Bias
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(B, h, S, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for h in (H, Hkv, Hkv, H))
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
    demb, or in a checkout without it the dq and the demb kernels."""
    from pasero_torch.ops import flash_attention as fa
    if "table_grad" in inspect.signature(fa.flash_bwd_dq).parameters:
        return lambda: fa.flash_bwd_dq(q, k, v, mask, out, lse, do, *args, t5,
                                       table_grad=True)

    def both():
        _, delta = fa.flash_bwd_dq(q, k, v, mask, out, lse, do, *args, t5)
        return fa.flash_bwd_demb(q, k, v, mask, t5, do, lse, delta, *args)
    return both


def time_demb(shape, causal=False, kind="t5", readings=3) -> dict:
    """At a T5 shape, device ms of the dq launch with the table's gradient
    ("fused_ms", ``dq_with_table_grad``) and of the dq kernel without it
    ("dq_ms"), read in turn ``readings`` times, medians."""
    from pasero_torch.ops.flash_attention import flash_bwd_dq, flash_fwd
    B, H, Hkv, S, D = shape
    q, k, v, do, mask, t5 = inputs(B, H, Hkv, S, D, kind)
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
              bias_free=True) -> dict:
    """Device ms of ``parts`` of the forward, dq and dk/dv (and, with both
    of dq and dk/dv, the backward's sum) at one shape, under the key
    ``kind`` with the bias and, with ``bias_free``, under "none" without
    it."""
    from pasero_torch.ops.flash_attention import (flash_bwd_dkv, flash_bwd_dq,
                                                  flash_fwd)
    B, H, Hkv, S, D = shape
    q, k, v, do, mask, bias = inputs(B, H, Hkv, S, D, kind)
    args = (D ** -0.5, causal, window)
    n, r = (2, 2) if S > 8192 else (10, 5)
    res = {"shape": list(shape), "causal": causal, "bias": kind,
           "window": window}
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
        times = {part: device_ms(calls[part], n, r) for part in parts
                 if part in calls}
        if "dq" in times and "dkv" in times:
            times["bwd"] = times["dq"] + times["dkv"]
        res[name] = times
        del out, lse, delta, calls
    del q, k, v, do, bias
    torch.cuda.empty_cache()
    return res


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cases", nargs="+", choices=sorted(CASES),
                        default=list(CASES))
    parser.add_argument("--parts", nargs="+", choices=ALL_PARTS,
                        default=PARTS)
    parser.add_argument("--repeats", type=int, default=1,
                        help="time every case this many times in turn")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this benchmark measures a CUDA card and none is "
                         "available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    result = {"card": smi, "cases": {name: [] for name in args.cases}}
    for _ in range(args.repeats):
        for name in args.cases:
            result["cases"][name].append(time_case(*CASES[name],
                                                   parts=args.parts))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
