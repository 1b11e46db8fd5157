#!/usr/bin/env python3
"""The int8 weight product (``int8_matmul``, csrc/int8_matmul.cu) and the
fused greedy heads (``fused_head_argmax``, csrc/fused_head.cu) on one card,
at llama_1b's weight shapes: device ms per call beside ``F.linear`` on the
same weight in bf16, and the sum over one llama_1b decoder call (22 layers
of seven weights and the head; at M = 1024 the 8 x 128-token prompt's).

    python -m pasero_torch.scripts.bench_int8 [--m 8 72 1024] [--heads]

(``--m 81 130 256`` for short prompts.)

Run against another checkout (a parent commit, to compare two versions in
one call) from that checkout's root:

    PYTHONPATH=$PWD python /path/to/pasero_torch/scripts/bench_int8.py

It uses only the wrappers' public signatures, so it times whatever kernels
that checkout's wrappers launch. Each time is a CUDA graph of back-to-back
calls replayed between CUDA events; the kernel's and the library's graphs
are replayed in turn, READINGS times each, and each time is the median of
its readings (``alternating_ms``). "ms" is read cold, as a decode reads its
weights: the graph walks distinct copies of the weight that hold more than
COLD_BYTES in all, so no call finds its weight in L2; "hot_ms" with one
weight that stays in L2. Prints one JSON line: the card's name and power
limit, then per row count M each shape's times and the decoder call's sums.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores, data sheet
COLD_BYTES = 100e6          # twice the H100's 50 MB L2
READINGS = 5                # readings of each graph, taken in turn
# llama_1b's int8 weights as (K, N) and their count in one decoder call: per
# layer q and o (2048, 2048), k and v (2048, 256), gate and up (2048, 5632),
# down (5632, 2048), over 22 layers; the untied head (2048, 32000) once
LAYERS = 22
HEAD = (2048, 32000)
LLAMA_1B_WEIGHTS = {(2048, 2048): 2 * LAYERS, (2048, 256): 2 * LAYERS,
                    (2048, 5632): 2 * LAYERS, (5632, 2048): LAYERS, HEAD: 1}


def cold_copies(nbytes: float) -> int:
    """Distinct copies of an operand of ``nbytes`` that hold more than
    COLD_BYTES in all, so that a call walking them in turn finds its copy
    outside L2 (one more than the bytes need: a graph's last call reads the
    copy before the first call of its next replay)."""
    return max(2, math.ceil(COLD_BYTES / nbytes) + 1)


def walking(fn, operands: list):
    """A call of ``fn`` on the next of ``operands`` each time, in turn."""
    at = [0]

    def call():
        i = at[0]
        at[0] = (i + 1) % len(operands)
        return fn(operands[i])
    return call


def eager_ms(fn, iters: int, warmup: int = 10) -> float:
    """Mean ms per call of ``fn`` over ``iters`` back-to-back eager calls
    between CUDA events, after a warm-up: the host's launch cost where it
    exceeds the device's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternating_ms(fns: dict, iters: int, replays: int = 5,
                   readings: int = READINGS) -> dict:
    """Device ms per call of each of ``fns`` (name: call): ``iters`` calls
    of each captured in its own CUDA graph, then the graphs replayed in
    turn, ``replays`` times a reading between CUDA events, for ``readings``
    rounds. Returns per name the median and the readings, so that a drift
    of the card between readings falls on every side alike."""
    graphs = {}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns.values():
            for _ in range(2):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    for name, fn in fns.items():
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(iters):
                fn()
        graphs[name].replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = {name: [] for name in fns}
    for _ in range(readings):
        for name, graph in graphs.items():
            start.record()
            for _ in range(replays):
                graph.replay()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / (iters * replays))
    return {name: (statistics.median(ts), ts) for name, ts in times.items()}


def int8_inputs(M, K, N, seed=0, device="cuda"):
    """Seeded bf16 x (M, K) and a QTensor (N, K) whose rows span three
    decades of magnitude, so that another row's scale is far off."""
    from pasero_torch.ops.quantize import quantize
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(M, K, generator=gen, device=device).to(torch.bfloat16)
    mag = torch.logspace(-2, 1, N, device=device)[
        torch.randperm(N, generator=gen, device=device)]
    w = torch.randn(N, K, generator=gen, device=device) * mag[:, None] \
        * K ** -0.5
    return x, quantize(w)


def bound(nbytes: float, flops: float) -> dict:
    mem, ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return {"bound_ms": max(mem, ops) * 1e3,
            "bound_by": "bytes" if mem > ops else "operations"}


def record(res: dict, timed: dict) -> None:
    """``alternating_ms`` results into ``res``: each median under its name,
    the cold readings beside as ``*_readings``."""
    for name, (ms, readings) in timed.items():
        res[name] = ms
        if not name.endswith("hot_ms"):
            res[f"{name}_readings"] = readings


def int8_timing(M, K, N) -> dict:
    """The int8 kernel's device ms per call at (M, K, N) with a bf16 output,
    cold ("ms") and hot ("hot_ms"), beside the library yardstick F.linear
    on the same weight in bf16 (cold and hot; the port never calls it), all
    four read in turn (``alternating_ms``), the bound (its bytes: x, the
    int8 weight and scales read once, y written once; or its operations),
    the plain version's time and both eager times."""
    import torch.nn.functional as F
    from pasero_torch.ops.quantize import (QTensor, dequantize, int8_matmul,
                                           int8_matmul_plain)
    x, t = int8_inputs(M, K, N)
    wb = dequantize(t, torch.bfloat16)
    # CUDA graphs keep every output of the captured calls: bound their bytes
    iters = int(min(100, max(5, 2e9 / (M * N * 4 + N * K * 4))))
    res = {"shape": [M, K, N], **bound(M * K * 2 + N * K + N * 4 + M * N * 2,
                                       2.0 * M * N * K)}
    copies = cold_copies(N * K)
    ts = [t] + [QTensor(t.q.clone(), t.scale.clone())
                for _ in range(copies - 1)]
    wbs = [wb] + [wb.clone() for _ in range(copies - 1)]
    res["copies"] = copies
    record(res, alternating_ms({
        "ms": walking(lambda w: int8_matmul(x, w), ts),
        "library_ms": walking(lambda w: F.linear(x, w), wbs)},
        max(iters, copies)))
    record(res, alternating_ms({"hot_ms": lambda: int8_matmul(x, t),
                                "library_hot_ms": lambda: F.linear(x, wb)},
                               iters))
    del ts, wbs
    res["plain_ms"] = alternating_ms({"plain": lambda: int8_matmul_plain(
        x, t.q, t.scale, torch.bfloat16)}, iters, readings=1)["plain"][0]
    res["host_ms"] = eager_ms(lambda: int8_matmul(x, t), 4 * iters)
    res["library_host_ms"] = eager_ms(lambda: F.linear(x, wb), 4 * iters)
    torch.cuda.empty_cache()
    return res


def decoder_call(timings: list) -> dict:
    """One llama_1b decoder call's sums over its layers' weights
    (``layer_weights`` of them) and the head (LLAMA_1B_WEIGHTS) of the
    kernel's and the library's cold times and of the bounds, from
    ``int8_timing`` results at one M that cover its five shapes."""
    by_shape = {tuple(r["shape"][1:]): r for r in timings}
    out = {"layer_weights": sum(n for kn, n in LLAMA_1B_WEIGHTS.items()
                                if kn != HEAD)}
    for key in ("ms", "library_ms", "bound_ms"):
        out[key] = sum(n * by_shape[kn][key]
                       for kn, n in LLAMA_1B_WEIGHTS.items())
    return out


def head_timing(N, E, V, q8: bool) -> dict:
    """The fused head's device ms per call (CUDA graph), cold ("ms") over
    distinct copies of the head as int8_timing walks them and hot
    ("hot_ms") on one head, beside the library yardstick (matmul, argmax
    and log_softmax on materialized bf16 logits), all four read in turn,
    the bound and the plain version's time."""
    from pasero_torch.ops.fused_ce import (fused_head_argmax,
                                           fused_head_argmax_plain)
    from pasero_torch.ops.quantize import QTensor, dequantize
    x, t = int8_inputs(N, E, V, seed=1)
    wb = dequantize(t, torch.bfloat16)
    head = t if q8 else wb
    iters = int(min(100, max(5, 2e9 / (N * V * 8 + V * E * 4))))

    def library(w):     # the port never calls it
        logits = torch.matmul(x, w.t()).float()
        tok = logits.argmax(-1)
        return tok, torch.log_softmax(logits, -1).gather(1, tok[:, None])

    res = {"shape": [N, E, V], **bound(
        N * E * 2 + V * E * (1 if q8 else 2) + (V * 4 if q8 else 0) + N * 12,
        2.0 * N * E * V)}
    copies = cold_copies(V * E * (1 if q8 else 2))
    heads = [head] + [QTensor(t.q.clone(), t.scale.clone()) if q8 else
                      wb.clone() for _ in range(copies - 1)]
    wbs = [wb] + [wb.clone() for _ in range(cold_copies(V * E * 2) - 1)]
    res["copies"] = copies
    record(res, alternating_ms({
        "ms": walking(lambda h: fused_head_argmax(x, h), heads),
        "library_ms": walking(library, wbs)},
        max(iters, copies, len(wbs))))
    record(res, alternating_ms({
        "hot_ms": lambda: fused_head_argmax(x, head),
        "library_hot_ms": lambda: library(wb)}, iters))
    del heads, wbs
    res["plain_ms"] = alternating_ms({"plain": lambda: fused_head_argmax_plain(
        x, head)}, iters, readings=1)["plain"][0]
    torch.cuda.empty_cache()
    return res


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--m", type=int, nargs="+", default=[8, 72, 1024],
                        help="rows of x (decode 8, a speculative chunk 72, "
                             "short prompts 81-256, the prompt 1024)")
    parser.add_argument("--heads", action="store_true",
                        help="also the fused heads (bf16 and int8) at each M")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this benchmark measures a CUDA card and none is "
                         "available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    result = {"card": smi, "by_m": {}}
    for M in args.m:
        shapes = [int8_timing(M, K, N) for K, N in LLAMA_1B_WEIGHTS]
        entry = {"shapes": shapes, "decoder_call": decoder_call(shapes)}
        if args.heads:
            entry["heads"] = {("int8" if q8 else "bf16"): head_timing(
                M, 2048, 32000, q8) for q8 in (False, True)}
        result["by_m"][str(M)] = entry
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
