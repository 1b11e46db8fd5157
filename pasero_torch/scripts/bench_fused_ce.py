#!/usr/bin/env python3
"""The fused cross-entropy's kernels (csrc/fused_ce.cu) on one card: device
ms per call of the forward (``fused_ce_fwd``) and the backward
(``fused_ce_bwd``) at the main path's heads, beside the library call
(``F.cross_entropy`` of ``torch.matmul`` logits: its forward, and its
backward alone) and the operations bound.

    python -m pasero_torch.scripts.bench_fused_ce [--heads t5_base] [--dtype float32]

Run against another checkout (a parent commit, to compare two versions in
one call) from that checkout's root:

    PYTHONPATH=$PWD python /path/to/pasero_torch/scripts/bench_fused_ce.py

It uses only the wrappers' public signatures, so it times whatever kernels
that checkout's wrappers launch. Each time is a CUDA graph of back-to-back
calls replayed between CUDA events; the kernels' and the library's graphs
are replayed in turn, READINGS times each (``alternating_ms`` of
bench_int8.py), and each time is the median of its readings. The bound is
the least of the function's operations at the card's rate for the type (in
float32: as three TF32 products at 495 TFLOP/s, or on the CUDA cores at 67
TFLOP/s) and its bytes. Prints one JSON line: the card's name and power
limit, then per head its shape, type and times.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from pasero_torch.scripts.bench_int8 import (BF16_FLOPS, FP32_FLOPS,
                                             FP32_TC_FLOPS, HBM_BYTES_PER_S,
                                             alternating_ms, eager_ms)

# the main path's heads (B*T, E, V), each timed by chip_smoke.py's phase 4
HEADS = {"transformer_base": (16384, 512, 32000),
         "llama_1b": (8192, 2048, 32000),       # untied head
         "bloom_560m": (8192, 1024, 250880),    # N V near 2^31
         "t5_base": (4096, 768, 32128),         # 32 x 128 targets
         "whisper_base": (2048, 512, 51865)}    # Whisper's odd vocab
GRAPH_MS = 50.0              # device ms a graph of one function should hold


def inputs(N, E, V, dtype, seed=0):
    """x (N, E) in ``dtype`` with a per-row scale in [0.5, 2), so that lse
    differs from row to row and a gradient built with another row's lse is
    told apart; w (V, E) in float32, targets, and 0/1 row weights."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scale = 0.5 + 1.5 * torch.rand(N, 1, generator=gen, device="cuda")
    x = (torch.randn(N, E, generator=gen, device="cuda") * scale).to(dtype)
    w = torch.randn(V, E, generator=gen, device="cuda") * E ** -0.5
    t = torch.randint(0, V, (N,), generator=gen, device="cuda")
    wt = (torch.rand(N, generator=gen, device="cuda") >= 0.1).float()
    return x, w, t, wt


def bounds(N, E, V, dtype) -> dict:
    """The forward's (one product) and the backward's (three: the logits
    recomputed once feed dx and dW) bounds: the larger of the bytes at the
    memory rate and the operations at the least time of the type's rates
    (float32: split TF32 on the tensor cores, or the CUDA cores)."""
    size = torch.empty((), dtype=dtype).element_size()
    flops = 2.0 * N * E * V
    rates = ({"tf32x3": FP32_TC_FLOPS, "fp32": FP32_FLOPS}
             if dtype == torch.float32 else {"bf16": BF16_FLOPS})
    # x and W read, targets and (lse, target logit, logits sum) or (lse,
    # c1, c2, c3), dx in x's type and dW in float32 written
    io = {"fwd": (N + V) * E * size + 4 * N * 4,
          "bwd": (2 * N + V) * E * size + 5 * N * 4 + V * E * 4}
    out = {}
    for key, products in (("fwd", 1), ("bwd", 3)):
        ops = {name: products * flops / rate * 1e3
               for name, rate in rates.items()}
        mem = io[key] / HBM_BYTES_PER_S * 1e3
        least = min(ops.values())
        out[key] = {"bound_ms": max(least, mem),
                    "bound_by": "operations" if least >= mem else "bytes",
                    "bytes_bound_ms": mem,
                    **{f"{name}_ops_bound_ms": ms for name, ms in ops.items()}}
    return out


def head_timing(name: str, dtype) -> dict:
    from pasero_torch.ops.fused_ce import fused_ce_bwd, fused_ce_fwd
    N, E, V = HEADS[name]
    x, w, t, wt = inputs(N, E, V, dtype)
    w, c = w.to(dtype), wt * 0.5
    lse = fused_ce_fwd(x, w, t)[0]
    leaves = [x.clone().requires_grad_(), w.clone().requires_grad_()]

    def library(xi, wi):       # one library call; the port never calls it
        logits = torch.matmul(xi, wi.t()).float()
        return (F.cross_entropy(logits, t, reduction="none",
                                label_smoothing=0.1) * c).sum()

    fns = {"fwd": lambda: fused_ce_fwd(x, w, t),
           "bwd": lambda: fused_ce_bwd(x, w, t, lse, c, c, c / V),
           "library_fwd": lambda: library(x, w),
           "library_both": lambda: torch.autograd.grad(library(*leaves),
                                                       leaves)}
    res = {"shape": [N, E, V], "dtype": str(dtype).replace("torch.", ""),
           **bounds(N, E, V, dtype)}
    # as many calls a graph as fill about GRAPH_MS, from the slowest
    # function's eager time
    slowest = max(eager_ms(fn, 2, 1) for fn in fns.values())
    timed = alternating_ms(fns, max(1, min(50, round(GRAPH_MS / slowest))),
                           replays=2)
    for key in ("fwd", "bwd"):
        res[key]["ms"], res[key]["readings"] = timed[key]
    res["fwd"]["library_ms"] = timed["library_fwd"][0]
    res["bwd"]["library_ms"] = (timed["library_both"][0]
                                - timed["library_fwd"][0])
    return res


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--heads", nargs="+", default=["t5_base"],
                        choices=sorted(HEADS))
    parser.add_argument("--dtype", default="float32",
                        choices=["bfloat16", "float32"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this benchmark measures a CUDA card and none is "
                         "available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dtype = getattr(torch, args.dtype)
    result = {"card": smi,
              "heads": {name: head_timing(name, dtype) for name in args.heads}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
