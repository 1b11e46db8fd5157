#!/usr/bin/env python3
"""The KV-cache slot write (``cache_slot_write_``, csrc/cache_update.cu) on
one card at the decode shapes the main path gives it: device ms per call
beside the launch floor (``cache_slot_write_floor``: an empty kernel with
the write's grid, block and programmatic launch attribute), the library's
two ``copy_`` calls, the plain version and the bytes bound.

    python -m pasero_torch.scripts.bench_cache_update

Each time is a CUDA graph of ITERS back-to-back calls on the same operands
(they stay in L2, as the new blocks do after their projection), the graphs
replayed in turn, READINGS times each, the median of the readings
(``alternating_ms``); the eager times beside are CUDA events over
back-to-back launches.

Run against another checkout (a parent commit, to compare two versions in
one call) from that checkout's root:

    PYTHONPATH=$PWD python /path/to/pasero_torch/scripts/bench_cache_update.py

It times that checkout's wrapper; where it lacks the floor, the floor's
time prints as null. Prints one JSON line: the card's name and power
limit, then per shape the times.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from pasero_torch.ops import cache_update
from pasero_torch.scripts.bench_int8 import (HBM_BYTES_PER_S, alternating_ms,
                                             eager_ms)

# (R, H, L, D): transformer-base's beam-5 decode (64 sentences x beam 5,
# 8 heads, 72 slots), llama_1b's decode (8 prompts, 4 K/V heads, 192 slots)
SHAPES = {"transformer_base": (320, 8, 72, 64), "llama_1b": (8, 4, 192, 64)}
ITERS = 200


def operands(shape, dtype=torch.bfloat16, seed=0):
    """Seeded caches and contiguous new blocks of ``shape`` on the card."""
    R, H, L, D = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    k_new, v_new = (torch.randn((R, H, 1, D), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
    return k, v, k_new, v_new


def write_timing(shape) -> dict:
    """Times of the write at ``shape`` (bf16, slot L // 2): the kernel's,
    the floor's, the plain version's and the library's, as medians of
    graphs read in turn; the eager times and the bytes bound beside."""
    k, v, k_new, v_new = operands(shape)
    i = shape[2] // 2
    args = (k, v, k_new, v_new, i)
    fns = {"ms": lambda: cache_update.cache_slot_write_(*args),
           "plain_ms": lambda: cache_update.cache_slot_write_plain(*args),
           # one PyTorch call per cache; the port never calls it
           "library_ms": lambda: (k[:, :, i].copy_(k_new[:, :, 0]),
                                  v[:, :, i].copy_(v_new[:, :, 0]))}
    floor = getattr(cache_update, "cache_slot_write_floor", None)
    if floor is not None:
        fns["floor_ms"] = lambda: floor(*args)
    res = {"shape": list(shape), "dtype": "bfloat16",
           "floor_ms": None}
    for name, (median, readings) in alternating_ms(fns, ITERS).items():
        res[name] = median
        res[name[:-2] + "readings"] = readings
    nbytes = 4 * k_new.numel() * k_new.element_size()
    res.update(bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes",
               host_ms=eager_ms(fns["ms"], 2000),
               plain_host_ms=eager_ms(fns["plain_ms"], 2000),
               library_host_ms=eager_ms(fns["library_ms"], 2000))
    return res


def main(argv=None):
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this benchmark measures a CUDA card and none is "
                         "available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    result = {"card": smi,
              "shapes": {name: write_timing(shape)
                         for name, shape in SHAPES.items()}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
