#!/usr/bin/env python3
"""Smoke test of the PyTorch port (pasero_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

0. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
   nvcc build of every kernel source in pasero_torch/csrc, all started
   together;
1. each kernel against its plain PyTorch version on the card, bitwise, at
   the full-width decode shape and an odd shape, and its time beside the
   plain version's, one PyTorch library call's and the memory bound: device
   time per call from a CUDA graph of many calls ("ms"), and time per call
   with eager launches ("host_ms");
2. the main path through the entry point a user calls:
   TextGenerator.build("models/deen-mini2").decode(test.de) with beam 5 on
   the card, held against the JAX package's committed output
   (pasero_torch/testdata), with the kernel's launch count checked against
   the decoder calls;
3. full width: transformer (base) with a 32768 vocabulary and weights from
   numpy seed 0, 64 sentences x beam 5, source length 32, a prompt bucket
   of 8 and 64 new tokens, through Transformer.encode and beam_search.

The second-to-last line is one JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}. Without CUDA the script exits 1 and
prints no result.
"""

from __future__ import annotations

import concurrent.futures
import glob
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
GOLDEN = os.path.join(ROOT, "pasero_torch", "testdata",
                      "deen_mini2_test_beam5.jax.txt")
MIN_GOLDEN_MATCH = 57


def log(*args):
    print(*args, flush=True)


def fail(message: str):
    print(f"FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, message: str):
    if not cond:
        fail(message)


def time_ms(fn, iters: int, warmup: int = 10) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` back-to-back
    calls, between CUDA events, after a warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 200, replays: int = 20) -> float:
    """Mean device milliseconds per call of ``fn``: ``iters`` calls captured
    in one CUDA graph, replayed between CUDA events, so host launch costs
    are left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


# -- phase 0 -------------------------------------------------------------------

def phase0():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"python {sys.version.split()[0]} | torch {torch.__version__} | "
        f"CUDA {torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    from pasero_torch.ops import cuda_build
    sources = sorted(os.path.splitext(os.path.basename(p))[0]
                     for p in glob.glob(os.path.join(cuda_build.CSRC, "*.cu")))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        paths = list(pool.map(cuda_build.build, sources))
    log(f"phase 0: built {len(paths)} kernel source(s) {sources} in "
        f"{time.perf_counter() - t0:.2f} s")


# -- phase 1 -------------------------------------------------------------------

def phase1() -> dict:
    """cache_slot_write_ against its plain version; returns its timings at
    the full-width decode shape."""
    import torch
    from pasero_torch.ops.cache_update import (cache_slot_write_,
                                               cache_slot_write_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = None
    # the full-width decode shape (B*K, H, P+new, D) takes the 16-byte path;
    # rows of 72 bytes (D*itemsize not a multiple of 16) take the scalar ones
    shapes = [((320, 8, 72, 64), torch.bfloat16),
              ((3, 4, 17, 18), torch.float32),
              ((3, 4, 17, 36), torch.bfloat16)]
    max_err = 0.0
    for shape, dtype in shapes:
        R, H, L, D = shape
        base_k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        base_v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        for index in (0, L // 2, L - 1):
            k_new = torch.randn((R, 1, H, D), generator=gen,
                                device="cuda").transpose(1, 2)  # as attention
            v_new = torch.randn((R, 1, H, D), generator=gen,
                                device="cuda").transpose(1, 2)
            k1, v1 = base_k.clone(), base_v.clone()
            k2, v2 = base_k.clone(), base_v.clone()
            cache_slot_write_(k1, v1, k_new.to(dtype), v_new.to(dtype), index)
            cache_slot_write_plain(k2, v2, k_new.to(dtype), v_new.to(dtype),
                                   index)
            torch.cuda.synchronize()
            check(torch.equal(k1, k2) and torch.equal(v1, v2),
                  f"cache_slot_write_ differs from the plain version at "
                  f"{shape} {dtype} index {index}")
            max_err = max(max_err, (k1.float() - k2.float()).abs().max().item(),
                          (v1.float() - v2.float()).abs().max().item())
        log(f"phase 1: cache_slot_write_ == plain bitwise at {shape} {dtype}, "
            f"indices 0, {L // 2}, {L - 1}")

        if result is None:   # time at the full-width decode shape
            k_new = k_new.to(dtype).contiguous()
            v_new = v_new.to(dtype).contiguous()
            i = L // 2
            fns = {
                "": lambda: cache_slot_write_(base_k, base_v, k_new, v_new, i),
                "plain_": lambda: cache_slot_write_plain(base_k, base_v,
                                                         k_new, v_new, i),
                # one PyTorch call per cache; the port never calls it
                "library_": lambda: (base_k[:, :, i].copy_(k_new[:, :, 0]),
                                     base_v[:, :, i].copy_(v_new[:, :, 0])),
            }
            nbytes = 4 * R * H * D * base_k.element_size()
            result = {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bytes": nbytes}
            for prefix, fn in fns.items():
                result[f"{prefix}ms"] = device_ms(fn)
                result[f"{prefix}host_ms"] = time_ms(fn, 2000)
            log(f"phase 1: at {shape} {dtype}, device ms per call (CUDA "
                f"graph): kernel {result['ms']:.6f} plain "
                f"{result['plain_ms']:.6f} library {result['library_ms']:.6f}"
                f" bound {result['bound_ms']:.6f} ({nbytes} B); with eager "
                f"launches: kernel {result['host_ms']:.6f} plain "
                f"{result['plain_host_ms']:.6f} library "
                f"{result['library_host_ms']:.6f}")
    result["max_abs_err"] = max_err
    return result


# -- phase 2 -------------------------------------------------------------------

def phase2() -> int:
    import torch
    from pasero_torch.decoding.generator import TextGenerator
    from pasero_torch.ops.cache_update import cache_slot_write_
    data = os.path.join(ROOT, "examples", "deen-mini", "data")
    with open(os.path.join(data, "test.de")) as f:
        lines = [l.strip() for l in f]
    with open(os.path.join(data, "test.en")) as f:
        refs = [l.strip() for l in f]
    with open(GOLDEN) as f:
        golden = [l.rstrip("\n") for l in f]
    check(len(golden) == len(lines), "golden file and test.de differ in length")

    gen = TextGenerator.build(os.path.join(ROOT, "models", "deen-mini2"))
    check(gen.device.type == "cuda", f"generator runs on {gen.device}")
    check(gen.cfg.beam_size == 5, f"beam size {gen.cfg.beam_size}")
    gen.decode(lines[:4])                        # warm-up (cuBLAS, kernels)
    torch.cuda.synchronize()

    cache_slot_write_.launches = 0
    gen.model.single_token_calls = 0
    t0 = time.perf_counter()
    hyps = gen.decode(lines)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = cache_slot_write_.launches
    calls = gen.model.single_token_calls
    layers = gen.model_cfg.decoder_layers

    same = sum(h == g for h, g in zip(hyps, golden))
    bleu = gen.task.compute_score("bleu", hyps, refs, lang="en")
    golden_bleu = gen.task.compute_score("bleu", golden, refs, lang="en")
    log(f"phase 2: deen-mini2 beam-5 on {torch.cuda.get_device_name(0)}: "
        f"{same}/{len(lines)} lines identical to the JAX output; BLEU "
        f"{bleu:.2f} (JAX output {golden_bleu:.2f}); {elapsed:.3f} s for "
        f"{len(lines)} lines; {calls} single-token decoder calls x {layers} "
        f"layers, {launches} kernel launches")
    for h, g in zip(hyps, golden):
        if h != g:
            log(f"  differs: port {h!r}\n           JAX  {g!r}")
    check(same >= MIN_GOLDEN_MATCH,
          f"only {same}/{len(lines)} lines match the JAX output")
    check(launches > 0, "the main path never launched cache_slot_write_")
    check(launches == layers * calls,
          f"{launches} launches != {layers} layers x {calls} calls")
    return launches


# -- phase 3 -------------------------------------------------------------------

def phase3() -> int:
    import torch
    from pasero_torch.ops.cache_update import cache_slot_write_
    from pasero_torch.scripts.bench_decode import Workload

    B, S, K, N, P, V = 64, 32, 5, 64, 8, 32768
    work = Workload("transformer", vocab=V, batch=B, src_len=S,
                    prompt_len=P, max_new=N, beam=K, seed=0)
    work.run()                                           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cache_slot_write_.launches = 0
    work.model.single_token_calls = 0
    t0 = time.perf_counter()
    out = work.run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = cache_slot_write_.launches
    calls = work.model.single_token_calls
    peak = torch.cuda.max_memory_allocated()

    layers = work.cfg.decoder_layers
    check(tuple(out["tokens"].shape) == (B, K, N), "tokens shape")
    check(bool(torch.isfinite(out["scores"]).all()), "non-finite beam scores")
    check(launches > 0, "full-width decode never launched cache_slot_write_")
    check(launches == layers * calls,
          f"{launches} launches != {layers} layers x {calls} calls")
    tokens = work.output_tokens(out)
    log(f"phase 3: transformer-base V={V} B={B} beam={K} S={S} P={P} "
        f"new={N}: {tokens / elapsed:.1f} output tok/s, "
        f"{elapsed * 1e3 / out['model_calls']:.3f} ms per decoder call "
        f"({out['model_calls']} calls, {elapsed:.3f} s), peak memory "
        f"{peak / 2**20:.1f} MiB, {launches} kernel launches")
    return launches


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    if not os.path.isdir(os.path.join(ROOT, "pasero_torch")):
        fail(f"no pasero_torch package beside {__file__}: run it from a "
             "checkout of the repository")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase0()
    timing = phase1()
    launches = phase2()
    full_width_launches = phase3()
    kernels = [{
        "name": "cache_slot_write",
        "route": "cuda",
        "source": "pasero_torch/csrc/cache_update.cu",
        "replaces": "pasero_tpu/ops/cache_update.py:43",
        "launches": launches,
        "full_width_launches": full_width_launches,
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": timing["library_ms"],
        "host_ms": timing["host_ms"],
        "plain_host_ms": timing["plain_host_ms"],
        "library_host_ms": timing["library_host_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
