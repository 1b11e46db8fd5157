#!/usr/bin/env python3
"""Smoke test of the PyTorch port (pasero_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

0. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
   nvcc build of every kernel source in pasero_torch/csrc, all started
   together;
1. the slot-write kernel against its plain PyTorch version on the card,
   bitwise, at transformer-base's beam-5 decode shape, llama_1b's and odd
   shapes, and at the first two its time beside the launch floor (an empty
   kernel of the same launch), the plain version's, one PyTorch library
   call's and the memory bound: device time per call from CUDA graphs of
   many calls read in turn ("ms", pasero_torch/scripts/bench_cache_update.py),
   and time per call with eager launches ("host_ms"); at transformer-base's
   shape at most CACHE_EARLIER_MS, its first design's time (a gate only);
2. the main path through the entry point a user calls:
   TextGenerator.build("models/deen-mini2").decode(test.de) with beam 5 on
   the card, held against the JAX package's committed output
   (pasero_torch/testdata), with the kernel's launch count checked against
   the decoder calls;
3. full width: transformer (base) with a 32768 vocabulary and weights from
   numpy seed 0, 64 sentences x beam 5, source length 32, a prompt bucket
   of 8 and 64 new tokens, through Transformer.encode and beam_search;
4. the fused cross-entropy kernels (the forward's wgmma product with its
   logsumexp-partials epilogue and their merge; the backward's three wgmma
   products per vocabulary chunk; in float32 the same design in split TF32,
   with its split passes) against their plain version on the card at
   the full-width training shape (16384 x 512 x 32000, bf16), ragged shapes in
   bf16 and float32, the wide shapes of the JAX split backward, the backward's
   chunk boundaries (a vocabulary of one chunk, one chunk + 1 and several
   with a ragged last one; in float32 too) and the heads of whisper_base
   (2048 x 512 x 51865), t5_base (4096 x 768 x 32128, in bf16 and float32),
   bloom_560m (8192 x 1024 x 250880) and llama_1b (8192 x 2048 x 32000); a
   backward given another row's lse, dx without the last chunk's share, dW
   rolled by one chunk and, in float32, the kernels on TF32-rounded operands
   rejected; the same bits from two calls of either direction;
   torch.profiler showing that the forward and the backward launch only
   kernels of csrc/fused_ce.cu (no FMA kernel) and no library GEMM in
   either type; at every head the time per call
   beside the plain version's, the library yardstick's (F.cross_entropy over
   torch.matmul logits) and the operations bound (the forward and its
   yardstick from CUDA graphs, eager beside), the forward at most its
   library call at llama_1b's and bloom_560m's heads and at most its plain
   version at whisper_base's, the peak memory of the kernel path (below the
   yardstick's) and each direction's scratch (below the bf16 logits); the
   float32 kernels' times at t5_base's head (both directions from CUDA
   graphs) beside the same and both operations bounds (split TF32, CUDA
   cores), each at most the FMA kernels' time they replaced;
5. full-width training: transformer-base, vocabulary 32000, 128 x 128
   tokens, bf16, through Trainer.train_step (scripts/bench_train.py's
   workload), 20 steps after a warm-up;
6. the training entry point: python -m pasero_torch.cli.train on
   models/deen-mini2/training.yaml in a subprocess, with the flags of
   tests/test_torch_train_cli.py, its 20 per-step losses held against the
   JAX training CLI's committed ones, then TextGenerator.build on its checkpoint;
7. the bias-free flash-attention kernels (the forward, the backward's dq
   and dk/dv: the wgmma kernels of csrc/flash_bwd.cu) against their plain
   version on the card, within the error model of tests/test_torch_cuda.py
   (``flash_limits``), at the llama_1b training shape (4 x 32/4 heads x 2048
   x 64, bf16, causal), a ragged shape (key padding, a sliding window, one
   query head per K/V head, head dim 128), an unaligned length, the
   mini LM's head dim of 32 and two cross-attentions (128 queries over 512
   padded keys; 96 over 300 at head dim 32); dq, dk and dv the same bits
   from two calls at the llama_1b shape; at the full-width shape their
   device time per call (CUDA graph) beside the plain version's, the
   operations bound and the library yardstick
   (F.scaled_dot_product_attention, forward and backward, from CUDA graphs
   too, their eager times beside), the forward at most FWD_MAX_MS and the
   backward at most BWD_MAX_MS, and the peak memory of both;
8. full-width decoder-only training: llama_1b, vocabulary 32000, 4 x 2048
   tokens, bf16, through Trainer.train_step (scripts/bench_train.py
   --model llama_1b), 20 steps after a warm-up, with exact launch counts of
   the flash and fused-CE kernels;
9. the language-model training entry point: python -m pasero_torch.cli.train
   on pasero_torch/testdata/lm_mini.yaml in a subprocess, its 20 per-step
   losses held against the JAX training CLI's, with the flash launches
   matching its micro-batches and validation batches;
10. the int8 GEMM and the fused argmax head (bf16 and int8 weights) against
   their plain versions on the card, within the error model of
   tests/test_torch_cuda.py (``int8_limits``), at llama_1b's decode,
   speculative and prompt rows (M = 8, 72, 1024) and widths, at a ragged
   vocabulary (2192) and at INT8_DECODE's cases (M = 1, 16, 80 and 81, K
   that a cluster splits unevenly), with a rolled scale and a shifted
   result rejected and the same bits from two calls; at
   each llama_1b shape their device time per call (CUDA graph; the weight
   read cold, walking copies of it larger than L2, and hot; the kernel's
   and the library's graphs read in turn, five readings each, medians; by
   pasero_torch/scripts/bench_int8.py) beside the plain version's, the
   bound and the library yardstick (F.linear on the dequantized bf16
   weight; matmul, argmax and log_softmax on materialized logits); the
   int8 GEMM's sum over one llama_1b decoder call (154 weights and the
   head) at M = 8 and 72, cold; at M = 8 each shape and the decoder call
   at most their library calls, and the head at most
   INT8_HEAD_EARLIER_MS, the time of the kernel the decode kernel
   replaced (a gate only); the prompt kernel (M > 80, wgmma fed by TMA) at
   every INT8_PROMPT case of tests/test_torch_cuda.py, and at M = 1024 each
   shape at most INT8_PROMPT_EARLIER_MS, the cold time of the mma.sync
   kernel it replaced (a gate only), the prompt's sum (154 weights and the
   head) beside F.linear's and the bound;
11. full-width decoder-only serving: llama_1b with seeded weights at
   scripts/bench_1b.py --decode's shape (8 copy prompts of 128 tokens, 64 new
   tokens, drafts of 8) through scripts/bench_decode.py's workload in five
   modes (bf16 greedy, bf16 with the fused head, speculative, int8 greedy,
   int8 with the fused head), each with exact launch counts of the kernels,
   and sampling twice from one seed with identical tokens;
12. decoder-only and int8 serving through the entry points on the JAX
   goldens: TextGenerator on pasero_torch/testdata/lm-mini2 (bf16 greedy,
   int8 weights with the fused head, speculative equal to greedy, a dialogue
   decode) and python -m pasero_torch.cli.decode models/deen-mini2
   --quantize int8 --beam-size 5 on test.de;
13. the mel kernel (power_mel) against its plain version on the card, within
   the error model of tests/test_torch_cuda.py (``mel_limits``), at
   (1, 16000), (1, 480000), (16, 480000) and a ragged (3, 12345) of noise
   and on a tone over silence (80 and 128 mel bins), with frames shifted by
   one hop, a filterbank with one column rolled and the window rolled by
   one sample rejected; at bench_mel's (16, 480000) and the main path's
   per-utterance (1, 480000) its device time per call (CUDA graph) beside
   the plain version's, the operations bound of its factored DFT and of an
   FFT, and the library yardstick (torch.stft, power, the filterbank);
14. speech through the entry points on the st-mini anchor
   (pasero_torch/testdata/st-mini): TextGenerator.decode on its 32 wavs
   (bf16 greedy with the three prompt tags) against the JAX output, with
   exactly one mel launch per wav; python -m
   pasero_torch.scripts.extract_features on the wavs against the JAX
   extract_features.py's feature file; python -m pasero_torch.cli.decode
   beam-5 on its feature file against the JAX output; python -m
   pasero_torch.cli.train on pasero_torch/testdata/st_mini.yaml, its 20
   per-step losses against the JAX training CLI's;
15. full-width speech: whisper_base with seeded weights and Whisper's
   vocabulary of 51865, written as a model directory: TextGenerator.decode
   of 8 wavs of 30 s (one mel launch each, 1500 encoder positions, greedy
   after BOS and the three target tags, 64 new tokens) and training steps at 16 x 3000 frames and 128 target tokens
   through Trainer.train_step, with exact launch counts of the mel,
   slot-write and fused-CE kernels;
16. the biased flash-attention kernels (forward, dq, dk/dv with a float32
   bias; dbias) against their plain version on the card, within the error
   model of tests/test_torch_cuda.py (``flash_bias_compare``): bloom_560m's
   training shape (4 x 16 heads x 2048 x 64, causal, per-sample ALiBi), a
   learned (1, H) bias at head dim 128, GQA 4 with a window, (B, 1) and
   (1, 1) biases, the encoder's half-head ALiBi with its rows of only -1e9,
   a shared (1, 1) bias at head dim 128 and 16500 keys at head dim 128;
   a forward of a transposed bias, of a bias row of another head and of
   the next key tile's bias, a dq given the forward's lse in log2 units
   (each at FWD_MUTANT_MIN, 2.8x, of the limits or more), dbias without
   delta, dbias with dS rounded to bf16 and a backward given another row's
   lse rejected, the forward, dq, dk and dv the same bits from two calls;
   at bloom_560m's shape each kernel's device time (CUDA graph; the
   forward, dq and dk/dv by pasero_torch/scripts/bench_flash_bwd.py's
   time_case) beside the plain version's, its bound (operations or bytes),
   the library yardstick (F.scaled_dot_product_attention with the bias as
   a float attn_mask, its backward, with the mask's gradient; from CUDA
   graphs, eager beside), the bias-free kernels at the same shape and the
   times of the biased kernels that flash_bwd.cu's replaced
   (BIAS_FWD_EARLIER_MS, BIAS_BWD_EARLIER_MS; the forward at most its
   library call and at most BIAS_FWD_EARLIER_MS, the backward at most its
   library call), the biased and bias-free kernels at 16500 keys, and the
   biased forward at every other shape beside its library call where the
   mask fits; a learned bias
   through flash_attention's autograd launching dbias once (the kernels
   line's ``learned_bias_launches``: the main path, phase 17, launches it
   0 times);
17. ALiBi through the entry points: TextGenerator on the alibi-mini anchor
   (pasero_torch/testdata/alibi-mini) against the JAX greedy output, its
   speculative decode equal to greedy; python -m pasero_torch.cli.train on
   pasero_torch/testdata/alibi_mini.yaml against the JAX losses, with exact
   launch counts (the biased kernels per layer and batch, no dbias, no
   bias-free flash kernel); bloom_560m at full width with seeded weights
   and Bloom's vocabulary of 250880: Trainer.train_step at 4 x 2048 with
   the same exact counts per step, and TextGenerator.decode of 8 prompts of
   up to 128 tokens (64 new, greedy) with one slot-write launch per layer
   per single-token decoder call;
18. the T5 flash kernels (forward, dq and dk/dv with T5's (32, H) table and
   its distance index; demb, the table's gradient, which the T5 dq kernel
   sums from its own float32 dS) against their plain
   version on the card, within the error model of tests/test_torch_cuda.py
   (``flash_t5_compare``): t5_base's encoder (32 x 12 heads x 512 x 64,
   bidirectional, key padding) and decoder (32 x 12 x 128 x 64, causal)
   shapes, GQA 4 with a window at head dim 128, an unaligned length and
   32768 keys, head dim 32 with tiles whose distances share one bucket; the
   direction flipped, another head's column, the distances
   shifted by one, demb without delta, demb of dS rounded to bf16 and a
   backward given another row's lse rejected, dq, dk, dv and demb the same
   bits from two calls, the dq without demb the same bits as with it; at
   t5_base's encoder shape and at (1, 12, 32768, 64)
   each kernel's device time (CUDA graph; the forward, dq and dk/dv by
   pasero_torch/scripts/bench_flash_bwd.py's time_case, the bias-free ones
   beside) beside the plain version's, its bound, the library yardstick
   (SDPA with the materialized bias as a float attn_mask; for demb, the
   dq kernel's instance that sums it, its mask's gradient and index_add_
   by bucket; from CUDA graphs, eager beside), what demb adds to the dq
   kernel beside that increment's own bound, "does not fit" where an (Sq, Sk) tensor does not, the forward
   and the backward at most their library call at the encoder's shape and
   at most the times of the kernels flash_bwd.cu's replaced at 32768 keys
   (T5_FWD_EARLIER_MS, T5_BWD_EARLIER_MS, gates only), the dq with demb
   below the dq and demb kernels it replaced together
   (T5_DQ_DEMB_EARLIER_MS, a gate only), and the peak memory
   of forward + backward; the T5 forward at t5_base's decoder shape (32 x
   12 x 128 x 64, causal) beside its library call; the bias-free kernels at JAX's streamed lengths, (1, 32,
   32768, 128) causal: one head against the plain version, the same bits
   from two backward calls, their device times (the forward at most
   LONG_FWD_MAX_MS, the backward at most LONG_BWD_MAX_MS: the times of the
   kernels they replaced) and peak memory;
19. T5 through the entry points: TextGenerator on the t5-mini anchor
   (pasero_torch/testdata/t5-mini), greedy and beam 5 on deen-mini's
   test.de against the JAX outputs, the encoder through flash_fwd_t5;
   python -m pasero_torch.cli.train on pasero_torch/testdata/t5_mini.yaml
   against the JAX losses with exact launch counts (the T5 kernels per
   self-attention, the dq kernel's demb instance per table, the bias-free kernels per
   cross-attention, no dbias); t5_base at full width with seeded weights
   and T5's vocabulary of 32128: Trainer.train_step at 32 x 512 source and
   128 target tokens with the same exact counts per step and its peak
   memory, and TextGenerator.decode of 8 sources of 512 tokens (64 new,
   greedy) with 12 flash_fwd_t5 launches and one slot-write launch per
   layer per single-token decoder call;
20. float32 models on the flash path: python -m pasero_torch.cli.train
   with --dtype float32 on pasero_torch/testdata/lm_mini.yaml (its 20
   losses within 0.1 % of the port's own CPU golden,
   lm_mini_f32_train20.cpu.json), alibi_mini.yaml and t5_mini.yaml (finite
   losses that fall), each with exact launch counts of the float32 kernels
   of csrc/flash_f32.cu and none of a bf16 flash kernel (T5's demb from the
   dq kernel's DEMB instance, flash_bwd_dq_t5_demb_f32); meanwhile those
   kernels (forward, dq with T5's demb, dk/dv of every bias kind, dbias)
   against their plain version within the float32 error model of
   tests/test_torch_cuda.py (``flash_f32_compare``) at every
   FLASH_F32_CASES case (GQA at 2048 keys, a ragged window at head dim 128,
   Sk % 4 != 0, each bias kind at head dims 32, 64 and 128, T5 at
   t5_base's width, (B, 1), (1, 1) and shared biases for dbias, one shared
   over four batches, one at full width) and at F32_TIMED's shapes, with a
   TF32 product, another row's lse, a transposed bias, another head's bias
   or column, shifted distances, dS rounded to bf16 and dbias without
   delta, given another row's lse or on TF32-rounded operands rejected at
   2.8 times their limits or more, the same bits from two forward and
   backward calls (out, demb and dbias too), and a learned bias launching
   the float32 dbias kernel once; then their device time per call (CUDA graph; the least and
   greatest replay beside the mean) at F32_TIMED's shapes beside the plain
   version's, the bound (float32-accurate operations at the lesser time of
   67 TFLOP/s on the CUDA cores and of split TF32 on the tensor cores, 495 /
   3 TFLOP/s, both printed; or bytes) and float32 SDPA, and what demb adds
   to the T5 dq kernel; dbias also with a learned (1, H) bias shared over
   the batch, both dbias cases at most DBIAS_F32_EARLIER_MS (the first
   design's time, a gate only) and their library call.

The second-to-last line is one JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}. Without CUDA the script exits 1 and
prints no result.
"""

from __future__ import annotations

import concurrent.futures
import glob
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# the card's memory rate and peak rates (HBM_BYTES_PER_S, BF16_FLOPS,
# FP32_FLOPS on the CUDA cores, FP32_TC_FLOPS as split TF32 on the tensor
# cores) and time_ms, bench_int8's eager_ms, come from
# pasero_torch/scripts/bench_int8.py once main has found the package; an
# add takes an FMA's slot, counted as 2 flops: FP32_ADDS = FP32_FLOPS / 2
GOLDEN = os.path.join(ROOT, "pasero_torch", "testdata",
                      "deen_mini2_test_beam5.jax.txt")
MIN_GOLDEN_MATCH = 57
TRAIN_GOLDEN = os.path.join(ROOT, "pasero_torch", "testdata",
                            "deen_mini_train20.jax.json")
TRAIN_RTOL = 0.01           # bf16 rounds at other places in JAX and torch
LM_CONFIG = os.path.join(ROOT, "pasero_torch", "testdata", "lm_mini.yaml")
LM_GOLDEN = os.path.join(ROOT, "pasero_torch", "testdata",
                         "lm_mini_train20.jax.json")
TESTDATA = os.path.join(ROOT, "pasero_torch", "testdata")
MIN_LM_MATCH = 30           # of 32 lines of lm-mini2's goldens
INT8_FUSED_ENV = {"PASERO_FUSED_HEAD": "1", "PASERO_QUANTIZE_MIN_SIZE": "0"}
ST = os.path.join(TESTDATA, "st-mini")
ST_CONFIG = os.path.join(TESTDATA, "st_mini.yaml")


def log(*args):
    print(*args, flush=True)


def fail(message: str):
    print(f"FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, message: str):
    if not cond:
        fail(message)


def device_ms(fn, iters: int = 200, replays: int = 20,
              spread: dict = None) -> float:
    """Mean device milliseconds per call of ``fn``: ``iters`` calls captured
    in one CUDA graph, replayed ``replays`` times, each replay between its
    own CUDA events, so host launch costs are left out. With ``spread`` (a
    dict), its "min_ms" and "max_ms" become the least and the greatest
    replay's ms per call, so a one-off reading shows as one."""
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
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(replays + 1)]
    events[0].record()
    for event in events[1:]:
        graph.replay()
        event.record()
    torch.cuda.synchronize()
    each = [a.elapsed_time(b) / iters for a, b in zip(events, events[1:])]
    if spread is not None:
        spread.update(min_ms=min(each), max_ms=max(each))
    return events[0].elapsed_time(events[-1]) / (iters * replays)


def library_times(fwd, inputs, do, iters: int = 10, eager_iters: int = 10,
                  grad_of=None) -> dict:
    """A library yardstick (one PyTorch call and its autograd backward; the
    port never calls either): device ms per call of ``fwd(*inputs)`` and of
    forward + backward (``torch.autograd.grad`` of its output over the
    inputs, given the output gradient ``do``), each from a CUDA graph, the
    two captured apart (a backward runs on its forward's stream, so it is
    captured with it); the backward's time is their difference. ``grad_of``,
    if given, takes the gradients and finishes the yardstick (a reduction
    the backward feeds). Beside them, as ``*_host``, the eager times: CUDA
    events over back-to-back launches, the backward on a retained forward."""
    import torch
    leaves = [x.clone().requires_grad_() for x in inputs]
    finish = grad_of or (lambda grads: grads)

    def both():
        return finish(torch.autograd.grad(fwd(*leaves), leaves, do))
    res = {"fwd": device_ms(lambda: fwd(*inputs), iters, 5)}
    res["bwd"] = device_ms(both, iters, 5) - res["fwd"]
    res["fwd_host"] = time_ms(lambda: fwd(*inputs), eager_iters, 2)
    out = fwd(*leaves)
    res["bwd_host"] = time_ms(lambda: finish(torch.autograd.grad(
        out, leaves, do, retain_graph=True)), eager_iters, 2)
    del out, leaves
    return res


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

# the slot write's device ms per call of its first design at the decode
# shapes (PERF.md, "NVIDIA H100 80GB HBM3, 700.00 W"): a gate, not a reading
# of this run
CACHE_EARLIER_MS = {(320, 8, 72, 64): 0.001749}


def phase1() -> dict:
    """cache_slot_write_ against its plain version; returns its timings at
    the decode shapes of scripts/bench_cache_update.py (transformer-base's
    beam-5 decode, llama_1b's), each beside the launch floor (an empty
    kernel of the same launch) and the first design's time."""
    import torch
    from pasero_torch.ops.cache_update import (cache_slot_write_,
                                               cache_slot_write_plain)
    from pasero_torch.scripts.bench_cache_update import SHAPES, write_timing
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the decode shapes (B*K, H, P+new, D) take the 16-byte path; rows of 72
    # bytes (D*itemsize not a multiple of 16) take the scalar ones
    shapes = [(shape, torch.bfloat16) for shape in SHAPES.values()] + [
        ((3, 4, 17, 18), torch.float32), ((3, 4, 17, 36), torch.bfloat16)]
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
        del base_k, base_v
    result = {}
    for name, shape in SHAPES.items():
        r = result[name] = write_timing(shape)
        log(f"phase 1: at {shape} bfloat16 ({name}), device ms per call "
            f"(CUDA graphs read in turn, medians): kernel {r['ms']:.6f}, "
            f"floor {r['floor_ms']:.6f} (an empty kernel of the same launch), "
            f"plain {r['plain_ms']:.6f}, library {r['library_ms']:.6f}, bound "
            f"{r['bound_ms']:.6f} ({r['bytes']} B); with eager launches: "
            f"kernel {r['host_ms']:.6f} plain {r['plain_host_ms']:.6f} "
            f"library {r['library_host_ms']:.6f}")
        earlier = CACHE_EARLIER_MS.get(shape)
        if earlier is not None:
            check(r["ms"] <= earlier, f"cache_slot_write_ at {shape} takes "
                  f"{r['ms']:.6f} ms, more than its first design's {earlier}")
            log(f"phase 1: at {shape} the kernel {r['ms']:.6f} ms against "
                f"its first design's {earlier} (PERF.md)")
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


# -- phase 4 -------------------------------------------------------------------

def ce_shapes(chunk: int) -> list:
    """Phase 4's ((N, E, V), dtype name) cases: the main path's heads
    (bench_fused_ce.py's HEADS, each timed), ragged edges, the shapes of
    JAX's split backward and the boundaries of the backward's vocabulary
    chunks of ``chunk`` rows."""
    from pasero_torch.scripts.bench_fused_ce import HEADS as CE_HEADS
    return [(CE_HEADS["transformer_base"], "bfloat16"),
            ((130, 48, 515), "bfloat16"),        # ragged rows and vocab
            ((130, 48, 515), "float32"),         # the split-TF32 kernels
            ((48, 2048, 330), "bfloat16"),       # shapes of JAX's split bwd
            ((4096, 2048, 32000), "bfloat16"),
            ((256, 128, chunk), "bfloat16"),     # one backward chunk exactly
            ((256, 128, chunk + 1), "bfloat16"),  # and one row more
            ((256, 136, 3 * chunk + 1000), "bfloat16"),  # a ragged last chunk
            (CE_HEADS["whisper_base"], "bfloat16"),
            (CE_HEADS["t5_base"], "bfloat16"),
            (CE_HEADS["bloom_560m"], "bfloat16"),
            (CE_HEADS["llama_1b"], "bfloat16"),
            # float32: t5_base's head (its float32 training), E padded to
            # 40, the backward's chunks
            (CE_HEADS["t5_base"], "float32"),
            ((64, 36, 100), "float32"),
            ((256, 128, chunk + 1), "float32"),
            ((256, 136, 3 * chunk + 1000), "float32")]


# kernels of csrc/fused_ce.cu as the profiler names them, and names of
# library GEMMs that the backward must not launch
FCE_KERNEL_NAMES = ("fused_ce::", "wgmma_gemm::")
LIBRARY_GEMM = re.compile(r"gemm|cublas|cutlass|xmma|sm90_|nvjet", re.I)
# the parts each direction's profile must show, by type: bf16's wgmma
# products by their epilogues; float32's split pass and split-TF32 products
FCE_PARTS = {"bfloat16": {"fwd": ("FwdEpilogue", "fwd_combine_kernel"),
                          "bwd": ("DlogitsEpilogue", "DwEpilogue",
                                  "DxEpilogue")},
             "float32": {"fwd": ("split_kernel",
                                 "tf32_gemm_kernel<fused_ce::FwdChunkEpilogue",
                                 "fwd_combine_kernel"),
                         "bwd": ("split_kernel",
                                 "tf32_gemm_kernel<fused_ce::DlogitsEpilogue",
                                 "tf32_gemm_kernel<fused_ce::DwEpilogue",
                                 "tf32_gemm_kernel<fused_ce::DxAddEpilogue")}}
# device ms per call of the float32 FMA kernels that the split-TF32 ones
# replaced, at t5_base's head: the parent's medians in this PR's comparison
# (bench_fused_ce.py, "NVIDIA H100 80GB HBM3, 700.00 W", PERF.md): gates,
# not readings of this run
FCE_F32_EARLIER_MS = {"fwd": 42.7942, "bwd": 123.5620}


# Limits of phase 4. Each per-row statistic of the forward against float32
# logits of the same operands (an error of summation order only): lse and the
# target logit within STAT_ATOL; the logits sum within STAT_SUM_RTOL of the
# sum of |logits| over its row. Readings on an H100 80GB HBM3 at 700 W: lse
# and target within 1.9e-5, the sum within 3.3e-7 of its |sum|; gradients
# at most 0.52 of their limits, and at 336x or more of them with another
# row's lse.
STAT_ATOL = 1e-4
STAT_SUM_RTOL = 1e-6


def load_test_module(name: str):
    """A module of tests/ by file name (it holds helpers the smoke test
    shares with the pytest cases); tests/ goes on the path for the modules
    it imports in turn."""
    import importlib.util
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tests", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ce_timing(N, E, V, name: str = "bfloat16") -> dict:
    """The fused-CE wrappers' time per call at (N, E, V) in x's type
    ``name`` beside the plain version's, the library yardstick's and the
    bound (bench_fused_ce.py's ``bounds``: in float32 the lesser of three
    TF32 products at the tensor cores' rate and one product on the CUDA
    cores; the forward and its yardstick from CUDA graphs, their eager times
    beside; in float32 the backward from a CUDA graph too), the peak memory
    of the kernel path
    and the yardstick, each wrapper's scratch, and whether two forward calls
    give the same bits."""
    import torch
    import torch.nn.functional as F
    from pasero_torch.ops.fused_ce import (fused_ce_bwd, fused_ce_fwd,
                                           fused_cross_entropy,
                                           fused_cross_entropy_plain)
    from pasero_torch.scripts.bench_fused_ce import bounds, inputs
    ls = 0.1
    dtype = getattr(torch, name)
    x, w, t, wt = inputs(N, E, V, dtype)
    wb = w.to(dtype)
    lse = fused_ce_fwd(x, wb, t)[0]
    c = wt * 0.5
    res = bounds(N, E, V, dtype)
    first, second = fused_ce_fwd(x, wb, t), fused_ce_fwd(x, wb, t)
    res["fwd"]["same_bits"] = all(torch.equal(a, b)
                                  for a, b in zip(first, second))
    del first, second
    check(res["fwd"]["same_bits"], f"two forward calls at {(N, E, V)} gave "
          "other bits")

    def fwd():
        return fused_ce_fwd(x, wb, t)

    def yardstick(xi, wi):       # one library call; the port never calls it
        logits = torch.matmul(xi, wi.to(xi.dtype).t()).float()
        return (F.cross_entropy(logits, t, reduction="none",
                                label_smoothing=ls) * wt).sum()

    def bwd():
        return fused_ce_bwd(x, wb, t, lse, c, c, c)

    res["fwd"]["ms"] = device_ms(fwd, 5, 4)
    res["fwd"]["host_ms"] = time_ms(fwd, 20, 3)
    if name == "float32":
        res["bwd"]["ms"] = device_ms(bwd, 3, 4)
        res["bwd"]["host_ms"] = time_ms(bwd, 5, 2)
    else:
        res["bwd"]["ms"] = time_ms(bwd, 10, 2)
    with torch.no_grad():
        res["fwd"]["plain_ms"] = time_ms(
            lambda: fused_cross_entropy_plain(x, w, t, wt, ls), 10, 2)
        res["fwd"]["library_ms"] = device_ms(lambda: yardstick(x, w), 3, 3)
        res["fwd"]["library_host_ms"] = time_ms(lambda: yardstick(x, w), 10,
                                                2)
    for key, fn in (("plain_ms", lambda xi, wi: fused_cross_entropy_plain(
            xi, wi, t, wt, ls)[0]), ("library_ms", yardstick)):
        xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
        loss = fn(xi, wi)
        res["bwd"][key] = time_ms(lambda: torch.autograd.grad(
            loss, (xi, wi), retain_graph=True), 10, 2)
        del loss
    for key, fn in (("peak_mib", fused_cross_entropy),
                    ("library_peak_mib", lambda xi, wi, *a: (yardstick(xi, wi),))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
        fn(xi, wi, t, wt, ls)[0].backward()
        torch.cuda.synchronize()
        res["fwd"][key] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        del xi, wi
    # each wrapper's own memory beyond its inputs and outputs (the scratch of
    # partials; the backward's scratch, dx accumulator and copies), from the
    # allocator's peak over one call
    for key, fn in (("fwd", fwd), ("bwd", bwd)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs = fn()
        torch.cuda.synchronize()
        kept = sum({o.untyped_storage().data_ptr(): o.untyped_storage().nbytes()
                    for o in outs}.values())
        res[key]["scratch_mib"] = (torch.cuda.max_memory_allocated() - base
                                   - kept) / 2 ** 20
        del outs
        check(res[key]["scratch_mib"] * 2 ** 20 < N * V * x.element_size(),
              f"the {key} scratch at {(N, E, V)} is not below the whole "
              "logits")
    if name == "float32":
        bounds = {key: (f"bound {res[key]['bound_ms']:.4f}: split TF32 "
                        f"{res[key]['tf32x3_ops_bound_ms']:.4f}, CUDA cores "
                        f"{res[key]['fp32_ops_bound_ms']:.4f}")
                  for key in ("fwd", "bwd")}
        bwd_how = (f" from a CUDA graph, eager {res['bwd']['host_ms']:.4f}")
    else:
        bounds = {key: f"bound {res[key]['bound_ms']:.4f}"
                  for key in ("fwd", "bwd")}
        bwd_how = ""
    log(f"phase 4: at {(N, E, V)} {name}, ms per call: forward kernels "
        f"{res['fwd']['ms']:.4f} from a CUDA graph, eager "
        f"{res['fwd']['host_ms']:.4f} ({bounds['fwd']}, "
        f"plain {res['fwd']['plain_ms']:.4f}, library "
        f"{res['fwd']['library_ms']:.4f} from a CUDA graph, eager "
        f"{res['fwd']['library_host_ms']:.4f}); backward kernels "
        f"{res['bwd']['ms']:.4f}{bwd_how} ({bounds['bwd']}, plain "
        f"{res['bwd']['plain_ms']:.4f}, library {res['bwd']['library_ms']:.4f});"
        f" peak memory of forward + backward: kernels "
        f"{res['fwd']['peak_mib']:.1f} MiB, library "
        f"{res['fwd']['library_peak_mib']:.1f} MiB; scratch: forward "
        f"{res['fwd']['scratch_mib']:.1f} MiB, backward "
        f"{res['bwd']['scratch_mib']:.1f} MiB; the forward's stats the same "
        f"bits from two calls")
    check(res["fwd"]["peak_mib"] < res["fwd"]["library_peak_mib"],
          f"the kernels' peak memory at {(N, E, V)} is not below the "
          "library's")
    return res


def device_kernels(fn) -> dict:
    """{kernel name: launches} of the CUDA kernels that ``fn`` runs, from
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if (getattr(e, "device_time_total", 0)
                or getattr(e, "cuda_time_total", 0)) > 0}


def fce_launch_check(what, alone, parts, whole) -> dict:
    """``alone`` (the kernels of one fused-CE wrapper call) are all of
    csrc/fused_ce.cu, hold every name in ``parts`` and no FMA kernel;
    ``whole`` (the kernels of the same direction through
    fused_cross_entropy) holds no library GEMM. Returns ``alone``."""
    check(alone and all(any(k in name for k in FCE_KERNEL_NAMES)
                        and "fma" not in name for name in alone),
          f"fused_ce_{what} launched kernels not of csrc/fused_ce.cu: {alone}")
    check(all(any(e in name for name in alone) for e in parts),
          f"the {what} profile lacks one of {parts}: {alone}")
    foreign = [name for name in whole if LIBRARY_GEMM.search(name)
               and not any(k in name for k in FCE_KERNEL_NAMES)]
    check(not foreign, f"the fused-CE {what} launched library GEMMs: "
          f"{foreign}")
    return alone


def fwd_launch_check(x, wb, t, wt, ls, name) -> dict:
    """The forward in x's type ``name`` launches the parts FCE_PARTS names
    (bf16: its wgmma product with the partials' epilogue and their merge;
    float32: the split pass, the split-TF32 product and the merge) and
    nothing else (fused_ce_fwd alone); fused_cross_entropy's forward no
    library GEMM."""
    import torch
    from pasero_torch.ops.fused_ce import fused_ce_fwd, fused_cross_entropy
    t32 = t.to(torch.int32)
    alone = device_kernels(lambda: fused_ce_fwd(x, wb, t32))
    with torch.no_grad():
        whole = device_kernels(lambda: fused_cross_entropy(
            x, wb.float(), t, wt, ls))
    return fce_launch_check("fwd", alone, FCE_PARTS[name]["fwd"], whole)


def bwd_launch_check(x, wb, t, lse, cs, wt, ls, name) -> dict:
    """The backward in x's type ``name`` launches its three products (and in
    float32 its split passes) and nothing else (fused_ce_bwd alone); the
    autograd backward of fused_cross_entropy no library GEMM."""
    import torch
    from pasero_torch.ops.fused_ce import fused_ce_bwd, fused_cross_entropy
    t32 = t.to(torch.int32)
    alone = device_kernels(lambda: fused_ce_bwd(x, wb, t32, lse, *cs))
    xi, wi = x.clone().requires_grad_(), wb.float().requires_grad_()
    out = fused_cross_entropy(xi, wi, t, wt, ls)
    whole = device_kernels(lambda: out[0].backward())
    return fce_launch_check("bwd", alone, FCE_PARTS[name]["bwd"], whole)


def phase4() -> dict:
    """The fused-CE kernels against fused_cross_entropy_plain; returns the
    two wrappers' timings at the full-width shape, at llama_1b's head
    (under "lm_head") and at every head of bench_fused_ce.py's HEADS (under
    "heads"), and their errors."""
    import torch
    from pasero_torch.ops import fused_ce as fce
    from pasero_torch.ops.fused_ce import (fused_ce_bwd, fused_ce_fwd,
                                           fused_cross_entropy,
                                           fused_cross_entropy_plain)
    from pasero_torch.scripts.bench_fused_ce import HEADS as CE_HEADS
    from pasero_torch.scripts.bench_fused_ce import inputs as ce_inputs
    chunk = fce.CHUNK
    # gradients element by element, within the error model of the kernels'
    # bf16 rounding of dlogits that tests/test_torch_cuda.py states
    cuda_tests = load_test_module("test_torch_cuda")
    ls, gl, gn = 0.1, 1.0, 0.5      # the backward of loss + 0.5 nll
    err = {name: {"fwd": 0.0, "bwd": 0.0} for name in ("bfloat16", "float32")}
    for (N, E, V), name in ce_shapes(chunk):
        dtype = getattr(torch, name)
        f32 = name == "float32"
        x, w, t, wt = ce_inputs(N, E, V, dtype)
        wb = w.to(dtype)
        # per-row statistics of one forward launch against float32 logits of
        # the same bf16 operands, float64 logits of float32 ones
        lse, tgt, suml = fused_ce_fwd(x, wb, t)
        wide = torch.float64 if f32 else torch.float32
        logits = torch.matmul(x.to(wide), wb.to(wide).t())
        ref_lse = torch.logsumexp(logits, -1)
        ref_tgt = logits.gather(-1, t[:, None])[:, 0]
        ref_suml = logits.sum(-1)
        abs_sum = logits.abs().sum(-1)
        if not f32:   # float32 keeps them for the TF32 mutation
            del logits
        lse_err = (lse - ref_lse).abs().max().item()
        tgt_err = (tgt - ref_tgt).abs().max().item()
        sum_err = ((suml - ref_suml).abs() / abs_sum).max().item()
        check(lse_err <= STAT_ATOL and tgt_err <= STAT_ATOL
              and sum_err <= STAT_SUM_RTOL,
              f"fused_ce_fwd statistics differ at {(N, E, V)} {name}: lse "
              f"{lse_err:.3e}, target logit {tgt_err:.3e}, logits sum "
              f"{sum_err:.3e} of its |sum|")
        # in float32 the gradients' reference takes this lse, so only this
        # limit ties them to the exact ones (tests/test_torch_cuda.py
        # F32_LSE_ATOL)
        check(not f32 or lse_err <= cuda_tests.F32_LSE_ATOL,
              f"fused_ce_fwd's float32 lse at {(N, E, V)} is {lse_err:.3e} "
              f"from float64's, more than {cuda_tests.F32_LSE_ATOL:g}")
        stat_err = max(lse_err, tgt_err,
                       (suml - ref_suml).abs().max().item())
        # sums and gradients through autograd: the kernel path on x and the
        # float32 weight, the plain version on float32 leaves of the same
        # values, so its gradients are not rounded
        outs, grads = [], []
        for fn, xi, wi in ((fused_cross_entropy, x, w),
                           (fused_cross_entropy_plain, x.float(), wb.float())):
            xi = xi.clone().requires_grad_()
            wi = wi.clone().requires_grad_()
            out = fn(xi, wi, t, wt, ls)
            (gl * out[0] + gn * out[1]).backward()
            outs.append([o.item() for o in out])
            grads.append((xi.grad, wi.grad))
        torch.cuda.synchronize()
        (lk, nk, dk), (lp, np_, dp) = outs
        check(abs(lk - lp) <= 1e-5 * abs(lp) and abs(nk - np_) <= 1e-5 * abs(np_),
              f"fused CE sums differ at {(N, E, V)} {name}: {outs}")
        check(dk == dp, f"weight sums differ at {(N, E, V)} {name}")
        # the backward's coefficients as autograd gives them; in float32 the
        # reference is the plain backward in float64 given the kernel's lse
        # (tests/test_torch_cuda.py f32_reference_grads says why), and the
        # float32 plain version is held to the same limits for comparison
        cs = fce.dlogit_coefficients(
            wt, *(torch.tensor(g, device="cuda") for g in (gl, gn)), ls, V)
        if f32:
            plain32 = grads[1]
            grads[1] = cuda_tests.f32_reference_grads(x, wb, t, cs)[0]
        limits = cuda_tests.fused_ce_grad_limits(x, wb, t, ref_lse, *cs,
                                                 grads[1])
        excess = [cuda_tests.fused_ce_grad_excess(got, want, limit)
                  for got, want, limit in zip(*grads, limits)]
        check(max(excess) <= 1.0,
              f"fused CE gradients differ at {(N, E, V)} {name}: dx, dW at "
              f"{excess[0]:.3f}, {excess[1]:.3f} of the limit")
        grad_err = max((got.float() - want).abs().max().item()
                       for got, want in zip(*grads))
        f32_note = ""
        if f32:
            plain = max(cuda_tests.fused_ce_grad_excess(got, want, limit)
                        for got, want, limit in zip(plain32, grads[1], limits))
            tf32 = cuda_tests.fused_ce_tf32_excess(x, wb, t, cs, grads[1],
                                                   limits, logits)
            check(min(tf32) >= cuda_tests.F32_TF32_MIN, f"the float32 check "
                  f"at {(N, E, V)} passes the kernels on TF32-rounded "
                  f"operands: statistics and gradients at {tf32[0]:.2f} and "
                  f"{tf32[1]:.2f} of their limits")
            f32_note = (f"; lse within {cuda_tests.F32_LSE_ATOL:g} of "
                        f"float64's; on TF32-rounded operands (one TF32 product) the "
                        f"statistics at {tf32[0]:.1f} and the gradients at "
                        f"{tf32[1]:.1f} of their limits; the float32 plain "
                        f"version's gradients at {plain:.3f}")
            del logits, plain32
        # the check must reject a backward that reads another row's lse
        bad = fused_ce_bwd(x, wb, t, lse.roll(1), *cs)
        bad_excess = [cuda_tests.fused_ce_grad_excess(got, want, limit)
                      for got, want, limit in zip(bad, grads[1], limits)]
        check(min(bad_excess) > 1.0,
              f"the gradient check at {(N, E, V)} {name} passes a backward "
              f"given another row's lse: dx, dW at {bad_excess[0]:.3f}, "
              f"{bad_excess[1]:.3f} of the limit")
        # the same bits from two calls
        again = [fused_ce_bwd(x, wb, t, lse, *cs) for _ in range(2)]
        check(all(torch.equal(p, q) for p, q in zip(*again)),
              f"two backward calls at {(N, E, V)} {name} differ")
        del again
        # over several chunks, dW with its rows rolled by one chunk and, where
        # a target lies in the last chunk (else its share is the softmax
        # tail alone, below the bf16 error model), dx without that chunk's
        # share (a call on the rows of w before it)
        chunk_note = ""
        if V > chunk:
            rolled = cuda_tests.fused_ce_grad_excess(
                grads[0][1].roll(chunk, 0), grads[1][1], limits[1])
            check(rolled > 1.0, f"the gradient check at {(N, E, V)} {name} "
                  f"passes dW rolled by one chunk ({rolled:.3f} of the limit)")
            chunk_note = f"; dW rolled by one chunk at {rolled:.3f}"
            v_last = (V - 1) // chunk * chunk
            if (t >= v_last).any():
                part = fused_ce_bwd(x, wb[:v_last], t, lse, *cs)[0]
                short = cuda_tests.fused_ce_grad_excess(part, grads[1][0],
                                                        limits[0])
                check(short > 1.0, f"the gradient check at {(N, E, V)} {name} "
                      f"passes dx without the last chunk ({short:.3f} of the "
                      "limit)")
                chunk_note += f", dx without the last chunk at {short:.3f}"
                del part
        # the kernels by their last name of csrc/fused_ce.cu: an epilogue,
        # the merge, the split pass
        per = {re.findall(r"fused_ce::(?:tf32::)?(\w+)", k)[-1]: n
               for k, n in bwd_launch_check(x, wb, t, lse, cs, wt, ls,
                                            name).items()}
        fwd_per = {re.findall(r"fused_ce::(?:tf32::)?(\w+)", k)[-1]: n
                   for k, n in fwd_launch_check(x, wb, t, wt, ls,
                                                name).items()}
        kernels_note = (f"; the profiler saw only kernels of fused_ce.cu: "
                        f"in the forward {fwd_per}, in the backward {per} "
                        f"for {-(-V // chunk)} chunk(s)")
        err[name]["fwd"] = max(err[name]["fwd"], stat_err)
        err[name]["bwd"] = max(err[name]["bwd"], grad_err)
        log(f"phase 4: fused CE == plain at {(N, E, V)} {name}: row stats "
            f"max abs err lse {lse_err:.3e} target {tgt_err:.3e} (limit "
            f"{STAT_ATOL:g}), logits sum {sum_err:.3e} of its |sum| (limit "
            f"{STAT_SUM_RTOL:g}); loss {lk:.3f} vs {lp:.3f}; gradients max abs "
            f"err {grad_err:.3e}, dx and dW at {excess[0]:.3f} and "
            f"{excess[1]:.3f} of their limits; with another row's lse at "
            f"{bad_excess[0]:.3f} and {bad_excess[1]:.3f}{chunk_note}"
            f"{f32_note}; the same bits twice{kernels_note}")
        del x, w, wb, grads, bad, limits
        torch.cuda.empty_cache()

    heads = {name: ce_timing(*shape) for name, shape in CE_HEADS.items()}
    for name in ("llama_1b", "bloom_560m"):
        f = heads[name]["fwd"]
        check(f["ms"] <= f["library_ms"], f"the forward at {name}'s head "
              f"takes {f['ms']:.4f} ms, more than its library call's "
              f"{f['library_ms']:.4f}")
    f = heads["whisper_base"]["fwd"]
    check(f["ms"] <= f["plain_ms"], f"the forward at whisper_base's head "
          f"takes {f['ms']:.4f} ms, more than its plain version's "
          f"{f['plain_ms']:.4f}")
    # float32 at t5_base's head (its float32 training), gated by the times
    # of the FMA kernels it replaced
    f32_head = ce_timing(*CE_HEADS["t5_base"], "float32")
    for key in ("fwd", "bwd"):
        check(f32_head[key]["ms"] <= FCE_F32_EARLIER_MS[key], f"the float32 "
              f"{key} at t5_base's head takes {f32_head[key]['ms']:.4f} ms, "
              f"more than the FMA kernels' {FCE_F32_EARLIER_MS[key]}")
        f32_head[key]["max_abs_err"] = err["float32"][key]
    res = dict(heads["transformer_base"], lm_head=heads["llama_1b"],
               heads=heads, f32=f32_head)
    res["fwd"]["max_abs_err"] = err["bfloat16"]["fwd"]
    res["bwd"]["max_abs_err"] = err["bfloat16"]["bwd"]
    return res


# -- phase 5 -------------------------------------------------------------------

def phase5() -> int:
    import torch
    from pasero_torch.ops.fused_ce import fused_ce_bwd, fused_ce_fwd
    from pasero_torch.scripts.bench_train import Workload
    work = Workload()
    work.run(3)                                            # warm-up
    torch.cuda.reset_peak_memory_stats()
    fused_ce_fwd.launches = fused_ce_bwd.launches = 0
    steps = 20
    logs, seconds = work.run(steps)
    fwd, bwd = fused_ce_fwd.launches, fused_ce_bwd.launches
    peak = torch.cuda.max_memory_allocated()
    losses = [l["loss"] for l in logs]
    check(all(map(math.isfinite, losses)), f"non-finite losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(fwd == steps and bwd == steps,
          f"fused CE launches fwd {fwd} bwd {bwd} != {steps} steps of one "
          "micro-batch")
    log(f"phase 5: transformer-base V=32000 B=128 S=T=128 bf16 training: "
        f"{work.tokens_per_step * steps / seconds:.1f} target tok/s, "
        f"{seconds * 1e3 / steps:.3f} ms per step, peak memory "
        f"{peak / 2**20:.1f} MiB, loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
        f"fused CE launches fwd {fwd} bwd {bwd} for {steps} micro-batches")
    return fwd


# -- phase 6 -------------------------------------------------------------------

def parse_launches(out: str) -> dict:
    """The counts of cli.train's ``launches | name N | ...`` log line."""
    m = re.search(r"launches((?: \| [a-z0-9_ -]+ \d+)+)", out)
    check(m is not None, "cli.train logged no launch counts")
    return {name: int(n) for name, n in
            re.findall(r"\| ([a-z0-9_ -]+?) (\d+)", m.group(1))}


def phase6() -> dict:
    import shutil
    import torch
    from pasero_torch.decoding.generator import TextGenerator
    cli = load_test_module("test_torch_train_cli")
    model_dir = os.path.join(ROOT, "build", "smoke-train")
    shutil.rmtree(model_dir, ignore_errors=True)
    os.makedirs(model_dir)
    ckpt = os.path.join(ROOT, "build", "smoke-train-init.npz")
    cli.write_initial_weights(ckpt)
    # validation every 10 steps (it decodes with the current weights and
    # does not touch the training data or losses)
    cmd = [sys.executable, "-m", "pasero_torch.cli.train",
           *cli.train_flags(model_dir, ckpt), "--valid-interval", "10",
           "--save-interval", "10"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    elapsed = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    check(proc.returncode == 0, f"cli.train failed:\n{out[-4000:]}")
    logs = cli.parse_log(out)
    with open(TRAIN_GOLDEN) as f:
        golden = json.load(f)["steps"]
    check([l["step"] for l in logs] == [g["step"] for g in golden],
          f"logged steps {[l['step'] for l in logs]}")
    worst = 0.0
    for got, want in zip(logs, golden):
        rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        worst = max(worst, rel)
        check(rel <= TRAIN_RTOL, f"step {got['step']}: loss {got['loss']} "
              f"vs JAX {want['loss']}")
    counts = parse_launches(out)
    fwd, bwd, slot, micro, valid = (counts[k] for k in (
        "fused_ce_fwd", "fused_ce_bwd", "cache_slot_write",
        "train micro-batches", "valid batches"))
    check(micro == 20 and valid > 0, f"{micro} micro-batches, {valid} "
          "validation batches")
    check(fwd == micro + valid and bwd == micro,
          f"fused CE launches fwd {fwd} bwd {bwd} for {micro} micro-batches "
          f"and {valid} validation batches")
    check(os.path.exists(os.path.join(model_dir, "model_20.npz")),
          "no model_20.npz")
    gen = TextGenerator.build(model_dir, ckpt="model_20.npz")
    check(gen.device.type == "cuda", f"generator runs on {gen.device}")
    hyps = gen.decode(["Guten Morgen.", "Das Haus ist klein."])
    check(len(hyps) == 2 and all(isinstance(h, str) for h in hyps),
          f"decode gave {hyps!r}")
    log(f"phase 6: python -m pasero_torch.cli.train, 20 steps in "
        f"{elapsed:.1f} s: losses {logs[0]['loss']:.3f} -> "
        f"{logs[-1]['loss']:.3f}, all within {worst:.4%} of the JAX training CLI's; "
        f"launches fwd {fwd} bwd {bwd} cache_slot_write {slot} for {micro} "
        f"micro-batches and {valid} validation batches; model_20.npz decodes "
        f"{hyps!r}")
    torch.cuda.synchronize()
    return {"fwd": fwd, "bwd": bwd}

# -- phase 7 -------------------------------------------------------------------

FLASH_SHAPES = [   # (B, H, Hkv, S or (Sq, Sk), D), causal, window, padded
    ((4, 32, 4, 2048, 64), True, None, False),     # llama_1b training
    ((2, 8, 8, 1000, 128), True, 256, True),       # padding, window, group 1
    ((2, 16, 4, 777, 64), False, None, True),      # unaligned S, not causal
    ((3, 4, 2, 45, 32), True, None, True),         # the mini LM's head dim
    ((4, 12, 12, (128, 512), 64), False, None, True),   # cross-attention
    ((2, 4, 2, (96, 300), 32), False, None, True),      # and at D = 32
]


# the bias-free backward's limits (dq + dk/dv, device ms per call): at
# llama_1b's training shape, and at LONG the time of the kernels it
# replaced (64.2594 + 84.3847 ms, PERF.md, "NVIDIA H100 80GB HBM3, 700.00 W")
BWD_MAX_MS = 1.0
LONG_BWD_MAX_MS = 148.6441
# the bias-free forward's: at llama_1b's training shape, and at LONG the time
# of the kernel it replaced (46.9077 ms, PERF.md, the same card)
FWD_MAX_MS = 0.30
LONG_FWD_MAX_MS = 46.9077


def flash_check(shape, causal, window, padded, cuda_tests) -> dict:
    """The three kernels against the plain version at one shape, by
    ``flash_compare`` of tests/test_torch_cuda.py: lse within 1e-4, out, dq,
    dk, dv within ``flash_limits``, and a backward given another row's lse
    outside them. Returns the max abs errors."""
    r = cuda_tests.flash_compare(shape, causal, window, padded)
    check(r["lse_err"] <= 1e-4,
          f"flash_fwd lse differs at {shape} by {r['lse_err']}")
    check(max(r["excess"]) <= 1.0, f"flash kernels differ at {shape} causal "
          f"{causal} window {window}: out, dq, dk, dv at {r['excess']} of "
          "their limits")
    check(r["bad_excess"] > 1.0, f"the flash check at {shape} passes a "
          f"backward given another row's lse ({r['bad_excess']:.3f} of the "
          "limit)")
    errs = r["max_abs_err"]
    log(f"phase 7: flash kernels == plain at {shape} causal {causal} window "
        f"{window} padded {padded}: out, dq, dk, dv at "
        f"{', '.join(f'{e:.3f}' for e in r['excess'])} of their limits "
        f"(another row's lse: {r['bad_excess']:.1f}); max abs err lse "
        f"{r['lse_err']:.3e} out {errs['fwd']:.3e} dq {errs['dq']:.3e} "
        f"dk/dv {errs['dkv']:.3e}")
    return errs


def flash_timing(cuda_tests) -> dict:
    """At the llama_1b shape: device ms per call of each kernel (CUDA graph)
    and with eager launches, the plain version's and the library
    yardstick's ms, the operations bounds, and the peak memory of forward +
    backward through the kernels and through the yardstick."""
    import torch
    import torch.nn.functional as F
    from pasero_torch.ops.flash_attention import (flash_attention, flash_bwd,
                                                  flash_bwd_dkv, flash_bwd_dq,
                                                  flash_bwd_plain, flash_fwd,
                                                  flash_fwd_plain)
    (B, H, Hkv, S, D), causal, window, padded = FLASH_SHAPES[0]
    q, k, v, do, mask = cuda_tests.flash_inputs(B, H, Hkv, S, D, padded)
    scale = D ** -0.5
    out, lse = flash_fwd(q, k, v, mask, scale, causal, window)
    _, delta = flash_bwd_dq(q, k, v, mask, out, lse, do, scale, causal, window)
    # operations this run's data needs: every (row, visible key) pair costs
    # 2 D per product; bytes: each input read and each output written once
    pairs = B * H * S * (S + 1) / 2
    product = 2.0 * pairs * D
    q_bytes, kv_bytes, row_bytes = B * H * S * D * 2, B * Hkv * S * D * 2, \
        B * H * S * 4

    def bound(products, nbytes):
        ops, mem = products * product / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
        return {"bound_ms": max(ops, mem) * 1e3, "ops_bound_ms": ops * 1e3,
                "bytes_bound_ms": mem * 1e3}

    res = {
        "fwd": bound(2, 2 * q_bytes + 2 * kv_bytes + row_bytes),
        # the backward's function: QK^T and dO V^T recomputed, P^T dO, dS K,
        # dS^T Q; the dq kernel alone needs three, the dk/dv kernel four
        "bwd": bound(5, 4 * q_bytes + 4 * kv_bytes + row_bytes),
        "dq": {"kernel_bound_ms": bound(3, 4 * q_bytes + 2 * kv_bytes
                                        + 2 * row_bytes)["bound_ms"]},
        "dkv": {"kernel_bound_ms": bound(4, 2 * q_bytes + 4 * kv_bytes
                                         + 2 * row_bytes)["bound_ms"]},
    }
    args = (scale, causal, window)
    kernels = {
        "fwd": lambda: flash_fwd(q, k, v, mask, *args),
        "dq": lambda: flash_bwd_dq(q, k, v, mask, out, lse, do, *args),
        "dkv": lambda: flash_bwd_dkv(q, k, v, mask, do, lse, delta, *args),
        "bwd": lambda: flash_bwd(q, k, v, mask, out, lse, do, *args),
    }
    for key, fn in kernels.items():
        res[key]["ms" if key in ("fwd", "bwd") else "kernel_ms"] = \
            device_ms(fn, iters=20, replays=5)
        res[key]["host_ms"] = time_ms(fn, 20, 3)
    res["same_bits"] = cuda_tests.flash_same_bits(*FLASH_SHAPES[0])
    check(res["same_bits"], f"two backward calls at {(B, H, Hkv, S, D)} "
          "gave other bits")
    res["fwd"]["plain_ms"] = time_ms(
        lambda: flash_fwd_plain(q, k, v, mask, *args), 5, 1)
    res["bwd"]["plain_ms"] = time_ms(
        lambda: flash_bwd_plain(q, k, v, mask, out, lse, do, *args), 5, 1)
    lib = library_times(lambda *x: F.scaled_dot_product_attention(
        *x, is_causal=True, enable_gqa=True), (q, k, v), do, 20, 20)
    for key in ("fwd", "bwd"):
        res[key]["library_ms"] = lib[key]
        res[key]["library_host_ms"] = lib[f"{key}_host"]
    for key, fn in (("peak_mib", lambda *x: flash_attention(
            *x, mask=mask[:, None, None, :], scale=scale, causal=True)),
            ("library_peak_mib", lambda *x: F.scaled_dot_product_attention(
                *x, is_causal=True, enable_gqa=True))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        fn(*leaves).backward(do)
        torch.cuda.synchronize()
        res["fwd"][key] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        del leaves
    f, b = res["fwd"], res["bwd"]
    check(f["ms"] <= FWD_MAX_MS, f"the bias-free forward takes "
          f"{f['ms']:.4f} ms at {(B, H, Hkv, S, D)}, more than "
          f"{FWD_MAX_MS}")
    check(b["ms"] <= BWD_MAX_MS, f"the bias-free backward takes "
          f"{b['ms']:.4f} ms at {(B, H, Hkv, S, D)}, more than "
          f"{BWD_MAX_MS}")
    log(f"phase 7: at {(B, H, Hkv, S, D)} bf16 causal, device ms per call "
        f"(CUDA graph): forward {f['ms']:.4f} (bound {f['bound_ms']:.4f}, "
        f"bytes {f['bytes_bound_ms']:.4f}, "
        f"plain {f['plain_ms']:.4f}, library {f['library_ms']:.4f}); "
        f"backward {b['ms']:.4f} = dq {res['dq']['kernel_ms']:.4f} (bound "
        f"{res['dq']['kernel_bound_ms']:.4f}) + dk/dv "
        f"{res['dkv']['kernel_ms']:.4f} (bound "
        f"{res['dkv']['kernel_bound_ms']:.4f}); backward bound "
        f"{b['bound_ms']:.4f} (bytes {b['bytes_bound_ms']:.4f}), plain {b['plain_ms']:.4f}, library "
        f"{b['library_ms']:.4f}; with eager launches: forward "
        f"{f['host_ms']:.4f} backward {b['host_ms']:.4f}, library forward "
        f"{f['library_host_ms']:.4f} backward {b['library_host_ms']:.4f}; "
        f"dq, dk, dv the same bits from two calls: {res['same_bits']}; "
        f"peak memory of "
        f"forward + backward: kernels {f['peak_mib']:.1f} MiB, library "
        f"{f['library_peak_mib']:.1f} MiB")
    return res


def phase7() -> dict:
    import torch
    cuda_tests = load_test_module("test_torch_cuda")
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for case in FLASH_SHAPES:
        for key, err in flash_check(*case, cuda_tests).items():
            errs[key] = max(errs[key], err)
        torch.cuda.empty_cache()
    res = flash_timing(cuda_tests)
    for key in errs:
        res[key]["max_abs_err"] = errs[key]
    torch.cuda.empty_cache()
    return res


# -- phase 8 -------------------------------------------------------------------

def phase8() -> dict:
    import torch
    from pasero_torch.ops.flash_attention import (flash_bwd_dkv, flash_bwd_dq,
                                                  flash_fwd)
    from pasero_torch.ops.fused_ce import fused_ce_bwd, fused_ce_fwd
    from pasero_torch.scripts.bench_train import Workload
    work = Workload("llama_1b")
    work.run(3)                                            # warm-up
    torch.cuda.reset_peak_memory_stats()
    wrappers = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
                "flash_bwd_dkv": flash_bwd_dkv, "fused_ce_fwd": fused_ce_fwd,
                "fused_ce_bwd": fused_ce_bwd}
    for fn in wrappers.values():
        fn.launches = 0
    steps = 20
    logs, seconds = work.run(steps)
    counts = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [l["loss"] for l in logs]
    check(all(map(math.isfinite, losses)), f"non-finite losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    layers = work.layers
    want = {"flash_fwd": layers * steps, "flash_bwd_dq": layers * steps,
            "flash_bwd_dkv": layers * steps, "fused_ce_fwd": steps,
            "fused_ce_bwd": steps}
    check(counts == want, f"launches {counts} != {want} for {steps} steps of "
          f"one micro-batch through {layers} layers")
    log(f"phase 8: llama_1b V=32000 B=4 T=2048 bf16 training: "
        f"{work.tokens_per_step * steps / seconds:.1f} tok/s, "
        f"{seconds * 1e3 / steps:.3f} ms per step, peak memory "
        f"{peak / 2**20:.1f} MiB, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"launches {counts} for {steps} steps x {layers} layers")
    del work
    torch.cuda.empty_cache()
    return counts


# -- phase 9 -------------------------------------------------------------------

def phase9() -> dict:
    import shutil
    cli = load_test_module("test_torch_train_cli")
    model_dir = os.path.join(ROOT, "build", "smoke-lm")
    shutil.rmtree(model_dir, ignore_errors=True)
    os.makedirs(model_dir)
    ckpt = os.path.join(ROOT, "build", "smoke-lm-init.npz")
    cli.write_initial_weights(ckpt, LM_CONFIG)
    cmd = [sys.executable, "-m", "pasero_torch.cli.train",
           *cli.train_flags(model_dir, ckpt, LM_CONFIG), "--valid-interval",
           "10", "--save-interval", "10"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    elapsed = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    check(proc.returncode == 0, f"cli.train (LM) failed:\n{out[-4000:]}")
    logs = cli.parse_log(out)
    with open(LM_GOLDEN) as f:
        golden = json.load(f)["steps"]
    check([l["step"] for l in logs] == [g["step"] for g in golden],
          f"logged steps {[l['step'] for l in logs]}")
    worst = 0.0
    for got, want in zip(logs, golden):
        rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        worst = max(worst, rel)
        check(rel <= TRAIN_RTOL, f"LM step {got['step']}: loss {got['loss']} "
              f"vs JAX {want['loss']}")
    counts = parse_launches(out)
    micro, valid = counts["train micro-batches"], counts["valid batches"]
    with open(os.path.join(model_dir, "config.json")) as f:
        layers = json.load(f)["decoder_layers"]
    check(micro == 20 and valid > 0, f"{micro} micro-batches, {valid} "
          "validation batches")
    want = {"flash_fwd": layers * (micro + valid),
            "flash_bwd_dq": layers * micro, "flash_bwd_dkv": layers * micro,
            "fused_ce_fwd": micro + valid, "fused_ce_bwd": micro}
    got = {key: counts[key] for key in want}
    check(got == want, f"LM launches {got} != {want}")
    log(f"phase 9: python -m pasero_torch.cli.train on lm_mini.yaml, 20 steps "
        f"in {elapsed:.1f} s: losses {logs[0]['loss']:.3f} -> "
        f"{logs[-1]['loss']:.3f}, all within {worst:.4%} of the JAX training "
        f"CLI's; launches {got} for {micro} micro-batches and {valid} "
        f"validation batches through {layers} layers")
    return got


# -- phase 10 ------------------------------------------------------------------

# the int8 head's device ms per call at (8, 2048, 32000), cold, before the
# decode kernel (PERF.md, "NVIDIA H100 80GB HBM3, 700.00 W"): a gate, not a
# reading of this run
INT8_HEAD_EARLIER_MS = 0.0343
# the int8 kernel's device ms per call at M = 1024 (a prompt), cold, before
# the wgmma prompt kernel (PERF.md; (2048, 256) and (5632, 2048) from
# bench_int8.py run from the parent checkout), "NVIDIA H100 80GB HBM3, 700.00
# W": gates, not readings of this run
INT8_PROMPT_EARLIER_MS = {(2048, 2048): 0.0615, (2048, 256): 0.0395,
                          (2048, 5632): 0.16173, (5632, 2048): 0.1496,
                          (2048, 32000): 0.8154}
# the fused heads' device ms per call at (N, 2048, 32000), cold, CUDA graph,
# of their first design (mma.sync tiles with x as the m16 side), before the
# decode stream and the wgmma prompt kernels (PERF.md's bracketed readings,
# "NVIDIA H100 80GB HBM3, 700.00 W"): gates, not readings of this run
HEAD_EARLIER_MS = {("fused_head_argmax", 8): 0.07473,
                   ("fused_head_argmax", 72): 0.23184,
                   ("fused_head_argmax", 1024): 1.07569,
                   ("fused_head_argmax_q8", 8): 0.05193,
                   ("fused_head_argmax_q8", 72): 0.17675,
                   ("fused_head_argmax_q8", 1024): 0.95606}


def phase10() -> dict:
    """The int8 GEMM and the fused heads against their plain versions;
    returns their errors and timings: each of llama_1b's decode shapes and
    the sum over one decoder call at M = 8 and 72, by
    pasero_torch/scripts/bench_int8.py's timing."""
    import torch
    from pasero_torch.scripts.bench_int8 import (LLAMA_1B_WEIGHTS,
                                                 decoder_call, head_timing,
                                                 int8_timing)
    cuda_tests = load_test_module("test_torch_cuda")
    res = {"int8_matmul": {"max_abs_err": 0.0, "by_shape": []},
           "fused_head_argmax": {"max_abs_err": 0.0, "by_shape": []},
           "fused_head_argmax_q8": {"max_abs_err": 0.0, "by_shape": []}}
    for shape in (cuda_tests.INT8_SHAPES + cuda_tests.INT8_RAGGED
                  + cuda_tests.INT8_DECODE + cuda_tests.INT8_PROMPT):
        for out_dtype in (torch.bfloat16, torch.float32):
            r = cuda_tests.int8_compare(*shape, out_dtype)
            check(r["excess"] <= 1.0, f"int8_matmul differs at {shape} "
                  f"{out_dtype}: {r['excess']:.3f} of the limit")
            check(r["same_bits"], f"two int8_matmul calls at {shape} "
                  f"{out_dtype} gave other bits")
            check(r["bad_scale_excess"] > 1.0 and r["shift_excess"] > 1.0,
                  f"the int8 check at {shape} passes a rolled scale or a "
                  f"shifted result: {r}")
            if out_dtype == torch.bfloat16:
                res["int8_matmul"]["max_abs_err"] = max(
                    res["int8_matmul"]["max_abs_err"], r["max_abs_err"])
            log(f"phase 10: int8_matmul == plain at {shape} {out_dtype}: "
                f"{r['excess']:.4f} of the limit, max abs err "
                f"{r['max_abs_err']:.3e}; a rolled scale at "
                f"{r['bad_scale_excess']:.1f}, a shifted column at "
                f"{r['shift_excess']:.1f}; the same bits twice")
        torch.cuda.empty_cache()
    for shape in cuda_tests.HEAD_SHAPES:
        for q8 in (False, True):
            name = "fused_head_argmax_q8" if q8 else "fused_head_argmax"
            r = cuda_tests.head_compare(*shape, q8)
            check(r["excess"] <= 1.0 and r["decided"] >= shape[0] // 2,
                  f"{name} differs at {shape}: {r}")
            check(r["bad_excess"] > 1.0, f"the {name} check at {shape} passes "
                  f"a wrong {'scale' if q8 else 'head row'}: {r}")
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                           r["max_abs_err"])
            log(f"phase 10: {name} == plain at {shape}: tokens equal on the "
                f"{r['decided']} rows whose top-two gap exceeds twice the "
                f"limit, log-probabilities at {r['excess']:.4f} of theirs "
                f"(max abs err {r['max_abs_err']:.3e}); a wrong "
                f"{'scale' if q8 else 'head row'} at {r['bad_excess']:.1f}")
        torch.cuda.empty_cache()
    for N in sorted(cuda_tests.TIE_ROWS):
        for q8 in (False, True):
            name = "fused_head_argmax_q8" if q8 else "fused_head_argmax"
            r = cuda_tests.head_tie_compare(N, q8)
            check(r["planted"], f"the ties planted for {name} at N = {N} "
                  f"do not tie in float64: {r}")
            check(r["tokens"] == r["lows"], f"{name} at N = {N} does not "
                  f"give the lowest index of equal maxima: {r}")
            check(r["same_bits"], f"two {name} calls at N = {N} gave other "
                  f"bits")
            check(r["lp_excess"] <= 1.0, f"{name} at N = {N} with ties: "
                  f"log-probabilities at {r['lp_excess']:.3f} of the limit")
            log(f"phase 10: {name} at ({N}, 2048, 32000) with "
                f"{len(r['lows'])} planted ties across tile and merge "
                f"boundaries: the lowest index every time, the same bits "
                f"twice, log-probabilities at {r['lp_excess']:.4f} of the "
                f"limit")
        torch.cuda.empty_cache()
    for M in (8, 72, 1024):
        timed = []
        for K, N in LLAMA_1B_WEIGHTS:
            r = int8_timing(M, K, N)
            timed.append(r)
            readings = {key: " ".join(f"{t:.5f}" for t in r[f"{key}_readings"])
                        for key in ("ms", "library_ms")}
            log(f"phase 10: int8_matmul at {r['shape']} bf16, device ms per "
                f"call (CUDA graph), the weight cold ({r['copies']} copies), "
                f"medians of readings taken in turn: kernel {r['ms']:.5f} "
                f"({readings['ms']}; bound {r['bound_ms']:.5f}, "
                f"{r['bound_by']}), library {r['library_ms']:.5f} "
                f"({readings['library_ms']}); hot (one "
                f"weight): kernel {r['hot_ms']:.5f}, library "
                f"{r['library_hot_ms']:.5f}; plain {r['plain_ms']:.5f}; with "
                f"eager launches: kernel {r['host_ms']:.5f}, library "
                f"{r['library_host_ms']:.5f}")
            if M == 8:
                check(r["ms"] <= r["library_ms"], f"the int8 kernel's median "
                      f"is {r['ms']:.5f} ms at {r['shape']} cold, more than "
                      f"F.linear's {r['library_ms']:.5f}")
            if M == 1024:
                earlier = INT8_PROMPT_EARLIER_MS[(K, N)]
                check(r["ms"] <= earlier, f"the int8 prompt kernel's median "
                      f"is {r['ms']:.5f} ms at {r['shape']} cold, more than "
                      f"the {earlier} ms of the kernel it replaced")
        res["int8_matmul"]["by_shape"] += timed
        call = res["int8_matmul"][f"decoder_call_{M}"] = decoder_call(timed)
        log(f"phase 10: int8_matmul over one llama_1b decoder call "
            f"({call['layer_weights']} weights and the head) at M = {M}"
            f"{' (the prompt)' if M > 80 else ''}, cold: "
            f"kernel {call['ms']:.4f} ms, library {call['library_ms']:.4f}"
            f", bound {call['bound_ms']:.4f}")
        if M == 8:
            check(call["ms"] <= call["library_ms"], f"the int8 kernel takes "
                  f"{call['ms']:.4f} ms over a decoder call, more than "
                  f"F.linear's {call['library_ms']:.4f}")
            head = timed[-1]
            check(head["ms"] <= INT8_HEAD_EARLIER_MS, f"the int8 kernel takes "
                  f"{head['ms']:.5f} ms at the head {head['shape']}, more than "
                  f"the {INT8_HEAD_EARLIER_MS} ms before the decode kernel")
        torch.cuda.empty_cache()
    for N in (8, 72, 1024):
        for q8 in (False, True):
            name = "fused_head_argmax_q8" if q8 else "fused_head_argmax"
            r = head_timing(N, 2048, 32000, q8)
            res[name]["by_shape"].append(r)
            earlier = HEAD_EARLIER_MS[(name, N)]
            log(f"phase 10: {name} at {r['shape']}, device ms per call (CUDA "
                f"graph), the head cold ({r['copies']} copies): kernels "
                f"{r['ms']:.5f} (bound {r['bound_ms']:.5f}, {r['bound_by']}: "
                f"{100 * r['bound_ms'] / r['ms']:.1f} % of it; first design "
                f"{earlier}), library {r['library_ms']:.5f}; hot (one head): "
                f"kernels {r['hot_ms']:.5f}, library "
                f"{r['library_hot_ms']:.5f}; plain {r['plain_ms']:.5f}")
            check(r["ms"] <= r["library_ms"], f"{name} takes {r['ms']:.5f} "
                  f"ms at {r['shape']} cold, more than the library's "
                  f"{r['library_ms']:.5f}")
            check(r["ms"] < earlier, f"{name} takes {r['ms']:.5f} ms at "
                  f"{r['shape']} cold, no less than its first design's "
                  f"{earlier}")
            torch.cuda.empty_cache()
    return res


# -- phase 11 ------------------------------------------------------------------

LM_MODES = [   # name, int8 weights, fused head, speculative
    ("bf16 greedy", False, False, False),
    ("bf16 fused head", False, True, False),
    ("speculative", False, False, True),
    ("int8 greedy", True, False, False),
    ("int8 fused head", True, True, False),
]


def phase11() -> dict:
    """llama_1b decode in each mode of LM_MODES; returns the launch counts of
    each mode's run."""
    import torch
    from pasero_torch.ops.cache_update import cache_slot_write_
    from pasero_torch.ops.fused_ce import (fused_head_argmax,
                                           fused_head_argmax_q8)
    from pasero_torch.ops.quantize import int8_matmul
    from pasero_torch.scripts.bench_decode import LMWorkload
    wrappers = {"int8_matmul": int8_matmul,
                "fused_head_argmax": fused_head_argmax,
                "fused_head_argmax_q8": fused_head_argmax_q8,
                "cache_slot_write": cache_slot_write_}
    t0 = time.perf_counter()
    work = LMWorkload()
    log(f"phase 11: llama_1b with seeded weights built in "
        f"{time.perf_counter() - t0:.1f} s")
    layers = work.cfg.decoder_layers
    B, N = work.prompt.shape[0], work.max_new
    results, tokens = {}, {}
    for name, q8, fused, spec in LM_MODES:
        if q8 and not work.quantized:
            work.quantize()
            qb, fb = work.quantized_bytes
            log(f"phase 11: quantized {work.quantized} weights: "
                f"{qb / 2**20:.1f} MiB int8 + {fb / 2**20:.1f} MiB float")
        work.fused_head, work.speculative = fused, spec
        work.run()                                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        work.model.single_token_calls = 0
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = work.run()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = {key: fn.launches for key, fn in wrappers.items()}
        calls = out["model_calls"]
        want = {"int8_matmul": (7 * layers + (not fused)) * calls if q8 else 0,
                "fused_head_argmax": calls if fused and not q8 else 0,
                "fused_head_argmax_q8": calls if fused and q8 else 0,
                "cache_slot_write": layers * work.model.single_token_calls}
        check(counts == want, f"llama_1b {name}: launches {counts} != {want} "
              f"for {calls} decoder calls")
        check(tuple(out["tokens"].shape) == (B, N), f"{name}: tokens shape")
        check(bool(torch.isfinite(out["scores"]).all()),
              f"{name}: non-finite scores")
        out_tokens = work.output_tokens(out)
        peak = torch.cuda.max_memory_allocated()
        tokens[name] = out["tokens"]
        results[name] = counts
        agree = (out["tokens"] == tokens["bf16 greedy"]).float().mean().item()
        log(f"phase 11: llama_1b {name} B={B} P={work.prompt.shape[1]} "
            f"new={N}: {out_tokens / elapsed:.1f} output tok/s, "
            f"{elapsed * 1e3 / calls:.3f} ms per decoder call ({calls} calls, "
            f"{elapsed:.3f} s), peak memory {peak / 2**20:.1f} MiB; launches "
            f"{counts}; tokens equal to bf16 greedy's at {agree:.4f} of "
            f"positions")
    runs = []
    for _ in range(2):
        generator = torch.Generator(device="cuda").manual_seed(1)
        runs.append(work.run(sampling=dict(top_k=50, generator=generator)))
    check(torch.equal(runs[0]["tokens"], runs[1]["tokens"]),
          "two sampling runs from one seed differ")
    check(bool(torch.isfinite(runs[0]["scores"]).all()),
          "non-finite sampling scores")
    log(f"phase 11: int8 sampling (top-k 50) twice from seed 1: identical "
        f"tokens; {(runs[0]['tokens'] != tokens['int8 greedy']).float().mean().item():.4f}"
        f" of positions differ from int8 greedy's")
    del work
    torch.cuda.empty_cache()
    return results


# -- phase 12 ------------------------------------------------------------------

def lm_prompts() -> list:
    """The first four words of the first 32 lines of deen-mini's test.en,
    the prompts of the lm-mini2 golden files."""
    with open(os.path.join(ROOT, "examples", "deen-mini", "data",
                           "test.en")) as f:
        return [" ".join(line.split()[:4]) for line, _ in zip(f, range(32))]


def golden_lines(name: str) -> list:
    with open(os.path.join(TESTDATA, name)) as f:
        return [l.rstrip("\n") for l in f]


def phase12() -> dict:
    import torch
    from pasero_torch.decoding.generator import TextGenerator
    from pasero_torch.ops.fused_ce import fused_head_argmax_q8
    from pasero_torch.ops.quantize import int8_matmul
    lm = os.path.join(TESTDATA, "lm-mini2")
    prompts = lm_prompts()
    gen = TextGenerator.build(lm, max_output_len=24)
    check(gen.device.type == "cuda", f"generator runs on {gen.device}")
    greedy = gen.decode(prompts)
    golden = golden_lines("lm_mini2_greedy.jax.txt")
    same = sum(h == g for h, g in zip(greedy, golden))
    log(f"phase 12: lm-mini2 bf16 greedy: {same}/{len(golden)} lines "
        f"identical to the JAX output")
    check(same >= MIN_LM_MATCH, f"lm-mini2 greedy: only {same}/32 lines match")
    spec = TextGenerator.build(lm, max_output_len=24, speculative=True,
                               speculative_draft_len=8).decode(prompts)
    same_spec = sum(h == g for h, g in zip(spec, greedy))
    log(f"phase 12: lm-mini2 speculative (drafts of 8): {same_spec}/32 lines "
        f"identical to the port's greedy output")
    check(same_spec == len(prompts), "speculative differs from greedy")

    saved = {k: os.environ.get(k) for k in INT8_FUSED_ENV}
    os.environ.update(INT8_FUSED_ENV)
    try:
        int8_matmul.launches = fused_head_argmax_q8.launches = 0
        hyps = TextGenerator.build(lm, max_output_len=24,
                                   quantize="int8").decode(prompts)
        launches = {"int8_matmul": int8_matmul.launches,
                    "fused_head_argmax_q8": fused_head_argmax_q8.launches}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    golden = golden_lines("lm_mini2_greedy_int8_fused.jax.txt")
    same_q8 = sum(h == g for h, g in zip(hyps, golden))
    log(f"phase 12: lm-mini2 int8 weights, fused head: {same_q8}/32 lines "
        f"identical to the JAX output; launches {launches}")
    check(same_q8 >= MIN_LM_MATCH,
          f"lm-mini2 int8 fused: only {same_q8}/32 lines match")
    check(min(launches.values()) > 0, f"the int8 path launched {launches}")

    dialogue = TextGenerator.build(lm, task="dialogue", max_output_len=24)
    answer = dialogue.decode(["Thomas works until"])
    check(len(answer) == 1 and isinstance(answer[0], str),
          f"dialogue decode gave {answer!r}")
    log(f"phase 12: dialogue (chatml) decode: {answer[0]!r}; the JAX "
        f"output {golden_lines('lm_mini2_dialogue.jax.txt')[0]!r}")

    data = os.path.join(ROOT, "examples", "deen-mini", "data")
    cmd = [sys.executable, "-m", "pasero_torch.cli.decode",
           os.path.join(ROOT, "models", "deen-mini2"), "-i",
           os.path.join(data, "test.de"), "--quantize", "int8",
           "--beam-size", "5"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    elapsed = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli.decode --quantize int8 failed:\n"
          f"{proc.stderr[-4000:]}")
    hyps = proc.stdout.rstrip("\n").split("\n")
    golden = golden_lines("deen_mini2_test_beam5_int8.jax.txt")
    same_mt = sum(h == g for h, g in zip(hyps, golden))
    counts = parse_launches(proc.stderr)
    log(f"phase 12: python -m pasero_torch.cli.decode models/deen-mini2 "
        f"--quantize int8 --beam-size 5 in {elapsed:.1f} s: {same_mt}/"
        f"{len(golden)} lines identical to the JAX int8 output; launches "
        f"{counts}")
    check(len(hyps) == len(golden) and same_mt >= MIN_GOLDEN_MATCH,
          f"deen-mini2 int8: only {same_mt}/{len(golden)} lines match")
    check(counts["int8_matmul"] > 0, "cli.decode --quantize int8 launched no "
          "int8 kernel")
    torch.cuda.synchronize()
    return {"lm_int8_fused": launches, "mt_int8": counts}


# -- phase 13 ------------------------------------------------------------------

def mel_timing(B, N) -> dict:
    """Device ms per call (CUDA graph) of the mel kernel, its plain version
    and the library yardstick at (B, N); the operations of the kernel's
    factored method and of an FFT, and the bounds of each."""
    import torch
    from pasero_torch.ops.mel import (kernel_flops, num_frames, power_mel,
                                      power_mel_plain)
    cuda_tests = load_test_module("test_torch_cuda")
    audio = cuda_tests.mel_inputs(B, N)
    window, mel_w = cuda_tests.mel_constants()
    n_fft = window.shape[0]
    n_freq, n_mels = mel_w.shape

    def library():
        # one PyTorch call per step, never called by the port: an FFT
        spec = torch.stft(audio, n_fft, hop_length=160, window=window,
                          center=True, pad_mode="reflect",
                          return_complex=True)[..., :-1]
        return (spec.abs() ** 2).transpose(1, 2) @ mel_w

    T = num_frames(N, n_fft, 160)
    # the kernel's own method: the factored DFT (ops/mel.py:kernel_flops)
    flops = B * T * kernel_flops(n_fft, mel_w)
    # the dense DFT products of the plain version and of the kernel before
    dense_flops = B * T * (2 * n_fft * 2 * n_freq + 3 * n_freq
                           + 2 * n_freq * n_mels)
    # the least work for the same function: a real FFT of n_fft points
    # (2.5 n_fft log2 n_fft operations), the power and the mel product
    fft_flops = B * T * (2.5 * n_fft * math.log2(n_fft) + 3 * n_freq
                         + 2 * n_freq * n_mels)
    nbytes = 4 * (B * N + B * T * n_mels + 3 * n_fft + n_freq * n_mels)
    ops_ms = flops / FP32_FLOPS * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    fft_ms = fft_flops / FP32_FLOPS * 1e3
    iters = 20 if B > 1 else 100
    res = {"shape": [B, N], "frames": B * T, "flops": flops, "bytes": nbytes,
           "method_bound_ms": max(ops_ms, bytes_ms),
           "bound_ms": max(fft_ms, bytes_ms),
           "bound_by": "operations" if fft_ms >= bytes_ms else "bytes",
           "bytes_ms": bytes_ms, "fft_flops": fft_flops,
           "dense_flops": dense_flops,
           "ms": device_ms(lambda: power_mel(audio, window, mel_w), iters, 5),
           "plain_ms": device_ms(lambda: power_mel_plain(audio, window,
                                                         mel_w), iters, 5),
           "library_ms": device_ms(library, iters, 5)}
    res["host_ms"] = time_ms(lambda: power_mel(audio, window, mel_w), iters)
    return res


def phase13() -> dict:
    """The mel kernel against its plain version; returns its errors and
    timings."""
    import torch
    cuda_tests = load_test_module("test_torch_cuda")
    res = {"max_abs_err": 0.0, "by_shape": []}
    cases = [(B, N, "noise", 80) for B, N in cuda_tests.MEL_SHAPES] + \
        [(2, 32000, "tone", 80), (2, 32000, "tone", 128)]
    for B, N, kind, n_mels in cases:
        r = cuda_tests.mel_compare(B, N, kind, n_mels)
        check(r["excess"] <= 1.0 and r["plain_excess"] <= 1.0,
              f"power_mel differs at ({B}, {N}) {kind} {n_mels} mels: {r}")
        if kind == "noise":
            check(r["shift_excess"] > 1.0 and r["roll_excess"] > 1.0
                  and r["window_excess"] > 1.0,
                  f"the mel check at ({B}, {N}) passes shifted frames, a "
                  f"rolled filterbank or a rolled window: {r}")
        res["max_abs_err"] = max(res["max_abs_err"], r["max_abs_err"])
        log(f"phase 13: power_mel == plain at ({B}, {N}) {kind}, {n_mels} "
            f"mels, {r['frames']} frames per row: {r['excess']:.4f} of the "
            f"limit (plain {r['plain_excess']:.4f}), max abs err of log10 "
            f"{r['max_abs_err']:.3e}; frames one hop off at "
            f"{r['shift_excess']:.1f}, a rolled filterbank column at "
            f"{r['roll_excess']:.1f}, the window rolled by one sample at "
            f"{r['window_excess']:.1f}")
        torch.cuda.empty_cache()
    for B, N in ((16, 480000), (1, 480000)):
        r = mel_timing(B, N)
        res["by_shape"].append(r)
        check(r["ms"] <= r["library_ms"], f"the mel kernel takes "
              f"{r['ms']:.5f} ms at ({B}, {N}), more than the library "
              f"yardstick's {r['library_ms']:.5f}")
        log(f"phase 13: power_mel at {r['shape']} ({r['frames']} frames), "
            f"device ms per call (CUDA graph): kernel {r['ms']:.5f} (its "
            f"factored method {r['flops'] / 1e9:.3f} GFLOP: "
            f"{r['method_bound_ms']:.5f} ms; an FFT's "
            f"{r['fft_flops'] / 1e9:.3f} GFLOP: {r['bound_ms']:.5f} ms, "
            f"{r['bound_by']}; {r['bytes'] / 1e6:.1f} MB: "
            f"{r['bytes_ms']:.5f} ms; the dense products "
            f"{r['dense_flops'] / 1e9:.2f} GFLOP), plain "
            f"{r['plain_ms']:.5f}, library {r['library_ms']:.5f}; eager "
            f"{r['host_ms']:.5f}; {r['frames'] / r['ms'] * 1e3:.4g} frames/s")
        torch.cuda.empty_cache()
    return res


# -- phase 14 ------------------------------------------------------------------

def phase14() -> dict:
    import shutil
    import torch
    from pasero_torch.decoding.generator import TextGenerator
    from pasero_torch.ops.cache_update import cache_slot_write_
    from pasero_torch.ops.mel import power_mel
    wavs = sorted(glob.glob(os.path.join(ST, "wav", "*.wav")))
    check(len(wavs) == 32, f"{len(wavs)} st-mini wavs")
    gen = TextGenerator.build(ST)
    check(gen.device.type == "cuda", f"generator runs on {gen.device}")
    gen.decode(wavs[:2])                          # warm-up
    torch.cuda.synchronize()
    power_mel.launches = cache_slot_write_.launches = 0
    gen.model.single_token_calls = 0
    t0 = time.perf_counter()
    hyps = gen.decode(wavs)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"power_mel": power_mel.launches,
                "cache_slot_write": cache_slot_write_.launches}
    calls = gen.model.single_token_calls
    golden = golden_lines("st_mini_greedy.jax.txt")
    same = sum(h == g for h, g in zip(hyps, golden))
    log(f"phase 14: st-mini TextGenerator.decode of {len(wavs)} wavs (bf16 "
        f"greedy, prompt {gen.task.get_target_tags(gen.task.make_meta())}) "
        f"in {elapsed:.3f} s: {same}/{len(golden)} lines identical to the "
        f"JAX output; launches {launches} for {calls} single-token decoder "
        f"calls x {gen.model_cfg.decoder_layers} layers")
    for h, g in zip(hyps, golden):
        if h != g:
            log(f"  differs: port {h!r}\n           JAX  {g!r}")
    check(same >= MIN_LM_MATCH, f"st-mini greedy: only {same}/32 lines match")
    check(launches["power_mel"] == len(wavs),
          f"{launches['power_mel']} mel launches for {len(wavs)} wavs")
    check(launches["cache_slot_write"] > 0 and launches["cache_slot_write"]
          == calls * gen.model_cfg.decoder_layers,
          f"slot-write launches {launches} for {calls} calls")

    cmd = [sys.executable, "-m", "pasero_torch.cli.decode", ST, "-i",
           os.path.join(ST, "test.feats"), "--beam-size", "5"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    elapsed = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli.decode on st-mini failed:\n"
          f"{proc.stderr[-4000:]}")
    beam = proc.stdout.rstrip("\n").split("\n")
    golden = golden_lines("st_mini_beam5.jax.txt")
    same_beam = sum(h == g for h, g in zip(beam, golden))
    log(f"phase 14: python -m pasero_torch.cli.decode st-mini -i test.feats "
        f"--beam-size 5 in {elapsed:.1f} s: {same_beam}/{len(golden)} lines "
        f"identical to the JAX output; launches "
        f"{parse_launches(proc.stderr)}")
    check(len(beam) == len(golden) and same_beam >= MIN_LM_MATCH,
          f"st-mini beam-5: only {same_beam}/{len(golden)} lines match")

    from pasero_torch.data.files import NumpyFile
    from pasero_torch.scripts.extract_features import BATCH, batches
    feats = os.path.join(ROOT, "build", "smoke-st.feats")
    proc = subprocess.run([sys.executable, "-m",
                           "pasero_torch.scripts.extract_features", *wavs,
                           "-o", feats], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    check(proc.returncode == 0, f"extract_features failed:\n"
          f"{proc.stderr[-4000:]}")
    runs = sum(1 for _ in batches(wavs, BATCH))
    extract_launches = int(re.search(r"\((\d+) mel kernel launches\)",
                                     proc.stdout).group(1))
    got = list(NumpyFile(feats))
    want = list(NumpyFile(os.path.join(ST, "test.feats")))
    diff = max(float(abs(a.astype("float32") - b.astype("float32")).max())
               for a, b in zip(got, want))
    log(f"phase 14: python -m pasero_torch.scripts.extract_features on the "
        f"{len(wavs)} wavs: {extract_launches} mel launches for {runs} runs "
        f"of equal-length wavs; float16 features within {diff:.2e} of the "
        f"JAX extract_features.py's (test.feats)")
    check(len(got) == len(want) and all(a.shape == b.shape
                                        for a, b in zip(got, want)),
          "extract_features wrote other shapes than test.feats")
    check(extract_launches == runs, f"{extract_launches} mel launches for "
          f"{runs} runs of equal-length wavs")
    check(diff <= 2.0 ** -9, f"features differ from test.feats by {diff}")

    cli = load_test_module("test_torch_train_cli")
    model_dir = os.path.join(ROOT, "build", "smoke-st")
    shutil.rmtree(model_dir, ignore_errors=True)
    os.makedirs(model_dir)
    ckpt = os.path.join(ROOT, "build", "smoke-st-init.npz")
    cli.write_initial_weights(ckpt, ST_CONFIG)
    cmd = [sys.executable, "-m", "pasero_torch.cli.train",
           *cli.train_flags(model_dir, ckpt, ST_CONFIG)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    elapsed = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    check(proc.returncode == 0, f"cli.train on st_mini.yaml failed:\n"
          f"{out[-4000:]}")
    logs = cli.parse_log(out)
    with open(os.path.join(TESTDATA, "st_mini_train20.jax.json")) as f:
        want = json.load(f)["steps"]
    check([l["step"] for l in logs] == [w["step"] for w in want],
          f"logged steps {[l['step'] for l in logs]}")
    worst = max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                for g, w in zip(logs, want))
    check(worst <= TRAIN_RTOL, f"st-mini losses differ from JAX's by up to "
          f"{worst:.4%}")
    counts = parse_launches(out)
    micro, valid = counts["train micro-batches"], counts["valid batches"]
    check(counts["fused_ce_fwd"] == micro + valid and counts["fused_ce_bwd"]
          == micro and micro == 20, f"fused CE launches {counts}")
    log(f"phase 14: python -m pasero_torch.cli.train on st_mini.yaml, 20 "
        f"steps in {elapsed:.1f} s: losses {logs[0]['loss']:.3f} -> "
        f"{logs[-1]['loss']:.3f}, all within {worst:.4%} of the JAX training "
        f"CLI's; launches {counts}")
    return {**launches, "extract_launches": extract_launches,
            "beam5_same": same_beam, "greedy_same": same,
            "train_worst_rel": worst, "fused_ce_fwd": counts["fused_ce_fwd"],
            "fused_ce_bwd": counts["fused_ce_bwd"]}


# -- phase 15 ------------------------------------------------------------------

def phase15() -> dict:
    import torch
    from pasero_torch.ops.cache_update import cache_slot_write_
    from pasero_torch.ops.fused_ce import fused_ce_bwd, fused_ce_fwd
    from pasero_torch.ops.mel import power_mel
    from pasero_torch.scripts.bench_decode import WhisperWorkload
    from pasero_torch.scripts.bench_train import Workload
    t0 = time.perf_counter()
    # a whisper_base model directory (seeded weights, a 51865-entry
    # dictionary) and 8 wavs of 30 s, decoded by TextGenerator.decode
    work = WhisperWorkload()
    gen = work.generator
    check(gen.device.type == "cuda", f"generator runs on {gen.device}")
    log(f"phase 15: whisper_base model directory with seeded weights and "
        f"{len(work.wavs)} wavs written and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    work.run()                                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    power_mel.launches = cache_slot_write_.launches = 0
    work.model.single_token_calls = 0
    t0 = time.perf_counter()
    out = work.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    calls = out["model_calls"]
    layers = work.cfg.decoder_layers
    decode = {"power_mel": power_mel.launches,
              "cache_slot_write": cache_slot_write_.launches,
              "model_calls": calls, "seconds": seconds,
              "output_tokens": work.output_tokens(out),
              "ms_per_decoder_call": seconds * 1e3 / calls,
              "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
    decode["tok_per_s"] = decode["output_tokens"] / seconds
    log(f"phase 15: whisper_base TextGenerator.decode of {len(work.wavs)} "
        f"wavs of 30 s (greedy, prompt {work.prompt}): "
        f"{decode['tok_per_s']:.1f} output tok/s, "
        f"{decode['ms_per_decoder_call']:.3f} ms per decoder call ({calls} "
        f"calls, {seconds:.3f} s with the wav reads, the mel and the "
        f"encoder), peak memory {decode['peak_mib']:.1f} MiB; launches "
        f"power_mel {decode['power_mel']}, cache_slot_write "
        f"{decode['cache_slot_write']}")
    hyps = out["hyps"]
    shapes = [(len(h[0]["tokens"]), h[0]["score"]) for h in hyps]
    check(len(hyps) == len(work.wavs) and decode["output_tokens"] > 0
          and all(n <= gen.cfg.max_output_len and math.isfinite(score)
                  for n, score in shapes),
          f"whisper_base hypotheses (tokens, score): {shapes}")
    check(decode["power_mel"] == len(work.wavs),
          f"{decode['power_mel']} mel launches for {len(work.wavs)} wavs")
    check(decode["cache_slot_write"] == layers * work.model.single_token_calls
          and decode["cache_slot_write"] > 0,
          f"{decode['cache_slot_write']} slot writes for "
          f"{work.model.single_token_calls} single-token calls")
    del work, gen, out, hyps
    torch.cuda.empty_cache()

    train = Workload("whisper_base")
    train.run(1)                                  # warm-up
    torch.cuda.reset_peak_memory_stats()
    fused_ce_fwd.launches = fused_ce_bwd.launches = 0
    steps = 3
    logs, seconds = train.run(steps)
    result = {"steps": steps, "ms_per_step": seconds * 1e3 / steps,
              "target_tok_per_s": train.tokens_per_step * steps / seconds,
              "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
              "fused_ce_fwd": fused_ce_fwd.launches,
              "fused_ce_bwd": fused_ce_bwd.launches,
              "losses": [l["loss"] for l in logs]}
    log(f"phase 15: whisper_base training 16 x 3000 frames, 128 target "
        f"tokens, vocabulary 51865: {result['ms_per_step']:.3f} ms per step, "
        f"{result['target_tok_per_s']:.1f} target tok/s, peak memory "
        f"{result['peak_mib']:.1f} MiB, losses {result['losses']}; launches "
        f"fused_ce_fwd {result['fused_ce_fwd']} fused_ce_bwd "
        f"{result['fused_ce_bwd']}")
    check(all(math.isfinite(l) for l in result["losses"]),
          f"non-finite losses {result['losses']}")
    check(result["fused_ce_fwd"] == steps and result["fused_ce_bwd"] == steps,
          f"fused CE launches {result} for {steps} steps")
    del train
    torch.cuda.empty_cache()
    return {"decode": decode, "train": result}


# -- phase 16 ------------------------------------------------------------------

FLASH_BIAS_SHAPES = [   # (B, H, Hkv, S, D), causal, window, padded, bias kind
    ((4, 16, 16, 2048, 64), True, None, False, "alibi"),    # bloom_560m
    ((2, 8, 8, 1000, 128), True, None, True, "learned_1xH"),  # learned (1, H)
    ((2, 16, 4, 777, 64), True, 256, True, "learned_1xH"),  # GQA 4, window
    ((2, 8, 8, 1000, 128), False, None, True, "Bx1"),
    ((3, 4, 2, 45, 32), True, None, True, "1x1"),
    ((2, 4, 4, 300, 128), True, None, True, "1x1"),          # shared, D = 128
    ((2, 16, 16, 500, 64), False, None, True, "encoder"),   # rows of -1e9
    ((26, 16, 16, 315, 64), True, None, False, "alibi"),    # a length bucket
    ((1, 2, 2, 16500, 128), True, None, False, "alibi16"),  # past 16384 keys
]
# device ms per call of the biased forward, dq and dk/dv kernels that
# flash_bwd.cu's replaced (flash_attention.cu's mma.sync kernels) at
# bloom_560m's shape (PERF.md, "NVIDIA H100 80GB HBM3, 700.00 W"): a gate
# (the forward's) and log context, not readings of this run
BIAS_FWD_EARLIER_MS = 0.5023
BIAS_BWD_EARLIER_MS = {"dq": 0.7245, "dkv": 0.7445}


def flash_bias_check(case, cuda_tests) -> dict:
    """The four biased kernels against the plain version at one shape, by
    ``flash_bias_compare`` of tests/test_torch_cuda.py: lse within 1e-4,
    out, dq, dk, dv and dbias within their limits, and every mutation
    outside them. Returns the max abs errors."""
    import torch
    r = cuda_tests.flash_bias_compare(*case)
    shape, causal, window, padded, kind = case
    check(r["lse_err"] <= 1e-4,
          f"flash_fwd_bias lse differs at {shape} {kind} by {r['lse_err']}")
    check(max(r["excess"]) <= 1.0, f"biased flash kernels differ at {shape} "
          f"{kind}: out, dq, dk, dv, dbias at {r['excess']} of their limits")
    check(min(r["mutants"].values()) > 1.0 and min(
        r["mutants"][n] for n in cuda_tests.FWD_MUTANTS if n in r["mutants"])
        >= cuda_tests.FWD_MUTANT_MIN, f"the biased flash check at {shape} "
        f"{kind} passes a mutation, or a forward's below "
        f"{cuda_tests.FWD_MUTANT_MIN}x: {r['mutants']}")
    check(r["same_bits"], f"two biased forward and backward calls at "
          f"{shape} {kind} gave other bits")
    errs = r["max_abs_err"]
    log(f"phase 16: biased flash kernels == plain at {shape} causal {causal} "
        f"window {window} padded {padded} bias {kind}: out, dq, dk, dv, "
        f"dbias at {', '.join(f'{e:.3f}' for e in r['excess'])} of their "
        f"limits; mutations at {json.dumps({k: round(v, 1) for k, v in r['mutants'].items()})} "
        f"of them; out, lse, dq, dk, dv the same bits twice; max abs err lse {r['lse_err']:.3e} out {errs['fwd']:.3e} "
        f"dq {errs['dq']:.3e} dk/dv {errs['dkv']:.3e} dbias "
        f"{errs['dbias']:.3e}")
    torch.cuda.empty_cache()
    return errs


def flash_bias_timing(cuda_tests) -> dict:
    """At bloom_560m's training shape with its per-sample ALiBi bias: device
    ms per call of each biased kernel (CUDA graph; the forward, dq and dk/dv
    with the bias-free ones beside them by bench_flash_bwd's time_case), the
    plain version's ms, the bounds (the larger of the products over the bf16
    rate and the bytes over the memory rate, counting the causal half of the
    bias that this run reads), and the library yardstick: F.scaled_dot_product_attention
    with the bias (and the causal mask) as a bf16 float attn_mask, its
    backward, and its backward with the mask's gradient for dbias."""
    import torch
    import torch.nn.functional as F
    from pasero_torch.ops.flash_attention import (flash_bwd_dbias,
                                                  flash_bwd_dq,
                                                  flash_bwd_plain,
                                                  flash_dbias_plain, flash_fwd,
                                                  flash_fwd_plain, visible)
    from pasero_torch.scripts.bench_flash_bwd import time_case
    (B, H, Hkv, S, D), causal, window, padded, kind = FLASH_BIAS_SHAPES[0]
    q, k, v, do, mask = cuda_tests.flash_inputs(B, H, Hkv, S, D, padded)
    bias = cuda_tests.flash_bias(kind, B, H, S, mask)
    args = (D ** -0.5, causal, window)
    out, lse = flash_fwd(q, k, v, mask, *args, bias)
    _, delta = flash_bwd_dq(q, k, v, mask, out, lse, do, *args, bias)
    pairs = B * H * S * (S + 1) / 2
    product = 2.0 * pairs * D
    q_bytes, kv_bytes, row_bytes = B * H * S * D * 2, B * Hkv * S * D * 2, \
        B * H * S * 4
    bias_bytes = 4 * pairs          # the visible half of the (B, H) bias
    dbias_bytes = 4 * B * H * S * S  # written whole, zeros above the diagonal

    def bound(products, nbytes):
        ops, mem = products * product / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
        return {"bound_ms": max(ops, mem) * 1e3,
                "ops_bound_ms": ops * 1e3, "bytes_bound_ms": mem * 1e3,
                "bound_by": "operations" if ops >= mem else "bytes"}

    res = {
        "fwd": bound(2, 2 * q_bytes + 2 * kv_bytes + row_bytes + bias_bytes),
        # the backward's function (dq, dk, dv) reads the bias once; each of
        # its two kernels reads it once
        "bwd": bound(5, 4 * q_bytes + 4 * kv_bytes + row_bytes + bias_bytes),
        "dq": bound(3, 4 * q_bytes + 2 * kv_bytes + 2 * row_bytes
                    + bias_bytes),
        "dkv": bound(4, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
                     + bias_bytes),
        "dbias": bound(2, 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes
                       + bias_bytes + dbias_bytes),
    }
    timed = time_case((B, H, Hkv, S, D), causal, kind, window)
    for key in ("fwd", "dq", "dkv", "bwd"):
        res[key]["ms"] = timed[kind][key]
    res["bias_free"] = timed["none"]
    res["dbias"]["ms"] = device_ms(lambda: flash_bwd_dbias(
        q, k, v, mask, bias, do, lse, delta, *args), iters=10, replays=5)
    res["fwd"]["plain_ms"] = time_ms(
        lambda: flash_fwd_plain(q, k, v, mask, *args, bias), 3, 1)
    res["bwd"]["plain_ms"] = time_ms(
        lambda: flash_bwd_plain(q, k, v, mask, out, lse, do, *args, bias), 3,
        1)
    res["dbias"]["plain_ms"] = time_ms(
        lambda: flash_dbias_plain(q, k, v, mask, out, lse, do, *args, bias),
        3, 1)
    # the library yardstick; the port never calls it
    ok = visible(mask, S, causal, window)
    lib_mask = bias.masked_fill(~ok, float("-inf")).to(torch.bfloat16)
    lib = library_times(lambda *x: F.scaled_dot_product_attention(
        *x, attn_mask=lib_mask, scale=args[0]), (q, k, v), do)
    # dbias: the backward with the mask's gradient
    lib_dbias = library_times(lambda *x: F.scaled_dot_product_attention(
        *x[:3], attn_mask=x[3], scale=args[0]), (q, k, v, lib_mask), do, 5, 5)
    for key, r in (("fwd", lib), ("bwd", lib), ("dbias", lib_dbias)):
        side = "fwd" if key == "fwd" else "bwd"
        res[key]["library_ms"] = r[side]
        res[key]["library_host_ms"] = r[f"{side}_host"]
    res["dq"]["plain_ms"] = res["dkv"]["plain_ms"] = res["bwd"]["plain_ms"]
    for key in ("dq", "dkv"):
        res[key]["library_ms"] = res["bwd"]["library_ms"]
        res[key]["library_host_ms"] = res["bwd"]["library_host_ms"]
    del lib_mask
    for key in ("fwd", "dq", "dkv", "bwd", "dbias"):
        r = res[key]
        log(f"phase 16: at {(B, H, Hkv, S, D)} bf16 causal with a per-sample "
            f"ALiBi bias, {key}: device ms per call (CUDA graph) "
            f"{r['ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']}: "
            f"operations {r['ops_bound_ms']:.4f}, bytes "
            f"{r['bytes_bound_ms']:.4f}), plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']:.4f} (eager {r['library_host_ms']:.4f})")
    log(f"phase 16: at {(B, H, Hkv, S, D)} the biased backward dq "
        f"{res['dq']['ms']:.4f} + dk/dv {res['dkv']['ms']:.4f} ms (before "
        f"flash_bwd.cu's design {BIAS_BWD_EARLIER_MS['dq']} + "
        f"{BIAS_BWD_EARLIER_MS['dkv']}); the bias-free dq "
        f"{res['bias_free']['dq']:.4f} + dk/dv {res['bias_free']['dkv']:.4f} "
        f"at the same shape")
    check(res["bwd"]["ms"] <= res["bwd"]["library_ms"], f"the biased "
          f"backward takes {res['bwd']['ms']:.4f} ms at {(B, H, Hkv, S, D)}, "
          f"more than its library call's {res['bwd']['library_ms']:.4f}")
    f = res["fwd"]
    log(f"phase 16: at {(B, H, Hkv, S, D)} the biased forward {f['ms']:.4f} "
        f"ms; the bias-free forward {res['bias_free']['fwd']:.4f} at the same "
        "shape")
    check(f["ms"] <= f["library_ms"] and f["ms"] <= BIAS_FWD_EARLIER_MS,
          f"the biased forward takes {f['ms']:.4f} ms at {(B, H, Hkv, S, D)}, "
          f"more than its library call's {f['library_ms']:.4f} or the "
          f"{BIAS_FWD_EARLIER_MS} of the kernel it replaced")
    torch.cuda.empty_cache()
    return res


def bias_fwd_timing(case) -> dict:
    """The biased forward's device ms per call at one case of
    FLASH_BIAS_SHAPES (bench_flash_bwd's time_case, no key padded) beside
    the library yardstick's where its bf16 (B, H, S, S) mask fits:
    F.scaled_dot_product_attention with the bias and the mask as attn_mask
    (the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from pasero_torch.ops.flash_attention import visible
    from pasero_torch.scripts.bench_flash_bwd import inputs, time_case
    (B, H, Hkv, S, D), causal, window, _, kind = case
    res = {"shape": [B, H, Hkv, S, D], "causal": causal, "window": window,
           "bias": kind, "ms": time_case((B, H, Hkv, S, D), causal, kind,
                                         window, ("fwd",), False)[kind]["fwd"],
           "library_ms": None}
    if fits(6 * B * H * S * S):   # the mask, and SDPA's scores beside it
        q, k, v, _, mask, bias = inputs(B, H, Hkv, S, D, kind)
        ok = visible(mask, S, causal, window)
        lib_mask = bias.masked_fill(~ok, float("-inf")).to(torch.bfloat16)
        res["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=lib_mask, scale=D ** -0.5, enable_gqa=True),
            iters=5, replays=5)
        del q, k, v, mask, bias, ok, lib_mask
    torch.cuda.empty_cache()
    lib = "does not fit" if res["library_ms"] is None \
        else f"{res['library_ms']:.4f}"
    log(f"phase 16: the biased forward at {(B, H, Hkv, S, D)} causal {causal} "
        f"window {window} bias {kind}: device ms per call (CUDA graph) "
        f"{res['ms']:.4f}, library {lib}")
    return res


def phase16() -> dict:
    """The biased kernels against their plain versions at every shape of
    FLASH_BIAS_SHAPES, their times at bloom_560m's shape, and a learned
    (1, H) bias through flash_attention's autograd: the dbias kernel's
    launch beside the other three."""
    import torch
    from pasero_torch.ops import flash_attention as fa
    from pasero_torch.scripts.bench_flash_bwd import time_case
    cuda_tests = load_test_module("test_torch_cuda")
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "dbias": 0.0}
    for case in FLASH_BIAS_SHAPES:
        for key, err in flash_bias_check(case, cuda_tests).items():
            errs[key] = max(errs[key], err)
    res = flash_bias_timing(cuda_tests)
    # the biased and bias-free kernels at 16500 keys
    shape, causal, _, _, kind = FLASH_BIAS_SHAPES[-1]
    long = res["at_16500"] = time_case(shape, causal, kind)
    log(f"phase 16: at {tuple(shape)} bf16 causal with ALiBi, device ms per "
        f"call (CUDA graph): the biased forward {long[kind]['fwd']:.4f}, dq "
        f"{long[kind]['dq']:.4f} + dk/dv {long[kind]['dkv']:.4f}; the "
        f"bias-free forward {long['none']['fwd']:.4f}, dq "
        f"{long['none']['dq']:.4f} + dk/dv {long['none']['dkv']:.4f}")
    # the biased forward at the other shapes, 16500 keys among them, beside
    # the library's
    res["fwd_by_shape"] = [bias_fwd_timing(case)
                           for case in FLASH_BIAS_SHAPES[1:]]
    for key in errs:
        res[key]["max_abs_err"] = errs[key]
    (B, H, Hkv, S, D), causal, *_ = FLASH_BIAS_SHAPES[0]
    q, k, v, do, mask = cuda_tests.flash_inputs(B, H, Hkv, S, D, False)
    bias = cuda_tests.flash_bias("learned_1xH", B, H, S, mask)
    bias.requires_grad_()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.reset_launch_counts()
    fa.flash_attention(*leaves, mask=mask[:, None, None, :], bias=bias,
                    scale=D ** -0.5, causal=causal).backward(do)
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    want = {name: int(name.endswith("bias")) for name in counts}
    check(counts == want, f"a learned bias through flash_attention launched "
          f"{counts}, not {want}")
    check(bias.grad is not None and bool(torch.isfinite(bias.grad).all()),
          "the learned bias has no finite gradient")
    log(f"phase 16: a learned (1, {H}) bias at {(B, H, Hkv, S, D)} through "
        f"flash_attention forward + backward: launches {counts}")
    res["learned_bias_launches"] = counts
    del q, k, v, do, bias, leaves
    torch.cuda.empty_cache()
    return res


# -- phase 17 ------------------------------------------------------------------

ALIBI = os.path.join(TESTDATA, "alibi-mini")
ALIBI_CONFIG = os.path.join(TESTDATA, "alibi_mini.yaml")
ALIBI_TRAIN_GOLDEN = os.path.join(TESTDATA, "alibi_mini_train20.jax.json")


def flash_counts(want: dict, f32: bool = False) -> dict:
    """``want`` (launches by bf16 kernel name, fused-CE counts beside) with
    every flash kernel of ``launch_counts`` present: those ``want`` does not
    name at 0; with ``f32`` the flash counts moved to the float32 names and
    every bf16 flash kernel at 0."""
    from pasero_torch.ops.flash_attention import launch_counts
    out = {name: 0 for name in launch_counts()}
    for name, n in want.items():
        out[name + "_f32" if f32 and name.startswith("flash_") else name] = n
    return out


def alibi_train_counts(layers: int, micro: int, valid: int,
                       f32: bool = False) -> dict:
    """The launches of ALiBi training: the biased flash kernels per layer and
    batch, no dbias (the bias is a constant), no bias-free or T5 kernel;
    with ``f32`` their float32 instances, and no bf16 flash kernel."""
    return flash_counts({"flash_fwd_bias": layers * (micro + valid),
                         "flash_bwd_dq_bias": layers * micro,
                         "flash_bwd_dkv_bias": layers * micro,
                         "fused_ce_fwd": micro + valid,
                         "fused_ce_bwd": micro}, f32)


def phase17() -> dict:
    """ALiBi through the entry points: the alibi-mini anchor's greedy and
    speculative decodes against the JAX golden, the training CLI on
    alibi_mini.yaml against the JAX losses with exact launch counts, and
    bloom_560m at full width: Trainer.train_step at 4 x 2048 and
    TextGenerator.decode of 8 prompts of up to 128 tokens."""
    import shutil
    import torch
    from pasero_torch.decoding.generator import TextGenerator
    from pasero_torch.ops import flash_attention as fa
    from pasero_torch.ops.cache_update import cache_slot_write_
    from pasero_torch.ops.fused_ce import fused_ce_bwd, fused_ce_fwd
    from pasero_torch.scripts.bench_decode import BloomWorkload
    from pasero_torch.scripts.bench_train import Workload
    res = {}
    # a. the anchor
    prompts = lm_prompts()
    fa.reset_launch_counts()
    gen = TextGenerator.build(ALIBI, max_output_len=24)
    check(gen.device.type == "cuda", f"generator runs on {gen.device}")
    greedy = gen.decode(prompts)
    golden = golden_lines("alibi_mini_greedy.jax.txt")
    same = sum(h == g for h, g in zip(greedy, golden))
    spec = TextGenerator.build(ALIBI, max_output_len=24, speculative=True,
                               speculative_draft_len=8).decode(prompts)
    same_spec = sum(h == g for h, g in zip(spec, greedy))
    log(f"phase 17: alibi-mini bf16 greedy: {same}/{len(golden)} lines "
        f"identical to the JAX output; speculative (drafts of 8) "
        f"{same_spec}/32 identical to greedy; flash launches "
        f"{fa.launch_counts()} (decoding takes the plain attention)")
    check(same >= MIN_LM_MATCH, f"alibi-mini greedy: only {same}/32 match")
    check(same_spec == len(prompts), "alibi-mini speculative differs from "
          "greedy")
    check(not any(fa.launch_counts().values()), "decoding launched flash kernels")
    res["anchor"] = {"greedy_match": same, "speculative_match": same_spec}

    # b. the training CLI
    cli = load_test_module("test_torch_train_cli")
    model_dir = os.path.join(ROOT, "build", "smoke-alibi")
    shutil.rmtree(model_dir, ignore_errors=True)
    os.makedirs(model_dir)
    ckpt = os.path.join(ROOT, "build", "smoke-alibi-init.npz")
    cli.write_initial_weights(ckpt, ALIBI_CONFIG)
    cmd = [sys.executable, "-m", "pasero_torch.cli.train",
           *cli.train_flags(model_dir, ckpt, ALIBI_CONFIG),
           "--valid-interval", "10", "--save-interval", "10"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    elapsed = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    check(proc.returncode == 0, f"cli.train (ALiBi) failed:\n{out[-4000:]}")
    logs = cli.parse_log(out)
    with open(ALIBI_TRAIN_GOLDEN) as f:
        golden = json.load(f)["steps"]
    check([l["step"] for l in logs] == [g["step"] for g in golden],
          f"logged steps {[l['step'] for l in logs]}")
    worst = 0.0
    for got, want in zip(logs, golden):
        rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        worst = max(worst, rel)
        check(rel <= TRAIN_RTOL, f"ALiBi step {got['step']}: loss "
              f"{got['loss']} vs JAX {want['loss']}")
    counts = parse_launches(out)
    micro, valid = counts["train micro-batches"], counts["valid batches"]
    with open(os.path.join(model_dir, "config.json")) as f:
        layers = json.load(f)["decoder_layers"]
    check(micro == 20 and valid > 0, f"{micro} micro-batches, {valid} "
          "validation batches")
    want = alibi_train_counts(layers, micro, valid)
    got = {key: counts[key] for key in want}
    check(got == want, f"ALiBi CLI launches {got} != {want}")
    log(f"phase 17: python -m pasero_torch.cli.train on alibi_mini.yaml, 20 "
        f"steps in {elapsed:.1f} s: losses {logs[0]['loss']:.3f} -> "
        f"{logs[-1]['loss']:.3f}, all within {worst:.4%} of the JAX training "
        f"CLI's; launches {got} for {micro} micro-batches and {valid} "
        f"validation batches through {layers} layers")
    res["cli"] = {"launches": got, "worst_loss_rel": worst}

    # c. bloom_560m at full width: training, then decoding
    work = Workload("bloom_560m")
    work.run(2)                                            # warm-up
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    fused_ce_fwd.launches = fused_ce_bwd.launches = 0
    steps = 5
    logs, seconds = work.run(steps)
    counts = {**fa.launch_counts(), "fused_ce_fwd": fused_ce_fwd.launches,
              "fused_ce_bwd": fused_ce_bwd.launches}
    peak = torch.cuda.max_memory_allocated()
    losses = [l["loss"] for l in logs]
    check(all(map(math.isfinite, losses)), f"non-finite losses {losses}")
    want = alibi_train_counts(work.layers, steps, 0)
    check(counts == want, f"bloom_560m launches {counts} != {want} for "
          f"{steps} steps through {work.layers} layers")
    train = {"ms_per_step": seconds * 1e3 / steps,
             "tok_per_s": work.tokens_per_step * steps / seconds,
             "peak_mib": peak / 2 ** 20, "losses": losses,
             "launches": counts}
    log(f"phase 17: bloom_560m V=250880 B=4 T=2048 bf16 training with flash "
        f"attention and the ALiBi bias: {train['tok_per_s']:.1f} tok/s, "
        f"{train['ms_per_step']:.3f} ms per step, peak memory "
        f"{train['peak_mib']:.1f} MiB, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, launches {counts} for {steps} steps x "
        f"{work.layers} layers")
    del work
    torch.cuda.empty_cache()

    work = BloomWorkload()
    work.run()                                             # warm-up
    fa.reset_launch_counts()
    cache_slot_write_.launches = 0
    work.model.single_token_calls = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = work.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    layers = work.cfg.decoder_layers
    singles = work.model.single_token_calls
    check(singles > 0 and cache_slot_write_.launches == layers * singles,
          f"{cache_slot_write_.launches} slot writes for {singles} "
          f"single-token calls through {layers} layers")
    check(not any(fa.launch_counts().values()), "decoding launched flash kernels")
    tokens = work.output_tokens(out)
    lengths = [len(work.generator.task.preprocess(
        work.generator.task.input_to_sample(p, work.generator.task.make_meta())
    )["decoder_input"]) for p in work.inputs]
    decode = {"ms_per_decoder_call": seconds * 1e3 / out["model_calls"],
              "tok_per_s": tokens / seconds, "seconds": seconds,
              "decoder_calls": out["model_calls"], "output_tokens": tokens,
              "prompt_tokens": lengths,
              "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
              "cache_slot_write": cache_slot_write_.launches}
    log(f"phase 17: bloom_560m TextGenerator.decode of {len(work.inputs)} "
        f"prompts of {min(lengths)}-{max(lengths)} tokens, greedy: "
        f"{tokens} tokens in {out['model_calls']} decoder calls, "
        f"{decode['ms_per_decoder_call']:.3f} ms per call, "
        f"{decode['tok_per_s']:.1f} tok/s, peak {decode['peak_mib']:.1f} "
        f"MiB; cache_slot_write {cache_slot_write_.launches} = {layers} "
        f"layers x {singles} single-token calls")
    del work
    torch.cuda.empty_cache()
    res["train"], res["decode"] = train, decode
    return res


# -- phase 18 ------------------------------------------------------------------

FLASH_T5_SHAPES = [  # (B, H, Hkv, S, D), causal, window, padded, bidirectional
    ((32, 12, 12, 512, 64), False, None, True, True),   # t5_base's encoder
    ((32, 12, 12, 128, 64), True, None, False, False),  # t5_base's decoder
    ((2, 16, 4, 777, 128), True, 256, True, True),      # GQA 4, a window
    ((3, 4, 2, 333, 64), False, None, True, False),     # unaligned
    ((1, 1, 1, 32768, 64), False, None, False, True),   # 32768 keys
    ((2, 8, 4, 1500, 32), False, None, True, True),     # D 32, far tiles
]
T5_TIMED = ((32, 12, 12, 512, 64), (1, 12, 12, 32768, 64))  # bidirectional
T5_DECODER = (32, 12, 12, 128, 64)   # t5_base's decoder, causal
# device ms per call of the T5 kernels that flash_bwd.cu's replaced
# (flash_attention.cu's mma.sync kernels) at T5_TIMED's shapes (PERF.md,
# "NVIDIA H100 80GB HBM3, 700.00 W"): gates where the library call does not
# fit, not readings of this run
T5_BWD_EARLIER_MS = {T5_TIMED[0]: {"dq": 0.4265, "dkv": 0.4693},
                     T5_TIMED[1]: {"dq": 41.7062, "dkv": 55.8098}}
T5_FWD_EARLIER_MS = {T5_TIMED[1]: 23.4549}
# device ms per call of the T5 dq kernel plus the separate mma.sync demb
# kernel that the dq kernel's own demb replaced, at T5_TIMED's shapes
# (PERF.md, "NVIDIA H100 80GB HBM3, 700.00 W"): gates, not readings of
# this run
T5_DQ_DEMB_EARLIER_MS = {T5_TIMED[0]: 0.1467 + 0.6203,
                         T5_TIMED[1]: 11.18 + 74.79}
LONG = (1, 32, 32, 32768, 128)   # JAX's streamed regime, bias-free, causal


def flash_t5_check(case, cuda_tests) -> dict:
    """The four T5 kernels against the plain version at one shape, by
    ``flash_t5_compare`` of tests/test_torch_cuda.py: lse within 1e-4, out,
    dq, dk, dv and demb within their limits, every mutation outside them.
    Returns the max abs errors."""
    import torch
    r = cuda_tests.flash_t5_compare(*case)
    shape, causal, window, padded, bidirectional = case
    where = (f"{shape} causal {causal} window {window} padded {padded} "
             f"bidirectional {bidirectional}")
    check(r["lse_err"] <= 1e-4,
          f"flash_fwd_t5 lse differs at {where} by {r['lse_err']}")
    check(max(r["excess"]) <= 1.0, f"T5 flash kernels differ at {where}: "
          f"out, dq, dk, dv, demb at {r['excess']} of their limits")
    check(min(r["mutants"].values()) > 1.0, f"the T5 flash check at {where} "
          f"passes a mutation: {r['mutants']}")
    check(r["same_bits"], f"two T5 backward calls at {where} gave other bits")
    errs = r["max_abs_err"]
    log(f"phase 18: T5 flash kernels == plain at {where}: out, dq, dk, dv, "
        f"demb at {', '.join(f'{e:.3f}' for e in r['excess'])} of their "
        f"limits; mutations at "
        f"{json.dumps({k: round(v, 1) for k, v in r['mutants'].items()})} "
        f"of them; dq, dk, dv the same bits twice; max abs err lse {r['lse_err']:.3e} out {errs['fwd']:.3e} "
        f"dq {errs['dq']:.3e} dk/dv {errs['dkv']:.3e} demb "
        f"{errs['demb']:.3e}")
    torch.cuda.empty_cache()
    return errs


def fits(nbytes: float) -> bool:
    """Whether ``nbytes`` more fit in 90 % of the card's free memory."""
    import torch
    torch.cuda.empty_cache()
    return nbytes < 0.9 * torch.cuda.mem_get_info()[0]


def flash_t5_timing(shape, cuda_tests) -> dict:
    """At a bidirectional T5 shape (no padding): device ms per call of each
    T5 kernel (CUDA graph; the forward, dq and dk/dv, and the bias-free ones
    beside, by bench_flash_bwd's time_case), the plain version's ms, the
    bounds (the larger of the products over the bf16 rate and the bytes
    over the memory rate; the table and the distance index count as read
    once), and the library yardstick: F.scaled_dot_product_attention with
    the materialized bias as a bf16 float attn_mask, its backward, and for
    demb its backward with the mask's gradient followed by index_add_ of
    that gradient by bucket. demb is the T5 dq kernel's instance that also
    sums the table's gradient: its "ms" is that kernel's, read in turn with
    the same kernel without demb ("dq_ms"); its bound is the dq's three
    products and bytes, the partial rows' bytes and one float32 add of each
    visible dS (at FP32_ADDS); its plain version the plain backward and
    demb; "adds_ms" (the difference) is what demb adds to the dq kernel,
    beside its own bound "adds_bound_ms" (the adds and the partial rows'
    bytes). The fused kernel below the dq and demb kernels it replaced
    (T5_DQ_DEMB_EARLIER_MS). The plain version and the yardstick need (Sq,
    Sk) tensors: "does not fit" where they do not. The forward and the
    backward at most their library call, or where it does not fit the
    kernels they replaced (T5_FWD_EARLIER_MS, T5_BWD_EARLIER_MS). Also the
    peak memory of forward + backward through flash_attention's autograd,
    beside the bytes of a float32 bias."""
    import torch
    import torch.nn.functional as F
    from pasero_torch.ops.flash_attention import (T5Bias, flash_attention,
                                                  flash_bwd_dq,
                                                  flash_bwd_plain,
                                                  flash_demb_plain, flash_fwd,
                                                  flash_fwd_plain, visible)
    from pasero_torch.scripts.bench_flash_bwd import time_case, time_demb
    B, H, Hkv, S, D = shape
    q, k, v, do, mask = cuda_tests.flash_inputs(B, H, Hkv, S, D, False)
    t5 = T5Bias(cuda_tests.t5_table(H), True)
    args = (D ** -0.5, False, None)
    out, lse = flash_fwd(q, k, v, mask, *args, t5)
    _, delta = flash_bwd_dq(q, k, v, mask, out, lse, do, *args, t5)
    pairs = float(visible(mask, S, False, None).expand(B, 1, S, S).sum()) * H
    product = 2.0 * pairs * D
    q_bytes, kv_bytes, row_bytes = B * H * S * D * 2, B * Hkv * S * D * 2, \
        B * H * S * 4
    t5_bytes = 4 * (2 * S - 1) + 4 * 32 * H
    partial_bytes = 4 * B * H * -(-S // 64) * t5.num_buckets

    def bound(products, nbytes, adds=0.0):
        ops, mem = max(products * product / BF16_FLOPS, adds / FP32_ADDS), \
            (nbytes + t5_bytes) / HBM_BYTES_PER_S
        return {"bound_ms": max(ops, mem) * 1e3,
                "ops_bound_ms": ops * 1e3, "bytes_bound_ms": mem * 1e3,
                "bound_by": "operations" if ops >= mem else "bytes"}

    res = {"shape": list(shape),
           "fwd": bound(2, 2 * q_bytes + 2 * kv_bytes + row_bytes),
           "bwd": bound(5, 4 * q_bytes + 4 * kv_bytes + row_bytes),
           "dq": bound(3, 4 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
           "dkv": bound(4, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
           "demb": bound(3, 4 * q_bytes + 2 * kv_bytes + 2 * row_bytes +
                         partial_bytes, pairs)}
    long = S > 4096
    fused = time_demb(shape)
    res["demb"].update(ms=fused["fused_ms"], dq_ms=fused["dq_ms"],
                       adds_ms=fused["fused_ms"] - fused["dq_ms"],
                       adds_bound_ms=max(pairs / FP32_ADDS, partial_bytes /
                                         HBM_BYTES_PER_S) * 1e3)
    earlier = T5_DQ_DEMB_EARLIER_MS[tuple(shape)]
    check(fused["fused_ms"] < earlier, f"the T5 dq kernel with demb takes "
          f"{fused['fused_ms']:.4f} ms at {shape}, not below the "
          f"{earlier:.4f} of the dq and demb kernels it replaced")
    log(f"phase 18: at {shape} the T5 dq kernel with demb "
        f"{fused['fused_ms']:.4f} ms, without it {fused['dq_ms']:.4f} (read "
        f"in turn, so demb adds {res['demb']['adds_ms']:.4f}, bound "
        f"{res['demb']['adds_bound_ms']:.4f}); the dq and demb kernels it "
        f"replaced {earlier:.4f}")
    timed = time_case(shape, False, "t5")
    for key in ("fwd", "dq", "dkv"):
        res[key]["ms"] = timed["t5"][key]
    res["bwd"]["ms"] = res["dq"]["ms"] + res["dkv"]["ms"]
    res["bias_free"] = timed["none"]
    scores = 4.0 * B * H * S * S          # one float32 (Sq, Sk) tensor
    plain = fits(8 * scores)
    nofit = "does not fit"
    for key, fn in (("fwd", lambda: flash_fwd_plain(q, k, v, mask, *args,
                                                    t5)),
                    ("bwd", lambda: flash_bwd_plain(q, k, v, mask, out, lse,
                                                    do, *args, t5)),
                    ("demb", lambda: (flash_bwd_plain(q, k, v, mask, out,
                                                      lse, do, *args, t5),
                                      flash_demb_plain(q, k, v, mask, out,
                                                       lse, do, *args, t5)))):
        res[key]["plain_ms"] = time_ms(fn, 3, 1) if plain else nofit
    # the library yardstick; the port never calls it
    bias_bytes = 2.0 * H * S * S
    lib_mask = None
    if fits(4 * bias_bytes + scores / B):
        lib_mask = t5.materialize(S, S).to(torch.bfloat16)
        lib = library_times(lambda *x: F.scaled_dot_product_attention(
            *x, attn_mask=lib_mask, scale=args[0]), (q, k, v), do,
            2 if long else 10, 2 if long else 10)
        for key in ("fwd", "bwd"):
            res[key]["library_ms"] = lib[key]
            res[key]["library_host_ms"] = lib[f"{key}_host"]
    else:
        for key in ("fwd", "bwd"):
            res[key]["library_ms"] = res[key]["library_host_ms"] = nofit
    if lib_mask is not None and fits(6 * bias_bytes + scores / B):
        buckets = t5.buckets(S, S).reshape(-1)

        def by_bucket(grads):   # the mask's gradient summed by bucket
            demb = torch.zeros(H, 32, device=q.device)
            return demb.index_add_(1, buckets, grads[-1].float().sum(
                0).reshape(H, S * S))
        lib = library_times(lambda *x: F.scaled_dot_product_attention(
            *x[:3], attn_mask=x[3], scale=args[0]), (q, k, v, lib_mask), do,
            2 if long else 5, 2 if long else 5, grad_of=by_bucket)
        res["demb"]["library_ms"] = lib["bwd"]
        res["demb"]["library_host_ms"] = lib["bwd_host"]
        del buckets
    else:
        res["demb"]["library_ms"] = res["demb"]["library_host_ms"] = nofit
    del lib_mask
    res["dq"]["plain_ms"] = res["dkv"]["plain_ms"] = res["bwd"]["plain_ms"]
    for key in ("dq", "dkv"):
        res[key]["library_ms"] = res["bwd"]["library_ms"]
        res[key]["library_host_ms"] = res["bwd"]["library_host_ms"]
    earlier = T5_BWD_EARLIER_MS[tuple(shape)]
    log(f"phase 18: at {shape} the T5 forward {res['fwd']['ms']:.4f} ms, "
        f"backward dq {res['dq']['ms']:.4f} + dk/dv {res['dkv']['ms']:.4f} "
        f"ms; the bias-free forward {res['bias_free']['fwd']:.4f}, dq "
        f"{res['bias_free']['dq']:.4f} + dk/dv {res['bias_free']['dkv']:.4f} "
        f"at the same shape")
    for key, gate in (("fwd", T5_FWD_EARLIER_MS.get(tuple(shape))),
                      ("bwd", earlier["dq"] + earlier["dkv"])):
        most = res[key]["library_ms"]
        if isinstance(most, str):   # the library call does not fit
            most = gate
        check(res[key]["ms"] <= most, f"the T5 {key} takes "
              f"{res[key]['ms']:.4f} ms at {shape}, more than {most:.4f}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    table = t5.table.clone().requires_grad_()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_attention(*leaves, scale=args[0],
                    t5_bias=T5Bias(table, True)).backward(do)
    torch.cuda.synchronize()
    res["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    res["bias_mib"] = scores / 2 ** 20
    check(table.grad is not None and bool(torch.isfinite(table.grad).all()),
          f"no finite table gradient at {shape}")
    del leaves, table

    def show(x):
        return x if isinstance(x, str) else f"{x:.4f}"
    for key in ("fwd", "dq", "dkv", "bwd", "demb"):
        r = res[key]
        log(f"phase 18: at {shape} bf16 bidirectional with the T5 table, "
            f"{key}: device ms per call (CUDA graph) {r['ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}: operations "
            f"{r['ops_bound_ms']:.4f}, bytes {r['bytes_bound_ms']:.4f}), "
            f"plain {show(r['plain_ms'])}, library {show(r['library_ms'])} "
            f"(eager {show(r['library_host_ms'])})")
    log(f"phase 18: at {shape} forward + backward through flash_attention: "
        f"peak {res['peak_mib']:.1f} MiB above the inputs; a float32 bias "
        f"would take {res['bias_mib']:.1f} MiB")
    torch.cuda.empty_cache()
    return res


def t5_decoder_timing() -> dict:
    """The T5 forward at t5_base's decoder shape (causal, a unidirectional
    table): device ms per call (bench_flash_bwd's time_case) beside the
    library yardstick's (SDPA with the materialized bias and the causal mask
    as one bf16 float attn_mask; the port never calls it) and the bound."""
    import torch
    import torch.nn.functional as F
    from pasero_torch.scripts.bench_flash_bwd import inputs, time_case
    B, H, Hkv, S, D = T5_DECODER
    q, k, v, _, _, t5 = inputs(B, H, Hkv, S, D, "t5_causal")
    future = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    lib_mask = t5.materialize(S, S).masked_fill(future, float("-inf")).to(
        torch.bfloat16)
    timed = time_case(T5_DECODER, True, "t5_causal")
    ops = 2 * 2.0 * B * H * S * (S + 1) / 2 * D / BF16_FLOPS
    mem = (2 * B * H * S * D * 2 + 2 * B * Hkv * S * D * 2 + B * H * S * 4) \
        / HBM_BYTES_PER_S
    res = {"shape": list(T5_DECODER), "ms": timed["t5_causal"]["fwd"],
           "bias_free_ms": timed["none"]["fwd"],
           "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=lib_mask, scale=D ** -0.5), 10, 5),
           "bound_ms": max(ops, mem) * 1e3,
           "bound_by": "operations" if ops >= mem else "bytes"}
    log(f"phase 18: the T5 forward at t5_base's decoder shape {T5_DECODER} "
        f"causal: device ms per call (CUDA graph) {res['ms']:.4f}, bound "
        f"{res['bound_ms']:.4f} ({res['bound_by']}), library "
        f"{res['library_ms']:.4f}, the bias-free forward "
        f"{res['bias_free_ms']:.4f}")
    del q, k, v, lib_mask
    torch.cuda.empty_cache()
    return res


def long_context(cuda_tests) -> dict:
    """The bias-free kernels at JAX's streamed lengths: against the plain
    version on one head at 32768 keys (heads are independent), then at
    LONG's 32 heads their device ms per call (CUDA graph) and the peak
    memory of forward + backward through flash_attention."""
    import torch
    from pasero_torch.ops.flash_attention import (flash_attention,
                                                  flash_bwd_dkv, flash_bwd_dq,
                                                  flash_fwd)
    B, H, Hkv, S, D = LONG
    flash_check((B, 1, 1, S, D), True, None, False, cuda_tests)
    torch.cuda.empty_cache()
    q, k, v, do, mask = cuda_tests.flash_inputs(B, H, Hkv, S, D, False)
    args = (D ** -0.5, True, None)
    out, lse = flash_fwd(q, k, v, mask, *args)
    _, delta = flash_bwd_dq(q, k, v, mask, out, lse, do, *args)
    res = {"shape": list(LONG)}
    del out, lse, delta
    res["same_bits"] = cuda_tests.flash_same_bits(LONG, True, None, False)
    check(res["same_bits"], f"two backward calls at {LONG} gave other bits")
    out, lse = flash_fwd(q, k, v, mask, *args)
    _, delta = flash_bwd_dq(q, k, v, mask, out, lse, do, *args)
    for key, fn in (("fwd", lambda: flash_fwd(q, k, v, mask, *args)),
                    ("dq", lambda: flash_bwd_dq(q, k, v, mask, out, lse, do,
                                                *args)),
                    ("dkv", lambda: flash_bwd_dkv(q, k, v, mask, do, lse,
                                                  delta, *args))):
        res[f"{key}_ms"] = device_ms(fn, iters=2, replays=2)
    check(res["fwd_ms"] <= LONG_FWD_MAX_MS, f"the bias-free forward takes "
          f"{res['fwd_ms']:.4f} ms at {LONG}, more than {LONG_FWD_MAX_MS}")
    check(res["dq_ms"] + res["dkv_ms"] <= LONG_BWD_MAX_MS, f"the bias-free "
          f"backward takes {res['dq_ms'] + res['dkv_ms']:.4f} ms at {LONG}, "
          f"more than {LONG_BWD_MAX_MS}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_attention(*leaves, scale=args[0], causal=True).backward(do)
    torch.cuda.synchronize()
    res["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    res["scores_mib"] = 4.0 * B * H * S * S / 2 ** 20
    log(f"phase 18: bias-free flash kernels at {LONG} causal: device ms "
        f"forward {res['fwd_ms']:.4f}, dq {res['dq_ms']:.4f}, dk/dv "
        f"{res['dkv_ms']:.4f}; dq, dk, dv the same bits from two calls: "
        f"{res['same_bits']}; forward + backward peak {res['peak_mib']:.1f} "
        f"MiB above the inputs (float32 scores would take "
        f"{res['scores_mib']:.1f} MiB)")
    del q, k, v, do, out, leaves
    torch.cuda.empty_cache()
    return res


def phase18() -> dict:
    """The T5 kernels against their plain versions at every shape of
    FLASH_T5_SHAPES, their times at t5_base's encoder shape and at 32768
    keys, and the bias-free kernels at JAX's streamed lengths."""
    cuda_tests = load_test_module("test_torch_cuda")
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "demb": 0.0}
    for case in FLASH_T5_SHAPES:
        for key, err in flash_t5_check(case, cuda_tests).items():
            errs[key] = max(errs[key], err)
    res = flash_t5_timing(T5_TIMED[0], cuda_tests)
    res["at_32768"] = flash_t5_timing(T5_TIMED[1], cuda_tests)
    res["decoder"] = t5_decoder_timing()
    for key in errs:
        res[key]["max_abs_err"] = errs[key]
    res["long"] = long_context(cuda_tests)
    return res


# -- phase 19 ------------------------------------------------------------------

T5 = os.path.join(TESTDATA, "t5-mini")
T5_CONFIG = os.path.join(TESTDATA, "t5_mini.yaml")
T5_TRAIN_GOLDEN = os.path.join(TESTDATA, "t5_mini_train20.jax.json")


def t5_train_counts(enc_layers: int, dec_layers: int, micro: int,
                    valid: int, f32: bool = False) -> dict:
    """The launches of T5 training: the T5 kernels in every self-attention
    (the dq kernel's instance that sums each table's gradient,
    flash_bwd_dq_t5_demb, and no separate demb kernel), the bias-free
    kernels in every cross-attention, no dbias, no dense-bias kernel; with
    ``f32`` their float32 instances, and no bf16 flash kernel."""
    layers = enc_layers + dec_layers
    return flash_counts({"flash_fwd": dec_layers * (micro + valid),
                         "flash_bwd_dq": dec_layers * micro,
                         "flash_bwd_dkv": dec_layers * micro,
                         "flash_fwd_t5": layers * (micro + valid),
                         "flash_bwd_dq_t5": layers * micro,
                         "flash_bwd_dkv_t5": layers * micro,
                         "flash_bwd_dq_t5_demb": layers * micro,
                         "flash_bwd_demb": 0,
                         "fused_ce_fwd": micro + valid,
                         "fused_ce_bwd": micro}, f32)


def count_encoder_calls(model) -> list:
    """A one-element list counting the encoder's forward calls."""
    calls = [0]

    def count(*_):
        calls[0] += 1
    model.encoder.register_forward_pre_hook(count)
    return calls


def phase19() -> dict:
    """T5 through the entry points: the t5-mini anchor's greedy and beam-5
    decodes of test.de against the JAX goldens, the training CLI on
    t5_mini.yaml against the JAX losses with exact launch counts, and
    t5_base at full width: Trainer.train_step at 32 x 512 + 128 and
    TextGenerator.decode of 8 sources of 512 tokens."""
    import shutil
    import torch
    from pasero_torch.decoding.generator import TextGenerator
    from pasero_torch.ops import flash_attention as fa
    from pasero_torch.ops.cache_update import cache_slot_write_
    from pasero_torch.ops.fused_ce import fused_ce_bwd, fused_ce_fwd
    from pasero_torch.scripts.bench_decode import T5Workload
    from pasero_torch.scripts.bench_train import Workload
    res = {}
    # a. the anchor
    with open(os.path.join(ROOT, "examples", "deen-mini", "data",
                           "test.de")) as f:
        sources = [line.strip() for line in f]
    for beam, name in ((1, "greedy"), (5, "beam5")):
        fa.reset_launch_counts()
        gen = TextGenerator.build(T5, beam_size=beam)
        check(gen.device.type == "cuda", f"generator runs on {gen.device}")
        calls = count_encoder_calls(gen.model)
        hyps = gen.decode(sources)
        torch.cuda.synchronize()
        golden = golden_lines(f"t5_mini_{name}.jax.txt")
        same = sum(h == g for h, g in zip(hyps, golden))
        counts = fa.launch_counts()
        want = {n: 0 for n in counts}
        want["flash_fwd_t5"] = gen.model_cfg.encoder_layers * calls[0]
        log(f"phase 19: t5-mini bf16 {name}: {same}/{len(golden)} lines "
            f"identical to the JAX output; {calls[0]} encoder call(s), "
            f"flash launches {counts}")
        check(len(hyps) == len(golden) and same >= MIN_GOLDEN_MATCH,
              f"t5-mini {name}: only {same}/{len(golden)} match")
        check(counts == want, f"t5-mini {name} launched {counts}, not {want}")
        res[f"anchor_{name}"] = {"match": same, "launches": counts}

    # b. the training CLI
    cli = load_test_module("test_torch_train_cli")
    model_dir = os.path.join(ROOT, "build", "smoke-t5")
    shutil.rmtree(model_dir, ignore_errors=True)
    os.makedirs(model_dir)
    ckpt = os.path.join(ROOT, "build", "smoke-t5-init.npz")
    cli.write_initial_weights(ckpt, T5_CONFIG)
    cmd = [sys.executable, "-m", "pasero_torch.cli.train",
           *cli.train_flags(model_dir, ckpt, T5_CONFIG)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    elapsed = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    check(proc.returncode == 0, f"cli.train (T5) failed:\n{out[-4000:]}")
    logs = cli.parse_log(out)
    with open(T5_TRAIN_GOLDEN) as f:
        golden = json.load(f)["steps"]
    check([l["step"] for l in logs] == [g["step"] for g in golden],
          f"logged steps {[l['step'] for l in logs]}")
    worst = 0.0
    for got, want in zip(logs, golden):
        rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        worst = max(worst, rel)
        check(rel <= TRAIN_RTOL, f"T5 step {got['step']}: loss "
              f"{got['loss']} vs JAX {want['loss']}")
    counts = parse_launches(out)
    micro, valid = counts["train micro-batches"], counts["valid batches"]
    with open(os.path.join(model_dir, "config.json")) as f:
        config = json.load(f)
    check(micro == 20 and valid > 0, f"{micro} micro-batches, {valid} "
          "validation batches")
    want = t5_train_counts(config["encoder_layers"],
                           config["decoder_layers"], micro, valid)
    got = {key: counts[key] for key in want}
    check(got == want, f"T5 CLI launches {got} != {want}")
    log(f"phase 19: python -m pasero_torch.cli.train on t5_mini.yaml, 20 "
        f"steps in {elapsed:.1f} s: losses {logs[0]['loss']:.3f} -> "
        f"{logs[-1]['loss']:.3f}, all within {worst:.4%} of the JAX training "
        f"CLI's; launches {got} for {micro} micro-batches and {valid} "
        f"validation batches")
    res["cli"] = {"launches": got, "worst_loss_rel": worst}

    # c. t5_base at full width: training, then decoding
    work = Workload("t5_base")
    work.run(2)                                            # warm-up
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    fused_ce_fwd.launches = fused_ce_bwd.launches = 0
    steps = 5
    logs, seconds = work.run(steps)
    counts = {**fa.launch_counts(), "fused_ce_fwd": fused_ce_fwd.launches,
              "fused_ce_bwd": fused_ce_bwd.launches}
    peak = torch.cuda.max_memory_allocated()
    losses = [l["loss"] for l in logs]
    check(all(map(math.isfinite, losses)), f"non-finite losses {losses}")
    cfg = work.model_cfg
    want = t5_train_counts(cfg.encoder_layers, cfg.decoder_layers, steps, 0)
    check(counts == want, f"t5_base launches {counts} != {want} for {steps} "
          "steps")
    train = {"ms_per_step": seconds * 1e3 / steps,
             "tok_per_s": work.tokens_per_step * steps / seconds,
             "peak_mib": peak / 2 ** 20, "losses": losses,
             "launches": counts}
    log(f"phase 19: t5_base V=32128 B=32 S=512 T=128 bf16 training with "
        f"flash attention and the T5 tables: {train['tok_per_s']:.1f} target "
        f"tok/s, {train['ms_per_step']:.3f} ms per step, peak memory "
        f"{train['peak_mib']:.1f} MiB, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, launches {counts} for {steps} steps")
    del work
    torch.cuda.empty_cache()

    work = T5Workload()
    work.run()                                             # warm-up
    calls = count_encoder_calls(work.model)
    fa.reset_launch_counts()
    cache_slot_write_.launches = 0
    work.model.single_token_calls = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = work.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    layers = work.cfg.decoder_layers
    singles = work.model.single_token_calls
    counts = fa.launch_counts()
    want = {n: 0 for n in counts}
    want["flash_fwd_t5"] = work.cfg.encoder_layers * calls[0]
    check(counts == want, f"t5_base decode launched {counts}, not {want}")
    check(singles > 0 and cache_slot_write_.launches == layers * singles,
          f"{cache_slot_write_.launches} slot writes for {singles} "
          f"single-token calls through {layers} layers")
    tokens = work.output_tokens(out)
    lengths = [len(work.generator.task.preprocess(
        work.generator.task.input_to_sample(s, work.generator.task.make_meta())
    )["encoder_input"]) for s in work.inputs]
    decode = {"ms_per_decoder_call": seconds * 1e3 / out["model_calls"],
              "tok_per_s": tokens / seconds, "seconds": seconds,
              "decoder_calls": out["model_calls"], "output_tokens": tokens,
              "source_tokens": lengths,
              "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
              "flash_fwd_t5": counts["flash_fwd_t5"],
              "encoder_calls": calls[0],
              "cache_slot_write": cache_slot_write_.launches}
    log(f"phase 19: t5_base TextGenerator.decode of {len(work.inputs)} "
        f"sources of {min(lengths)}-{max(lengths)} tokens, greedy: {tokens} "
        f"tokens in {out['model_calls']} decoder calls, "
        f"{decode['ms_per_decoder_call']:.3f} ms per call, "
        f"{decode['tok_per_s']:.1f} tok/s, peak {decode['peak_mib']:.1f} "
        f"MiB; flash_fwd_t5 {counts['flash_fwd_t5']} = "
        f"{work.cfg.encoder_layers} layers x {calls[0]} batch(es); "
        f"cache_slot_write "
        f"{cache_slot_write_.launches} = {layers} layers x {singles} "
        f"single-token calls")
    del work
    torch.cuda.empty_cache()
    res["train"], res["decode"] = train, decode
    return res

# -- phase 20 ------------------------------------------------------------------

# The float32 kernels' timings, one shape per bias kind: bias kind ->
# ((B, H, Hkv, S, D), causal)
F32_TIMED = {
    None: ((2, 8, 2, 2048, 64), True),      # llama-like GQA: rows 10, 13
    "alibi": ((2, 8, 8, 2048, 64), True),   # rows 9, 12, 15 (per-sample ALiBi)
    "t5": ((8, 12, 12, 512, 64), False),    # rows 11, 14, 16
}
F32_LM_RTOL = 0.001   # the port's own CLI in float32 on the CPU
F32_CONFIGS = {"lm": LM_CONFIG, "alibi": os.path.join(TESTDATA, "alibi_mini.yaml"),
               "t5": os.path.join(TESTDATA, "t5_mini.yaml")}


def f32_timing(kind, cuda_tests) -> dict:
    """The float32 kernels of one bias kind at F32_TIMED's shape: device ms
    per call (CUDA graph; the least and greatest replay beside the mean) of
    the forward, dq, dk/dv and dbias or demb, the bounds (the products at
    float32 accuracy over the lesser time of the card's float32 rate
    outside the tensor cores, FP32_FLOPS, and of split TF32 on them,
    FP32_TC_FLOPS, both kept; or the float32 bytes over the memory rate),
    the plain version's ms, and the library yardstick:
    F.scaled_dot_product_attention on the float32 operands (the bias
    materialized as a float32 attn_mask), its backward, with the mask's
    gradient for dbias and demb (index_add_ by bucket after it for demb).
    demb is the T5 dq kernel's instance that also sums the table's
    gradient, as phase 18 times the bf16 one: its bound is the dq's three
    products and bytes, the partial rows' bytes and one float32 add of each
    visible dS; beside it what it adds to the dq kernel ("adds_ms", read in
    turn with the dq without it, "dq_ms") against that increment's own
    bound ("adds_bound_ms"); its plain version the plain backward and
    demb."""
    import torch
    import torch.nn.functional as F
    from pasero_torch.ops.flash_attention import (
        T5Bias, flash_bwd_dbias, flash_bwd_dkv, flash_bwd_dq,
        flash_bwd_plain, flash_dbias_plain, flash_demb_plain, flash_fwd,
        flash_fwd_plain, visible)
    from pasero_torch.scripts.bench_flash_bwd import time_demb
    (B, H, Hkv, S, D), causal = F32_TIMED[kind]
    q, k, v, do, mask = cuda_tests.flash_inputs(B, H, Hkv, S, D, False,
                                                dtype=torch.float32)
    if kind == "t5":
        bias = T5Bias(cuda_tests.t5_table(H), True)
        dense = bias.materialize(S, S)
    else:
        bias = dense = None if kind is None else \
            cuda_tests.flash_bias(kind, B, H, S, mask)
    args = (D ** -0.5, causal, None)
    out, lse = flash_fwd(q, k, v, mask, *args, bias)
    _, delta = flash_bwd_dq(q, k, v, mask, out, lse, do, *args, bias)
    pairs = float(visible(mask, S, causal, None).expand(B, 1, S, S).sum()) * H
    product = 2.0 * pairs * D
    q_bytes, kv_bytes, row_bytes = B * H * S * D * 4, B * Hkv * S * D * 4, \
        B * H * S * 4
    bias_bytes = 0 if dense is None else (
        4 * (2 * S - 1) + 4 * 32 * H if kind == "t5"
        else 4.0 * pairs / H * dense.shape[1] * dense.shape[0] / B)

    def bound(products, nbytes, adds=0.0):
        core, tc = (products * product / rate
                    for rate in (FP32_FLOPS, FP32_TC_FLOPS))
        ops = max(min(core, tc), adds / FP32_ADDS)
        mem = nbytes / HBM_BYTES_PER_S
        return {"bound_ms": max(ops, mem) * 1e3, "ops_bound_ms": ops * 1e3,
                "fp32_ops_bound_ms": core * 1e3,
                "tf32x3_ops_bound_ms": tc * 1e3,
                "bytes_bound_ms": mem * 1e3,
                "bound_by": "operations" if ops >= mem else "bytes"}

    res = {"shape": [B, H, Hkv, S, D], "causal": causal,
           "fwd": bound(2, 2 * q_bytes + 2 * kv_bytes + row_bytes
                        + bias_bytes),
           "dq": bound(3, 4 * q_bytes + 2 * kv_bytes + 2 * row_bytes
                       + bias_bytes),
           "dkv": bound(4, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
                        + bias_bytes)}
    kernels = {
        "fwd": lambda: flash_fwd(q, k, v, mask, *args, bias),
        "dq": lambda: flash_bwd_dq(q, k, v, mask, out, lse, do, *args, bias),
        "dkv": lambda: flash_bwd_dkv(q, k, v, mask, do, lse, delta, *args,
                                     bias)}
    grad = None
    if kind == "t5":
        grad = "demb"
        partial_bytes = 4 * B * H * -(-S // 64) * bias.num_buckets
        res[grad] = bound(3, 4 * q_bytes + 2 * kv_bytes + 2 * row_bytes
                          + bias_bytes + partial_bytes, pairs)
        kernels[grad] = lambda: flash_bwd_dq(q, k, v, mask, out, lse, do,
                                             *args, bias, table_grad=True)
        fused = time_demb((B, H, Hkv, S, D), causal, kind,
                          dtype=torch.float32)
        res[grad].update(dq_ms=fused["dq_ms"],
                         adds_ms=fused["fused_ms"] - fused["dq_ms"],
                         adds_bound_ms=max(pairs / FP32_ADDS, partial_bytes
                                           / HBM_BYTES_PER_S) * 1e3)
    elif kind is not None:
        grad = "dbias"
        # the bias read over the visible pairs, dbias written whole (zeros
        # above the diagonal too), in the bias's own shape
        dbias_bytes = 4.0 * dense.shape[0] * dense.shape[1] * S * S
        res[grad] = bound(2, 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes
                          + bias_bytes + dbias_bytes)
        kernels[grad] = lambda: flash_bwd_dbias(q, k, v, mask, bias, do, lse,
                                                delta, *args)
    for key, fn in kernels.items():
        res[key]["ms"] = device_ms(fn, 5, 5, spread=res[key])
    plain = {"fwd": lambda: flash_fwd_plain(q, k, v, mask, *args, bias),
             "dq": lambda: flash_bwd_plain(q, k, v, mask, out, lse, do, *args,
                                           bias)}
    if grad == "demb":
        plain[grad] = lambda: (
            flash_bwd_plain(q, k, v, mask, out, lse, do, *args, bias),
            flash_demb_plain(q, k, v, mask, out, lse, do, *args, bias))
    elif grad:
        plain[grad] = lambda: flash_dbias_plain(q, k, v, mask, out, lse, do,
                                                *args, bias)
    for key, fn in plain.items():
        res[key]["plain_ms"] = time_ms(fn, 3, 1)
    res["dkv"]["plain_ms"] = res["dq"]["plain_ms"]   # one plain backward
    # the library yardstick; the port never calls it
    future = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    lib_mask = None if dense is None else dense.expand(B, H, S, S)
    if causal:
        lib_mask = torch.zeros(S, S, device=q.device) if lib_mask is None \
            else lib_mask
        lib_mask = lib_mask.masked_fill(future, float("-inf"))
    lib_mask = None if lib_mask is None else lib_mask.contiguous()

    def sdpa(q, k, v, m=lib_mask):
        if Hkv != H:
            k, v = (x.repeat_interleave(H // Hkv, 1) for x in (k, v))
        return F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                              scale=args[0])
    lib = library_times(sdpa, (q, k, v), do, 5, 5)
    res["fwd"]["library_ms"] = lib["fwd"]
    res["dq"]["library_ms"] = res["dkv"]["library_ms"] = lib["bwd"]
    if grad:
        buckets = bias.buckets(S, S).reshape(-1) if kind == "t5" else None

        def mask_grad(grads):   # the mask's gradient, by bucket for T5
            g = grads[-1]
            if buckets is None:
                return g
            demb = torch.zeros(H, 32, device=q.device)
            return demb.index_add_(1, buckets, g.sum(0).reshape(H, S * S))
        lib = library_times(lambda *x: sdpa(*x[:3], x[3]),
                            (q, k, v, lib_mask), do, 3, 3, grad_of=mask_grad)
        res[grad]["library_ms"] = lib["bwd"]
    del q, k, v, do, out, lse, delta, lib_mask, dense
    torch.cuda.empty_cache()
    for key in kernels:
        r = res[key]
        log(f"phase 20: float32 {key} with bias {kind} at "
            f"{tuple(res['shape'])} causal {causal}: device ms per call (CUDA "
            f"graph) {r['ms']:.4f} (replays {r['min_ms']:.4f}-"
            f"{r['max_ms']:.4f}), bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}: float32 operations on the CUDA cores "
            f"{r['fp32_ops_bound_ms']:.4f}, as split TF32 on the tensor "
            f"cores {r['tf32x3_ops_bound_ms']:.4f}, bytes "
            f"{r['bytes_bound_ms']:.4f}), plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']:.4f}"
            + (f"; the dq without demb {r['dq_ms']:.4f} read in turn, so "
               f"demb adds {r['adds_ms']:.4f}, bound {r['adds_bound_ms']:.4f}"
               if key == "demb" else ""))
    return res


# device ms per call of the float32 dbias kernel's first design (CUDA-core
# FMAs) at F32_TIMED["alibi"]'s shape with its per-sample bias (PERF.md,
# "NVIDIA H100 80GB HBM3, 700.00 W"): a gate, not a reading of this run
DBIAS_F32_EARLIER_MS = 0.8678


def f32_shared_dbias_timing(cuda_tests) -> dict:
    """The float32 dbias kernel at F32_TIMED["alibi"]'s shape with a learned
    (1, H) bias, shared over the batch (summed inside the kernel): device
    ms per call (CUDA graph; least and greatest replay beside), the bound
    (the two split-TF32 products; q, k, v, dO, lse and delta, the bias read
    over the visible pairs once and dbias written whole once), the plain
    version's ms and the library yardstick (float32 SDPA with the bias as
    an attn_mask, its backward with the mask's gradient summed over the
    batch)."""
    import torch
    import torch.nn.functional as F
    from pasero_torch.ops.flash_attention import (flash_bwd_dbias,
                                                  flash_bwd_dq,
                                                  flash_dbias_plain,
                                                  flash_fwd, visible)
    (B, H, Hkv, S, D), causal = F32_TIMED["alibi"]
    q, k, v, do, mask = cuda_tests.flash_inputs(B, H, Hkv, S, D, False,
                                                dtype=torch.float32)
    bias = cuda_tests.flash_bias("learned_1xH", B, H, S, mask)
    args = (D ** -0.5, causal, None)
    out, lse = flash_fwd(q, k, v, mask, *args, bias)
    _, delta = flash_bwd_dq(q, k, v, mask, out, lse, do, *args, bias)
    pairs = float(visible(mask, S, causal, None).expand(B, 1, S, S).sum()) * H
    ops = 2 * 2.0 * pairs * D / FP32_TC_FLOPS
    nbytes = 4.0 * ((2 * H + 2 * Hkv) * B * S * D + 2 * B * H * S
                    + pairs / B + H * S * S)
    mem = nbytes / HBM_BYTES_PER_S
    res = {"shape": [B, H, Hkv, S, D], "causal": causal, "bias": [1, H],
           "bound_ms": max(ops, mem) * 1e3, "ops_bound_ms": ops * 1e3,
           "bytes_bound_ms": mem * 1e3,
           "bound_by": "operations" if ops >= mem else "bytes"}
    res["ms"] = device_ms(lambda: flash_bwd_dbias(q, k, v, mask, bias, do,
                                                  lse, delta, *args),
                          5, 5, spread=res)
    res["plain_ms"] = time_ms(lambda: flash_dbias_plain(
        q, k, v, mask, out, lse, do, *args, bias), 3, 1)
    # the mask expanded over the batch, as phase 20's per-sample yardstick
    # takes it, its gradient summed over the batch after
    lib_mask = bias.masked_fill(torch.ones(S, S, dtype=torch.bool,
                                           device=q.device).triu(1),
                                float("-inf")).expand(B, H, S, S).contiguous()

    def sdpa(q, k, v, m):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                              scale=args[0])
    lib = library_times(sdpa, (q, k, v, lib_mask), do, 3, 3,
                        grad_of=lambda grads: grads[-1].sum(0))
    res["library_ms"] = lib["bwd"]
    del q, k, v, do, out, lse, delta, bias, lib_mask
    torch.cuda.empty_cache()
    log(f"phase 20: float32 dbias with a shared (1, {H}) bias at "
        f"{(B, H, Hkv, S, D)} causal {causal}: device ms per call (CUDA "
        f"graph) {res['ms']:.4f} (replays {res['min_ms']:.4f}-"
        f"{res['max_ms']:.4f}), bound {res['bound_ms']:.4f} "
        f"({res['bound_by']}: split TF32 {res['ops_bound_ms']:.4f}, bytes "
        f"{res['bytes_bound_ms']:.4f}), plain {res['plain_ms']:.4f}, library "
        f"{res['library_ms']:.4f}")
    return res


def f32_cli(name: str):
    """``python -m pasero_torch.cli.train`` on F32_CONFIGS[name] with
    ``--dtype float32``, started in a subprocess: (process, model
    directory)."""
    import shutil
    cli = load_test_module("test_torch_train_cli")
    lm_cli = load_test_module("test_torch_lm_cli")
    model_dir = os.path.join(ROOT, "build", f"smoke-f32-{name}")
    shutil.rmtree(model_dir, ignore_errors=True)
    os.makedirs(model_dir)
    ckpt = os.path.join(ROOT, "build", f"smoke-f32-{name}-init.npz")
    cli.write_initial_weights(ckpt, F32_CONFIGS[name])
    cmd = [sys.executable, "-m", "pasero_torch.cli.train",
           *cli.train_flags(model_dir, ckpt, F32_CONFIGS[name]),
           *lm_cli.F32_FLAGS]
    return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), model_dir


def phase20() -> dict:
    """Float32 models on the flash path: the training CLI in float32 on
    lm_mini.yaml (losses within F32_LM_RTOL of the port's own CPU golden),
    alibi_mini.yaml and t5_mini.yaml (finite losses that fall), each with
    exact launch counts of the float32 kernels and none of a bf16 flash
    kernel, in subprocesses while the float32 kernels are held against their
    plain version within the float32 error model of tests/test_torch_cuda.py
    (``flash_f32_compare``) at every FLASH_F32_CASES case and a learned bias
    launches the float32 dbias kernel once; then, alone on the card, their
    times at F32_TIMED's shapes, where they are held against the plain
    version too."""
    import torch
    from pasero_torch.ops import flash_attention as fa
    cuda_tests = load_test_module("test_torch_cuda")
    t0 = time.perf_counter()
    procs = {name: f32_cli(name) for name in F32_CONFIGS}
    errs = {}
    cases = list(cuda_tests.FLASH_F32_CASES)
    for kind, (shape, causal) in F32_TIMED.items():
        if (shape, causal, None, False, kind) not in cases:
            cases.append((shape, causal, None, False, kind))
    for case in cases:
        r = cuda_tests.flash_f32_compare(*case)
        check(r["lse_err"] <= cuda_tests.F32_LSE_ATOL, f"float32 lse differs "
              f"at {case} by {r['lse_err']}")
        check(max(r["excess"]) <= 1.0, f"float32 flash kernels differ at "
              f"{case}: {r['excess']} of their limits")
        check(min(r["mutants"].values()) >= 2.8, f"the float32 flash check "
              f"at {case} passes a mutation: {r['mutants']}")
        check(r["same_bits"], f"two float32 forward and backward calls at "
              f"{case} gave other bits")
        kind = case[-1] if case[-1] in (None, "t5") else (
            "t5" if case[-1] == "t5_causal" else "alibi")
        for key, e in r["max_abs_err"].items():
            at = (kind, key)
            errs[at] = max(errs.get(at, 0.0), e)
        log(f"phase 20: float32 flash kernels == plain at {case}: out, dq, "
            f"dk, dv{', ' + ('demb' if 't5' in str(case[-1]) else 'dbias') if case[-1] else ''} "
            f"at {', '.join(f'{e:.3f}' for e in r['excess'])} of their limits, "
            f"lse {r['lse_err']:.2e}; mutations at "
            f"{json.dumps({k: round(v, 1) for k, v in r['mutants'].items()})} "
            f"of them; out, dq, dk, dv"
            f"{' and demb' if 't5' in str(case[-1]) else ''} the same bits "
            "twice")
        torch.cuda.empty_cache()
    res = {"errs": errs, "timing": {}}
    # a learned bias through flash_attention's autograd: dbias's one launch
    (B, H, Hkv, S, D), causal, *_ = cuda_tests.FLASH_F32_CASES[4]
    q, k, v, do, mask = cuda_tests.flash_inputs(B, H, Hkv, S, D, True,
                                                dtype=torch.float32)
    bias = cuda_tests.flash_bias("learned_1xH", B, H, S, mask)
    bias.requires_grad_()
    fa.reset_launch_counts()
    fa.flash_attention(q, k, v, mask=mask[:, None, None, :], bias=bias,
                       scale=D ** -0.5, causal=causal).backward(do)
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    want = {n: int(n.endswith("bias_f32")) for n in counts}
    check(counts == want, f"a float32 learned bias through flash_attention "
          f"launched {counts}, not {want}")
    res["learned_bias_launches"] = counts
    del q, k, v, do, bias
    # the training CLI in float32
    cli = load_test_module("test_torch_train_cli")
    res["cli"] = {}
    for name, (proc, model_dir) in procs.items():
        out = proc.communicate(timeout=900)[0]
        check(proc.returncode == 0, f"cli.train (float32 {name}) failed:\n"
              f"{out[-4000:]}")
        logs = cli.parse_log(out)
        losses = [l["loss"] for l in logs]
        check([l["step"] for l in logs] == list(range(1, 21)),
              f"float32 {name}: logged steps {[l['step'] for l in logs]}")
        check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
              f"float32 {name}: losses {losses}")
        counts = parse_launches(out)
        micro, valid = counts["train micro-batches"], counts["valid batches"]
        check(micro == 20 and valid > 0, f"float32 {name}: {micro} "
              f"micro-batches, {valid} validation batches")
        with open(os.path.join(model_dir, "config.json")) as f:
            config = json.load(f)
        with open(os.path.join(model_dir, "inference.yaml")) as f:
            check("dtype: float32" in f.read().splitlines(), f"float32 "
                  f"{name}: the model directory's inference.yaml names "
                  "another dtype")
        if name == "t5":
            want = t5_train_counts(config["encoder_layers"],
                                   config["decoder_layers"], micro, valid,
                                   True)
        elif name == "alibi":
            want = alibi_train_counts(config["decoder_layers"], micro, valid,
                                      True)
        else:
            layers = config["decoder_layers"]
            want = flash_counts({"flash_fwd": layers * (micro + valid),
                                 "flash_bwd_dq": layers * micro,
                                 "flash_bwd_dkv": layers * micro,
                                 "fused_ce_fwd": micro + valid,
                                 "fused_ce_bwd": micro}, True)
        got = {key: counts[key] for key in want}
        check(got == want, f"float32 {name} CLI launches {got} != {want}")
        worst = None
        if name == "lm":
            with open(os.path.join(TESTDATA,
                                   "lm_mini_f32_train20.cpu.json")) as f:
                golden = json.load(f)["steps"]
            worst = max(abs(l["loss"] - g["loss"]) / abs(g["loss"])
                        for l, g in zip(logs, golden))
            check(worst <= F32_LM_RTOL, f"float32 LM losses {losses} differ "
                  f"from the CPU golden's {[g['loss'] for g in golden]} by "
                  f"{worst:.4%}")
        log(f"phase 20: python -m pasero_torch.cli.train on "
            f"{os.path.basename(F32_CONFIGS[name])} --dtype float32, 20 "
            f"steps: losses {losses[0]:.3f} -> {losses[-1]:.3f}"
            + ("" if worst is None else f", all within {worst:.4%} of the "
               "port's float32 CPU golden")
            + f"; float32 flash launches "
            f"{ {k: v for k, v in got.items() if k.endswith('_f32') and v} } "
            f"and no bf16 flash kernel, for {micro} micro-batches and "
            f"{valid} validation batches")
        res["cli"][name] = {"launches": got, "worst_loss_rel": worst,
                            "losses": losses}
    # timed once the CLIs have ended, alone on the card
    for kind in F32_TIMED:
        res["timing"][kind] = f32_timing(kind, cuda_tests)
    res["dbias_shared"] = f32_shared_dbias_timing(cuda_tests)
    for name, r in (("a per-sample", res["timing"]["alibi"]["dbias"]),
                    ("a shared (1, H)", res["dbias_shared"])):
        check(r["ms"] <= DBIAS_F32_EARLIER_MS and r["ms"] <= r["library_ms"],
              f"the float32 dbias with {name} bias takes {r['ms']:.4f} ms, "
              f"more than its first design's {DBIAS_F32_EARLIER_MS} or its "
              f"library call's {r['library_ms']:.4f}")
        log(f"phase 20: the float32 dbias with {name} bias {r['ms']:.4f} ms "
            f"against its first design's {DBIAS_F32_EARLIER_MS} (PERF.md) "
            f"and its library call's {r['library_ms']:.4f}")
    log(f"phase 20: done in {time.perf_counter() - t0:.1f} s")
    return res


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
    global HBM_BYTES_PER_S, BF16_FLOPS, FP32_FLOPS, FP32_TC_FLOPS, \
        FP32_ADDS, time_ms
    from pasero_torch.scripts.bench_int8 import (BF16_FLOPS, FP32_FLOPS,
                                                 FP32_TC_FLOPS,
                                                 HBM_BYTES_PER_S,
                                                 eager_ms as time_ms)
    from pasero_torch.scripts.bench_fused_ce import HEADS as CE_HEADS
    FP32_ADDS = FP32_FLOPS / 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase0()
    timing = phase1()
    launches = phase2()
    full_width_launches = phase3()
    ce = phase4()
    train_full_width = phase5()
    train_cli = phase6()
    flash = phase7()
    lm_full_width = phase8()
    lm_cli = phase9()
    serving_kernels = phase10()
    lm_decode = phase11()
    serving = phase12()
    mel = phase13()
    speech = phase14()
    whisper = phase15()
    biased = phase16()
    alibi = phase17()
    t5 = phase18()
    t5_paths = phase19()
    f32 = phase20()
    # the slot write: numbers at transformer-base's beam-5 decode shape,
    # llama_1b's beside; launches of phase 2's deen-mini2 decode, phase 3's
    # full-width one and phase 11's llama_1b bf16 greedy decode
    at = timing["transformer_base"]
    kernels = [{
        "name": "cache_slot_write",
        "route": "cuda",
        "source": "pasero_torch/csrc/cache_update.cu",
        "replaces": "pasero_tpu/ops/cache_update.py:43",
        "bodies": ["cache_update.cu slot_write_kernel<int4, false, false> "
                   "(16-byte rows; uint16_t / uint32_t elements otherwise), "
                   "a programmatic dependent launch"],
        "launches": launches,
        "full_width_launches": full_width_launches,
        "llama_1b_launches": lm_decode["bf16 greedy"]["cache_slot_write"],
        "speech_launches": speech["cache_slot_write"],
        "whisper_launches": whisper["decode"]["cache_slot_write"],
        "max_abs_err": timing["max_abs_err"],
        "ms": at["ms"],
        "floor_ms": at["floor_ms"],
        "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"],
        "bound_by": "bytes",
        "library_ms": at["library_ms"],
        "host_ms": at["host_ms"],
        "plain_host_ms": at["plain_host_ms"],
        "library_host_ms": at["library_host_ms"],
        "shape": at["shape"],
        "llama_1b": {k: timing["llama_1b"][k] for k in (
            "shape", "ms", "floor_ms", "plain_ms", "bound_ms",
            "library_ms", "host_ms")},
    }]
    for key, line in (("fwd", 199), ("bwd", 234)):
        entry = {
            "name": f"fused_ce_{key}",
            "route": "cuda",
            "source": "pasero_torch/csrc/fused_ce.cu",
            "replaces": f"pasero_tpu/ops/fused_ce.py:{line}",
            "mainloop": "pasero_torch/csrc/wgmma_gemm.cuh",
            "launches": train_cli[key],
            "full_width_launches": train_full_width,
            "max_abs_err": ce[key]["max_abs_err"],
            "ms": ce[key]["ms"],
            "plain_ms": ce[key]["plain_ms"],
            "bound_ms": ce[key]["bound_ms"],
            "bound_by": ce[key]["bound_by"],
            "library_ms": ce[key]["library_ms"],
            "lm_head": {name: ce["lm_head"][key][name] for name in
                        ("ms", "plain_ms", "bound_ms", "library_ms")},
            "lm_launches": lm_cli[f"fused_ce_{key}"],
            "lm_full_width_launches": lm_full_width[f"fused_ce_{key}"],
            "speech_launches": speech[f"fused_ce_{key}"],
            "whisper_launches": whisper["train"][f"fused_ce_{key}"],
            "bloom_launches": alibi["train"]["launches"][f"fused_ce_{key}"],
            "t5_launches": t5_paths["train"]["launches"][f"fused_ce_{key}"],
            # every main-path head, shape (B*T, E, V) in CE_HEADS
            "heads": {head: {name: ce["heads"][head][key][name] for name in
                             ("ms", "plain_ms", "bound_ms", "library_ms")}
                      for head in CE_HEADS},
        }
        entry["lm_head"]["shape"] = list(CE_HEADS["llama_1b"])
        for head, shape in CE_HEADS.items():
            entry["heads"][head]["shape"] = list(shape)
            entry["heads"][head]["peak_mib"] = ce["heads"][head]["fwd"]["peak_mib"]
            entry["heads"][head]["library_peak_mib"] = \
                ce["heads"][head]["fwd"]["library_peak_mib"]
            entry["heads"][head]["scratch_mib"] = \
                ce["heads"][head][key]["scratch_mib"]
        if key == "fwd":   # graph-timed; the eager times beside
            for head in CE_HEADS:
                own = ce["heads"][head]["fwd"]
                entry["heads"][head].update(
                    host_ms=own["host_ms"],
                    library_host_ms=own["library_host_ms"],
                    same_bits=own["same_bits"])
        else:   # one design replaces both JAX backwards
            entry["also_replaces"] = "pasero_tpu/ops/fused_ce.py:281"
        kernels.append(entry)
    # the fused CE's float32 instances (split TF32, counted with the bf16
    # ones as fused_ce_fwd and fused_ce_bwd): launches of phase 20's float32
    # training CLIs (lm_mini.yaml; alibi_mini.yaml and t5_mini.yaml beside),
    # numbers at t5_base's head
    for key, line in (("fwd", 199), ("bwd", 234)):
        own = ce["f32"][key]
        entry = {
            "name": f"fused_ce_{key}_f32",
            "route": "cuda",
            "source": "pasero_torch/csrc/fused_ce.cu",
            "replaces": f"pasero_tpu/ops/fused_ce.py:{line}",
            "dtype": "float32",
            "launches": f32["cli"]["lm"]["launches"][f"fused_ce_{key}"],
            "alibi_launches": f32["cli"]["alibi"]["launches"][f"fused_ce_{key}"],
            "t5_launches": f32["cli"]["t5"]["launches"][f"fused_ce_{key}"],
            "max_abs_err": own["max_abs_err"],
            "ms": own["ms"],
            "plain_ms": own["plain_ms"],
            "bound_ms": own["bound_ms"],
            "bound_by": own["bound_by"],
            "tf32x3_ops_bound_ms": own["tf32x3_ops_bound_ms"],
            "fp32_ops_bound_ms": own["fp32_ops_bound_ms"],
            "bytes_bound_ms": own["bytes_bound_ms"],
            "library_ms": own["library_ms"],
            "host_ms": own["host_ms"],
            "scratch_mib": own["scratch_mib"],
            "shape": list(CE_HEADS["t5_base"]),
        }
        if key == "bwd":
            entry["also_replaces"] = "pasero_tpu/ops/fused_ce.py:281"
        kernels.append(entry)
    for name, key, line in (("flash_fwd", "fwd", 342),
                            ("flash_bwd_dq", "dq", 963),
                            ("flash_bwd_dkv", "dkv", 1018)):
        # the two backward kernels share the backward's numbers (the
        # function's bound, the plain and library backwards); each adds its
        # own time and the bound of its own outputs
        own = flash[key]
        side = flash["fwd"] if key == "fwd" else flash["bwd"]
        entry = {
            "name": name,
            "route": "cuda",
            "source": "pasero_torch/csrc/flash_bwd.cu",
            "replaces": f"pasero_tpu/ops/flash_attention.py:{line}",
            "launches": lm_cli[name],
            "full_width_launches": lm_full_width[name],
            "max_abs_err": own["max_abs_err"],
            "ms": side["ms"],
            "plain_ms": side["plain_ms"],
            "bound_ms": side["bound_ms"],
            "bound_by": "operations",
            "ops_bound_ms": side["ops_bound_ms"],
            "bytes_bound_ms": side["bytes_bound_ms"],
            "library_ms": side["library_ms"],
            "library_host_ms": side["library_host_ms"],
            "host_ms": side["host_ms"],
        }
        if key != "fwd":
            entry.update(kernel_ms=own["kernel_ms"],
                         kernel_bound_ms=own["kernel_bound_ms"],
                         also_replaces="pasero_tpu/ops/flash_attention.py:1086")
        kernels.append(entry)
    # the kernel bodies each wrapper launches: the decode mainloop at up to
    # 80 rows, the prompt's above, each with its epilogue; then the heads'
    # merge
    bodies = {
        "int8_matmul": [
            "weight_gemm.cuh decode_kernel<NT, Int8Weight, StoreDecode<OutT>>",
            "weight_gemm.cuh prompt_kernel<BX, StorePrompt<OutT>>"],
        "fused_head_argmax": [
            "weight_gemm.cuh decode_kernel<1, Bf16Weight, DecodePartials> "
            "(N <= 8)",
            "wgmma_gemm.cuh gemm_kernel<false, false, TilePartials, true> "
            "(N > 8)",
            "fused_head.cu combine_kernel"],
        "fused_head_argmax_q8": [
            "weight_gemm.cuh decode_kernel<NT, Int8Weight, DecodePartials> "
            "(N <= 16)",
            "weight_gemm.cuh prompt_kernel<BX, PromptPartials> (N > 16)",
            "fused_head.cu combine_kernel"]}
    # the main path's counts: phase 11's llama_1b run of the mode that
    # launches each kernel; each kernel's numbers at llama_1b's decode shape
    for name, line, mode, timed in (
            ("int8_matmul", "quantize.py:245", "int8 greedy", [8, 2048, 5632]),
            ("fused_head_argmax", "fused_ce.py:431", "bf16 fused head",
             [8, 2048, 32000]),
            ("fused_head_argmax_q8", "fused_ce.py:387", "int8 fused head",
             [8, 2048, 32000])):
        own = serving_kernels[name]
        at = next(r for r in own["by_shape"] if r["shape"] == timed)
        entry = {
            "name": name,
            "route": "cuda",
            "source": ("pasero_torch/csrc/int8_matmul.cu"
                       if name == "int8_matmul"
                       else "pasero_torch/csrc/fused_head.cu"),
            "replaces": f"pasero_tpu/ops/{line}",
            "bodies": bodies[name],
            "launches": lm_decode[mode][name],
            "max_abs_err": own["max_abs_err"],
            "ms": at["ms"],
            "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"],
            "library_ms": at["library_ms"],
            "hot_ms": at["hot_ms"],
            "library_hot_ms": at["library_hot_ms"],
            "weight_copies": at["copies"],
            "shape": timed,
            "by_shape": own["by_shape"],
            **{k: v for k, v in own.items() if k.startswith("decoder_call")},
            "launches_by_mode": {m: counts[name]
                                 for m, counts in lm_decode.items()},
            "serving_launches": {k: v[name] for k, v in serving.items()
                                 if name in v},
        }
        kernels.append(entry)
    # the main path's count: phase 14's decode of the anchor's 32 wavs; the
    # numbers at bench_mel's shape (16, 480000), the per-utterance shape
    # beside them
    at, per_wav = mel["by_shape"]
    kernels.append({
        "name": "power_mel",
        "route": "cuda",
        "source": "pasero_torch/csrc/mel.cu",
        "replaces": "pasero_tpu/ops/mel.py:130",
        "launches": speech["power_mel"],
        "full_width_launches": whisper["decode"]["power_mel"],
        "extract_features_launches": speech["extract_launches"],
        "max_abs_err": mel["max_abs_err"],
        "ms": at["ms"],
        "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"],
        "method_bound_ms": at["method_bound_ms"],
        "library_ms": at["library_ms"],
        "shape": at["shape"],
        "by_shape": mel["by_shape"],
    })
    # the biased kernels: launches of phase 17's ALiBi training CLI (none of
    # the dbias kernel there: ALiBi's bias is a constant), of bloom_560m's
    # full-width steps and, apart, of phase 16's learned (1, H) bias, the
    # one run that launches dbias; numbers at bloom_560m's shape with its
    # per-sample ALiBi bias; the forward, dq and dk/dv are flash_bwd.cu's
    # DENSE_BIAS instances, with the bias-free ones' times at the same shape
    # beside, and their times at 16500 keys; the forward's also at the other
    # shapes of FLASH_BIAS_SHAPES
    for name, key, line, body in (
            ("flash_fwd_bias", "fwd", 381, 186),
            ("flash_bwd_dq_bias", "dq", 1398, 866),
            ("flash_bwd_dkv_bias", "dkv", 1398, 911),
            ("flash_bwd_dbias", "dbias", 1213, 1160)):
        own = biased[key]
        entry = {
            "name": name,
            "route": "cuda",
            "source": ("pasero_torch/csrc/flash_attention.cu" if key == "dbias"
                       else "pasero_torch/csrc/flash_bwd.cu"),
            "replaces": f"pasero_tpu/ops/flash_attention.py:{line}",
            "kernel_body": f"pasero_tpu/ops/flash_attention.py:{body}",
            "launches": alibi["cli"]["launches"][name],
            "full_width_launches": alibi["train"]["launches"][name],
            "learned_bias_launches": biased["learned_bias_launches"][name],
            "max_abs_err": own["max_abs_err"],
            "ms": own["ms"],
            "plain_ms": own["plain_ms"],
            "bound_ms": own["bound_ms"],
            "bound_by": own["bound_by"],
            "ops_bound_ms": own["ops_bound_ms"],
            "bytes_bound_ms": own["bytes_bound_ms"],
            "library_ms": own["library_ms"],
            "library_host_ms": own["library_host_ms"],
            "shape": list(FLASH_BIAS_SHAPES[0][0]),
        }
        if key in ("dq", "dkv"):   # the backward function's numbers beside
            entry["backward"] = {k: biased["bwd"][k] for k in (
                "ms", "bound_ms", "bound_by", "plain_ms", "library_ms")}
        if key != "dbias":
            long = biased["at_16500"]
            entry.update(bias_free_ms=biased["bias_free"][key],
                         at_16500={"shape": long["shape"],
                                   "ms": long[long["bias"]][key],
                                   "bias_free_ms": long["none"][key]})
        if key == "fwd":
            entry["by_shape"] = biased["fwd_by_shape"]
        kernels.append(entry)
    # the T5 kernels: launches of phase 19's T5 training CLI and of
    # t5_base's full-width steps; numbers at t5_base's encoder shape, then
    # at 32768 keys; dq and dk/dv are flash_bwd.cu's T5_BIAS instances, with
    # the bias-free ones' times at the same shapes beside; demb is the T5 dq
    # kernel's instance that also sums the table's gradient (its own
    # launches, time, bound, plain version and library call; what it adds
    # to the dq kernel beside, with that increment's own bound)
    for name, key, line, body in (
            ("flash_fwd_t5", "fwd", 544, 474),
            ("flash_bwd_dq_t5", "dq", 738, 618),
            ("flash_bwd_dkv_t5", "dkv", 738, 676),
            ("flash_bwd_dq_t5_demb", "demb", 1318, 1255)):
        own = t5[key]
        counted = name
        entry = {
            "name": name,
            "route": "cuda",
            "source": "pasero_torch/csrc/flash_bwd.cu",
            "replaces": f"pasero_tpu/ops/flash_attention.py:{line}",
            "kernel_body": f"pasero_tpu/ops/flash_attention.py:{body}",
            "launches": t5_paths["cli"]["launches"][counted],
            "full_width_launches": t5_paths["train"]["launches"][counted],
            "max_abs_err": own["max_abs_err"],
            "ms": own["ms"],
            "plain_ms": own["plain_ms"],
            "bound_ms": own["bound_ms"],
            "bound_by": own["bound_by"],
            "ops_bound_ms": own["ops_bound_ms"],
            "bytes_bound_ms": own["bytes_bound_ms"],
            "library_ms": own["library_ms"],
            "library_host_ms": own["library_host_ms"],
            "shape": t5["shape"],
            "at_32768": {k: t5["at_32768"][key][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        }
        entry["at_32768"]["shape"] = t5["at_32768"]["shape"]
        if key in ("dq", "dkv"):   # the backward function's numbers beside
            entry["backward"] = {k: t5["bwd"][k] for k in (
                "ms", "bound_ms", "bound_by", "plain_ms", "library_ms")}
            entry["bias_free_ms"] = t5["bias_free"][key]
            entry["at_32768"]["bias_free_ms"] = \
                t5["at_32768"]["bias_free"][key]
        if key == "demb":
            for k in ("dq_ms", "adds_ms", "adds_bound_ms"):
                entry[k] = own[k]
                entry["at_32768"][k] = t5["at_32768"]["demb"][k]
        if key == "fwd":
            entry["decode_launches"] = t5_paths["decode"]["flash_fwd_t5"]
            entry["bias_free_ms"] = t5["bias_free"]["fwd"]
            entry["at_32768"]["bias_free_ms"] = t5["at_32768"]["bias_free"]["fwd"]
            entry["decoder"] = t5["decoder"]
        kernels.append(entry)
    # the bias-free kernels also serve JAX's streamed regime (rows 11, 14)
    for entry in kernels:
        if entry["name"] in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            key = entry["name"].replace("flash_bwd_", "").replace(
                "flash_", "")
            entry["streamed_32768"] = {"ms": t5["long"][f"{key}_ms"],
                                       "shape": t5["long"]["shape"],
                                       "peak_mib": t5["long"]["peak_mib"]}
            if key != "fwd":
                entry["same_bits"] = flash["same_bits"] and \
                    t5["long"]["same_bits"]
    # the float32 instances of every flash row (csrc/flash_f32.cu):
    # launches of the float32 training CLIs (phase 20: lm_mini.yaml for the
    # bias-free kernels, alibi_mini.yaml for the biased ones, t5_mini.yaml
    # for the T5 ones; dbias of the learned bias), numbers at F32_TIMED's
    # shapes
    for name, kind, key, line, cli in (
            ("flash_fwd_f32", None, "fwd", 342, "lm"),
            ("flash_bwd_dq_f32", None, "dq", 1086, "lm"),
            ("flash_bwd_dkv_f32", None, "dkv", 1086, "lm"),
            ("flash_fwd_bias_f32", "alibi", "fwd", 381, "alibi"),
            ("flash_bwd_dq_bias_f32", "alibi", "dq", 1398, "alibi"),
            ("flash_bwd_dkv_bias_f32", "alibi", "dkv", 1398, "alibi"),
            ("flash_bwd_dbias_f32", "alibi", "dbias", 1213, None),
            ("flash_fwd_t5_f32", "t5", "fwd", 544, "t5"),
            ("flash_bwd_dq_t5_f32", "t5", "dq", 738, "t5"),
            ("flash_bwd_dkv_t5_f32", "t5", "dkv", 738, "t5"),
            ("flash_bwd_dq_t5_demb_f32", "t5", "demb", 1318, "t5")):
        own = f32["timing"][kind]
        entry = {
            "name": name,
            "route": "cuda",
            "source": "pasero_torch/csrc/flash_f32.cu",
            "replaces": f"pasero_tpu/ops/flash_attention.py:{line}",
            "dtype": "float32",
            "launches": (f32["cli"][cli]["launches"][name] if cli else
                         f32["learned_bias_launches"][name]),
            "max_abs_err": f32["errs"][(kind, key)],
            "ms": own[key]["ms"],
            "min_ms": own[key]["min_ms"],
            "max_ms": own[key]["max_ms"],
            "plain_ms": own[key]["plain_ms"],
            "bound_ms": own[key]["bound_ms"],
            "bound_by": own[key]["bound_by"],
            "ops_bound_ms": own[key]["ops_bound_ms"],
            "fp32_ops_bound_ms": own[key]["fp32_ops_bound_ms"],
            "tf32x3_ops_bound_ms": own[key]["tf32x3_ops_bound_ms"],
            "bytes_bound_ms": own[key]["bytes_bound_ms"],
            "library_ms": own[key]["library_ms"],
            "shape": own["shape"],
            "causal": own["causal"],
        }
        if key == "demb":   # what demb adds to the dq kernel
            entry.update({k: own[key][k] for k in ("dq_ms", "adds_ms",
                                                   "adds_bound_ms")})
        if cli is None:   # no main path launches it: a learned bias does
            entry["learned_bias_launches"] = entry["launches"]
            entry["launches"] = f32["cli"]["alibi"]["launches"][name]
            entry["bodies"] = [
                "flash_f32.cu dbias_kernel<D, false> (per-sample bias)",
                "flash_f32.cu dbias_kernel<D, true> (a bias shared over the "
                "batch, summed in registers)"]
            entry["shared_1xH"] = {k: f32["dbias_shared"][k] for k in (
                "ms", "min_ms", "max_ms", "plain_ms", "bound_ms", "bound_by",
                "ops_bound_ms", "bytes_bound_ms", "library_ms", "bias")}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
