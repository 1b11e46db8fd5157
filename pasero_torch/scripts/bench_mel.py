#!/usr/bin/env python3
"""Speech frontend benchmark on one card: log-mel frames/s and real-time
factor of ``log_mel_spectrogram`` (the mel kernel of csrc/mel.cu, then
log10, the per-utterance clamp and the scale), the counterpart of
scripts/bench_mel.py at its shape: 16 utterances of 30 s of seeded noise at
16 kHz, 48000 frames per call.

    python -m pasero_torch.scripts.bench_mel [--batch 16] [--seconds 30]
        [--repeats 5]

Prints one JSON line: the card's name and power limit, the device ms per
call (CUDA events over back-to-back calls, best of the repeats), frames/s
and the real-time factor (seconds of compute per second of audio).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

ITERS = 20          # back-to-back calls per repeat


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=16,
                        help="utterances per call")
    parser.add_argument("--seconds", type=float, default=30.0,
                        help="audio length per utterance (Whisper window)")
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this benchmark measures a CUDA card and none is "
                         "available")
    from pasero_torch.ops.mel import log_mel_spectrogram, power_mel
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    audio = torch.randn(args.batch, int(args.seconds * 16000),
                        generator=gen, device="cuda")
    out = log_mel_spectrogram(audio)                  # build and warm up
    torch.cuda.synchronize()
    launches = power_mel.launches
    best = float("inf")
    for _ in range(args.repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            log_mel_spectrogram(audio)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / ITERS)
    frames = out.shape[0] * out.shape[1]
    result = {"card": smi, "shape": list(out.shape), "ms_per_call": best,
              "frames_per_s": frames / (best / 1e3),
              "real_time_factor": best / 1e3 / (args.batch * args.seconds),
              "kernel_launches": power_mel.launches - launches}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
