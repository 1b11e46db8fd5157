#!/usr/bin/env python3
"""Synthetic speech for the st-mini anchor: text lines -> 16 kHz int16 wavs.

numpy only. Each character becomes a tone pair, as a telephone keypad
sounds its keys: one frequency from a low group and one from a high group,
picked by the character's code, 20-30 ms long and shaped by a Hann window;
a space is a gap of the same length. A little white noise runs under the
whole utterance. Durations and noise come from a generator seeded by the
seed and the text, so the same line always gives the same wav.

    python pasero_torch/testdata/synth_speech.py TEXT OUT_DIR [--lines N] [--seed S]

writes OUT_DIR/00000.wav, OUT_DIR/00001.wav, ... one per line of TEXT.
"""

import argparse
import os
import wave
import zlib

import numpy as np

SR = 16000
LOW = 250.0 + 100.0 * np.arange(10)      # Hz
HIGH = 1500.0 + 300.0 * np.arange(10)    # Hz


def synthesize(text: str, seed: int = 0) -> np.ndarray:
    """One line of text -> int16 samples at 16 kHz."""
    rng = np.random.default_rng([seed, zlib.crc32(text.encode())])
    pieces = []
    for char in text:
        n = SR * int(rng.integers(20, 31)) // 1000
        if char == " ":
            pieces.append(np.zeros(n))
            continue
        code = ord(char) % 100
        t = np.arange(n) / SR
        tone = (np.sin(2 * np.pi * LOW[code // 10] * t)
                + np.sin(2 * np.pi * HIGH[code % 10] * t))
        pieces.append(0.25 * tone * np.hanning(n))
    audio = np.concatenate(pieces or [np.zeros(SR // 100)])
    audio = audio + 0.002 * rng.standard_normal(len(audio))
    return np.clip(np.round(audio * 32767), -32768, 32767).astype(np.int16)


def write_wav(path: str, samples: np.ndarray) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(samples.tobytes())


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("text")
    parser.add_argument("out_dir")
    parser.add_argument("--lines", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    with open(args.text) as f:
        lines = [line.rstrip("\n") for line in f][:args.lines]
    os.makedirs(args.out_dir, exist_ok=True)
    for i, line in enumerate(lines):
        write_wav(os.path.join(args.out_dir, f"{i:05d}.wav"),
                  synthesize(line, args.seed))
    print(f"wrote {len(lines)} wavs -> {args.out_dir}")


if __name__ == "__main__":
    main()
