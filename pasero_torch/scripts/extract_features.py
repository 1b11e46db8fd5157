#!/usr/bin/env python3
"""Extract Whisper log-mel features from 16 kHz wavs into the binary feature
format (``NumpyFile``, float16), with the mel on the card: the counterpart of
examples/speech-translation/extract_features.py.

    python -m pasero_torch.scripts.extract_features WAV [WAV ...] -o OUT.feats
        [--n-mels 80] [--device cpu]

Runs of up to 16 consecutive wavs of one length go through one launch of
the mel kernel; the clamp stays per utterance, so a batch gives
each wav the features it gets alone. The records keep the order of the
arguments. ``--device`` defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import wave

import numpy as np

BATCH = 16          # equal-length wavs per launch of the mel kernel


def read_wav(path: str) -> np.ndarray:
    with wave.open(path) as w:
        if w.getframerate() != 16000 or w.getsampwidth() != 2:
            raise ValueError(f"{path}: expected 16 kHz 16-bit audio")
        raw = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    return raw.astype(np.float32) / 32768.0


def batches(paths: list, size: int):
    """Runs of consecutive equal-length waveforms, at most ``size`` long."""
    run: list = []
    for path in paths:
        audio = read_wav(path)
        if run and (len(run) == size or len(run[0]) != len(audio)):
            yield np.stack(run)
            run = []
        run.append(audio)
    if run:
        yield np.stack(run)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("wavs", nargs="+")
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--n-mels", type=int, default=80)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)

    import torch
    from pasero_torch import resolve_device
    from pasero_torch.data.files import NumpyFile
    from pasero_torch.ops.mel import log_mel_spectrogram, power_mel

    device = resolve_device(args.device)

    def features():
        for audio in batches(args.wavs, BATCH):
            feats = log_mel_spectrogram(torch.from_numpy(audio).to(device),
                                        n_mels=args.n_mels).cpu().numpy()
            yield from feats

    NumpyFile.build(args.output, features(), dtype="float16",
                    num_feats=len(args.wavs))
    print(f"wrote {len(args.wavs)} feature arrays -> {args.output} "
          f"({power_mel.launches} mel kernel launches)")


if __name__ == "__main__":
    main()
