"""Log-mel spectrogram frontend: windowed DFT, power and mel filterbank.

Port of pasero_tpu/ops/mel.py. The filterbank and the windowed DFT bases are
that module's numpy code, copied; framing and the log/clamp/scale steps are
its arithmetic in PyTorch. Whisper's parameters: n_fft 400, hop 160, 80 or
128 Slaney mel bins, log10 clamped to the utterance's maximum - 8, then
(x + 4) / 4.

The fused step, frames -> DFT -> power -> mel (JAX's ``_fused_power_mel``),
is ``power_mel``. It takes the waveform, the window (whose length is n_fft)
and the filterbank. CPU tensors take ``power_mel_plain``, which builds the
windowed DFT bases from the window (``window_bases``) and runs the
dense products; CUDA tensors launch the hand-written kernel of
``csrc/mel.cu``, which reads the waveform itself (reflect padding by index),
factors the DFT (n_fft = P * Q, ``KERNEL_FACTORS``) with the twiddle table
of ``_twiddles`` and keeps the power spectrum on the chip. A CUDA tensor
never takes the plain version: the kernel launches or the wrapper raises.
Its launches are counted in ``power_mel.launches``. The route follows the
device, so ``log_mel_spectrogram`` has no ``use_pallas`` switch: on the
card every call runs the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build


def hann_window(n: int) -> np.ndarray:
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


def mel_filterbank(sr: int = 16000, n_fft: int = 400, n_mels: int = 80,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-style mel filterbank (librosa-compatible), (n_freq, n_mels)."""
    fmax = fmax or sr / 2
    n_freq = n_fft // 2 + 1

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        mel = f / (200.0 / 3)
        log_region = f >= 1000.0
        mel = np.where(log_region,
                       15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                       / (np.log(6.4) / 27.0), mel)
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f = m * (200.0 / 3)
        log_region = m >= 15.0
        f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0)
                                                 * (m - 15.0)), f)
        return f

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz = mel_to_hz(mels)
    freqs = np.linspace(0, sr / 2, n_freq)
    weights = np.zeros((n_mels, n_freq))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz[2:n_mels + 2] - hz[:n_mels])  # slaney normalization
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)            # (n_freq, n_mels)


@functools.lru_cache(maxsize=8)
def _dft_angles(n_fft: int, device: torch.device):
    """cos and sin of the DFT angles -2 pi t k / n_fft, (n_fft, n_freq)
    float64 on ``device``: JAX's ``_dft_bases`` before the window."""
    n_freq = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_freq)[None, :]
    angle = -2.0 * np.pi * t * k / n_fft
    return (torch.from_numpy(np.cos(angle)).to(device),
            torch.from_numpy(np.sin(angle)).to(device))


@functools.lru_cache(maxsize=16)
def _constants(sr: int, n_fft: int, n_mels: int, device: torch.device):
    """(window, mel_w) as float32 tensors on ``device``: the Hann window of
    n_fft points and the (n_freq, n_mels) filterbank."""
    return tuple(torch.from_numpy(a).to(device) for a in (
        hann_window(n_fft).astype(np.float32),
        mel_filterbank(sr, n_fft, n_mels)))


@functools.lru_cache(maxsize=8)
def _twiddles(n_fft: int, device: torch.device) -> torch.Tensor:
    """(n_fft, 2) float32 e^(-2 pi i j / n_fft) as (cos, -sin) for j <
    n_fft: computed in float64 and rounded once, the quarter turns exact
    (entry 0 is (1, 0)), so the kernel's bin 0 and Nyquist bin have exact
    zero imaginary parts. Every factor of the kernel's factored DFT is an
    entry of it."""
    angle = 2.0 * np.pi * np.arange(n_fft) / n_fft
    table = np.stack([np.cos(angle), -np.sin(angle)], axis=-1)
    table[np.abs(table) < 1e-12] = 0.0
    return torch.from_numpy(table.astype(np.float32)).to(device)


def window_bases(window: torch.Tensor):
    """The windowed DFT bases (n_fft, n_freq) of ``window``, JAX's
    ``_dft_bases`` for any window: window times cos and sin in float64,
    rounded once to float32, on the window's device."""
    cos, sin = _dft_angles(window.shape[0], window.device)
    w = window.double()[:, None]
    return (w * cos).float(), (w * sin).float()


def frame_signal(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, N) -> (B, frames, n_fft) with Whisper-style reflect padding."""
    pad = n_fft // 2
    audio = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    return audio.unfold(1, n_fft, hop)


def num_frames(n_samples: int, n_fft: int, hop: int) -> int:
    """Frames of an utterance of ``n_samples``, the last one dropped."""
    return (n_samples + 2 * (n_fft // 2) - n_fft) // hop


def power_mel_plain(audio, window, mel_w, hop: int = 160):
    """(B, N) float32 waveform -> (B, frames, n_mels) mel power: reflect
    padding, framing, the last frame dropped, then
    ``((x @ cos_b)^2 + (x @ sin_b)^2) @ mel_w`` in float32 with the bases of
    ``window_bases(window)``."""
    cos_b, sin_b = window_bases(window)
    frames = frame_signal(audio, cos_b.shape[0], hop)[:, :-1]
    real = torch.matmul(frames, cos_b)
    imag = torch.matmul(frames, sin_b)
    power = real * real + imag * imag
    return torch.matmul(power, mel_w)


# the kernel's factorings n_fft = P * Q (csrc/mel.cu instantiates these)
# and its largest filterbank
KERNEL_FACTORS = {256: (16, 16), 400: (20, 20), 512: (16, 32)}
_MAX_MELS = 128


def kernel_flops(n_fft: int, mel_w: torch.Tensor) -> int:
    """The kernel's float32 operations per frame: the P-point DFTs of the
    Q columns (k1 <= P / 2), the second stage's Q complex products per bin,
    the power, and the mel product over each filterbank column's span from
    its first to its last nonzero weight (the bins the kernel sums)."""
    P, Q = KERNEL_FACTORS[n_fft]
    n_freq = n_fft // 2 + 1
    nonzero = (mel_w != 0).cpu()
    bins = torch.arange(n_freq)[:, None]
    first = torch.where(nonzero, bins, n_freq).amin(0)
    last = torch.where(nonzero, bins, -1).amax(0)
    span = int((last - first + 1).clamp(min=0).sum())
    return 4 * Q * (P // 2 + 1) * P + 8 * Q * n_freq + 3 * n_freq + 2 * span


def _check(audio, window, mel_w, hop: int) -> None:
    tensors = (audio, window, mel_w)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("power_mel takes float32 tensors only, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if any(t.device != audio.device for t in tensors):
        raise ValueError("waveform, window and filterbank must lie on one "
                         "device")
    if audio.dim() != 2 or window.dim() != 1 or mel_w.dim() != 2:
        raise ValueError(f"expected audio (B, N), a window (n_fft,) and a "
                         f"filterbank (n_freq, n_mels), got "
                         f"{tuple(audio.shape)}, {tuple(window.shape)}, "
                         f"{tuple(mel_w.shape)}")
    n_fft = window.shape[0]
    if mel_w.shape[0] != n_fft // 2 + 1:
        raise ValueError(f"window of {n_fft} points and filterbank "
                         f"{tuple(mel_w.shape)} do not agree")
    if not 0 < hop:
        raise ValueError(f"hop must be positive, got {hop}")
    if audio.shape[1] <= n_fft // 2:
        raise ValueError(f"{audio.shape[1]} samples are too few to reflect-pad "
                         f"by {n_fft // 2}")


def _library():
    lib = cuda_build.load("mel")
    fn = lib.power_mel
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int64] + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mel_error_string.argtypes = [ctypes.c_int]
        lib.mel_error_string.restype = ctypes.c_char_p
    return lib


def power_mel(audio, window, mel_w, hop: int = 160):
    """(B, N) float32 waveform -> (B, frames, n_mels) float32 mel power, what
    JAX's ``_fused_power_mel`` computes from the frames, with the DFT of
    ``len(window)`` points of the windowed frames.

    On CUDA tensors this is one launch of the hand-written kernel, counted in
    ``power_mel.launches``; on CPU tensors it is ``power_mel_plain``."""
    _check(audio, window, mel_w, hop)
    if audio.device.type == "cpu":
        return power_mel_plain(audio, window, mel_w, hop)
    if audio.device.type != "cuda":
        raise ValueError(f"no kernel for device {audio.device}")
    n_fft = window.shape[0]
    n_mels = mel_w.shape[1]
    if n_fft not in KERNEL_FACTORS or n_mels > _MAX_MELS:
        raise ValueError(f"the mel kernel takes n_fft in "
                         f"{sorted(KERNEL_FACTORS)} and up to {_MAX_MELS} mel "
                         f"bins; got n_fft {n_fft}, n_mels {n_mels}")
    B, N = audio.shape
    T = num_frames(N, n_fft, hop)
    audio, window, mel_w = (t.contiguous() for t in (audio, window, mel_w))
    out = torch.empty(B, T, n_mels, dtype=torch.float32, device=audio.device)
    if B == 0 or T == 0:
        return out
    twiddle = _twiddles(n_fft, audio.device)
    lib = _library()
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.power_mel(
            audio.data_ptr(), window.data_ptr(), twiddle.data_ptr(),
            mel_w.data_ptr(), out.data_ptr(), B, N, n_fft, hop, n_mels, T,
            stream)
    if status != 0:
        raise RuntimeError("power_mel kernel failed: " +
                           lib.mel_error_string(status).decode())
    power_mel.launches += 1
    return out


power_mel.launches = 0


def log_mel_spectrogram(audio: torch.Tensor, sr: int = 16000,
                        n_fft: int = 400, hop: int = 160,
                        n_mels: int = 80) -> torch.Tensor:
    """(B, N) float waveform -> (B, frames, n_mels) Whisper-style log-mel.

    The last frame is dropped like Whisper (it corresponds to the final,
    incomplete hop). The clamp is to each utterance's own maximum over
    (frames, mels). JAX's ``use_pallas`` switch is gone: the device picks
    the route (``power_mel``)."""
    audio = audio.to(torch.float32)
    window, mel_w = _constants(sr, n_fft, n_mels, audio.device)
    mel = power_mel(audio, window, mel_w, hop)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec,
                             log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0
