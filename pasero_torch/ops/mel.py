"""Log-mel spectrogram frontend: windowed DFT, power and mel filterbank.

Port of pasero_tpu/ops/mel.py. The filterbank and the windowed DFT bases are
that module's numpy code, copied; framing and the log/clamp/scale steps are
its arithmetic in PyTorch. Whisper's parameters: n_fft 400, hop 160, 80 or
128 Slaney mel bins, log10 clamped to the utterance's maximum - 8, then
(x + 4) / 4.

The fused step, frames -> DFT -> power -> mel (JAX's ``_fused_power_mel``),
is ``power_mel``. CPU tensors take ``power_mel_plain``; CUDA tensors launch
the hand-written kernel of ``csrc/mel.cu``, which reads the waveform itself
(reflect padding by index) and keeps the power spectrum on the chip. A CUDA
tensor never takes the plain version: the kernel launches or the wrapper
raises. Its launches are counted in ``power_mel.launches``. The route follows
the device, so ``log_mel_spectrogram`` has no ``use_pallas`` switch: on the
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
def _dft_bases(n_fft: int):
    """Windowed DFT bases (n_fft, n_freq) for the real/imag parts."""
    n_freq = n_fft // 2 + 1
    window = hann_window(n_fft)
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_freq)[None, :]
    angle = -2.0 * np.pi * t * k / n_fft
    cos_b = (window[:, None] * np.cos(angle)).astype(np.float32)
    sin_b = (window[:, None] * np.sin(angle)).astype(np.float32)
    return cos_b, sin_b


@functools.lru_cache(maxsize=16)
def _constants(sr: int, n_fft: int, n_mels: int, device: torch.device):
    """(cos_b, sin_b, mel_w) as float32 tensors on ``device``."""
    cos_b, sin_b = _dft_bases(n_fft)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (cos_b, sin_b, mel_filterbank(sr, n_fft, n_mels)))


def frame_signal(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, N) -> (B, frames, n_fft) with Whisper-style reflect padding."""
    pad = n_fft // 2
    audio = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    return audio.unfold(1, n_fft, hop)


def num_frames(n_samples: int, n_fft: int, hop: int) -> int:
    """Frames of an utterance of ``n_samples``, the last one dropped."""
    return (n_samples + 2 * (n_fft // 2) - n_fft) // hop


def power_mel_plain(audio, cos_b, sin_b, mel_w, hop: int = 160):
    """(B, N) float32 waveform -> (B, frames, n_mels) mel power: reflect
    padding, framing, the last frame dropped, then
    ``((x @ cos_b)^2 + (x @ sin_b)^2) @ mel_w`` in float32."""
    frames = frame_signal(audio, cos_b.shape[0], hop)[:, :-1]
    real = torch.matmul(frames, cos_b)
    imag = torch.matmul(frames, sin_b)
    power = real * real + imag * imag
    return torch.matmul(power, mel_w)


# the kernel's tiling (csrc/mel.cu): 224 frequency columns, 128 mel columns,
# and the shared memory of a block within the card's 227 KB
_MAX_FREQ = 224
_MAX_MELS = 128
_MAX_SMEM = 232448


def _check(audio, cos_b, sin_b, mel_w, hop: int) -> None:
    tensors = (audio, cos_b, sin_b, mel_w)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("power_mel takes float32 tensors only, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if any(t.device != audio.device for t in tensors):
        raise ValueError("waveform, bases and filterbank must lie on one device")
    if audio.dim() != 2 or cos_b.dim() != 2 or mel_w.dim() != 2:
        raise ValueError(f"expected audio (B, N), bases (n_fft, n_freq) and "
                         f"filterbank (n_freq, n_mels), got {tuple(audio.shape)}"
                         f", {tuple(cos_b.shape)}, {tuple(mel_w.shape)}")
    n_fft, n_freq = cos_b.shape
    if tuple(sin_b.shape) != (n_fft, n_freq) or mel_w.shape[0] != n_freq:
        raise ValueError(f"bases {tuple(cos_b.shape)} / {tuple(sin_b.shape)} "
                         f"and filterbank {tuple(mel_w.shape)} do not agree")
    if not 0 < hop:
        raise ValueError(f"hop must be positive, got {hop}")
    if audio.shape[1] <= n_fft // 2:
        raise ValueError(f"{audio.shape[1]} samples are too few to reflect-pad "
                         f"by {n_fft // 2}")


def _smem_layout(n_fft: int, hop: int) -> tuple:
    """(strip floats, shared-memory bytes) of one block: the waveform strip
    of 64 frames, two 16-row basis chunks and the 64 x 225 power tile."""
    strip = 63 * hop + -(-n_fft // 16) * 16
    region = strip + 2 * 16 * _MAX_FREQ
    return strip, 4 * (region + 64 * (_MAX_FREQ + 1))


def _library():
    lib = cuda_build.load("mel")
    fn = lib.power_mel
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int64] + \
            [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mel_error_string.argtypes = [ctypes.c_int]
        lib.mel_error_string.restype = ctypes.c_char_p
    return lib


def power_mel(audio, cos_b, sin_b, mel_w, hop: int = 160):
    """(B, N) float32 waveform -> (B, frames, n_mels) float32 mel power, what
    JAX's ``_fused_power_mel`` computes from the frames.

    On CUDA tensors this is one launch of the hand-written kernel, counted in
    ``power_mel.launches``; on CPU tensors it is ``power_mel_plain``."""
    _check(audio, cos_b, sin_b, mel_w, hop)
    if audio.device.type == "cpu":
        return power_mel_plain(audio, cos_b, sin_b, mel_w, hop)
    if audio.device.type != "cuda":
        raise ValueError(f"no kernel for device {audio.device}")
    n_fft, n_freq = cos_b.shape
    n_mels = mel_w.shape[1]
    strip, smem = _smem_layout(n_fft, hop)
    if n_freq > _MAX_FREQ or n_mels > _MAX_MELS or smem > _MAX_SMEM:
        raise ValueError(f"the mel kernel takes up to {_MAX_FREQ} frequencies "
                         f"and {_MAX_MELS} mel bins in {_MAX_SMEM} bytes of "
                         f"shared memory; got n_freq {n_freq}, n_mels {n_mels}"
                         f", {smem} bytes")
    B, N = audio.shape
    T = num_frames(N, n_fft, hop)
    audio, cos_b, sin_b, mel_w = (t.contiguous()
                                  for t in (audio, cos_b, sin_b, mel_w))
    out = torch.empty(B, T, n_mels, dtype=torch.float32, device=audio.device)
    if B == 0 or T == 0:
        return out
    lib = _library()
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.power_mel(
            audio.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(),
            mel_w.data_ptr(), out.data_ptr(), B, N, n_fft, hop, n_freq,
            n_mels, T, strip, smem, stream)
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
    cos_b, sin_b, mel_w = _constants(sr, n_fft, n_mels, audio.device)
    mel = power_mel(audio, cos_b, sin_b, mel_w, hop)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec,
                             log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0
