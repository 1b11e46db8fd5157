"""In-place KV-cache slot write: one layer's new K and V into slot ``index``.

Port of pasero_tpu/ops/cache_update.py (the Pallas ``cache_slot_write``).
CUDA tensors go to the hand-written kernel of ``csrc/cache_update.cu``, CPU
tensors to ``cache_slot_write_plain``; a CUDA tensor never takes the plain
version: the kernel launches or the wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_DTYPES = (torch.bfloat16, torch.float32)


def cache_slot_write_plain(k_cache, v_cache, k_new, v_new, index: int):
    """``cache[:, :, index] = new[:, :, 0]`` for K and V, with ``new`` cast to
    the cache's type."""
    k_cache[:, :, index] = k_new[:, :, 0].to(k_cache.dtype)
    v_cache[:, :, index] = v_new[:, :, 0].to(v_cache.dtype)


def _check(k_cache, v_cache, k_new, v_new, index: int) -> None:
    if k_cache.device != v_cache.device or k_new.device != k_cache.device \
            or v_new.device != k_cache.device:
        raise ValueError("caches and new blocks must lie on one device")
    if k_cache.dtype not in _DTYPES or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"caches must both be bfloat16 or float32, got "
                        f"{k_cache.dtype} and {v_cache.dtype}")
    if not (k_new.is_floating_point() and v_new.is_floating_point()):
        raise TypeError("new K/V blocks must be floating point")
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches must be (B, H, L, D) of one shape, got "
                         f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    B, H, L, D = k_cache.shape
    if tuple(k_new.shape) != (B, H, 1, D) or tuple(v_new.shape) != (B, H, 1, D):
        raise ValueError(f"new blocks must be {(B, H, 1, D)}, got "
                         f"{tuple(k_new.shape)} and {tuple(v_new.shape)}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("caches must be contiguous (they are written in place)")
    if isinstance(index, bool) or not isinstance(index, int):
        raise TypeError(f"index must be a Python int, got {type(index)}")
    if not 0 <= index < L:
        raise IndexError(f"slot index {index} outside [0, {L})")


def _library():
    lib = cuda_build.load("cache_update")
    fn = lib.cache_slot_write
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.cache_update_error_string.argtypes = [ctypes.c_int]
        lib.cache_update_error_string.restype = ctypes.c_char_p
    return lib


def cache_slot_write_(k_cache, v_cache, k_new, v_new, index: int) -> None:
    """Write ``k_new``/``v_new`` (B, H, 1, D) into slot ``index`` of the
    contiguous (B, H, L, D) caches, in place.

    On CUDA tensors this is one launch of the hand-written kernel, counted in
    ``cache_slot_write_.launches``; on CPU tensors it is the plain version.
    """
    _check(k_cache, v_cache, k_new, v_new, index)
    if k_cache.device.type == "cpu":
        cache_slot_write_plain(k_cache, v_cache, k_new, v_new, index)
        return
    if k_cache.device.type != "cuda":
        raise ValueError(f"no kernel for device {k_cache.device}")
    # `new` usually comes from a transpose; the kernel reads it as a dense
    # (B, H, D) block, so copy it into that layout explicitly
    k_new = k_new.to(k_cache.dtype).contiguous()
    v_new = v_new.to(v_cache.dtype).contiguous()
    B, H, L, D = k_cache.shape
    lib = _library()
    with torch.cuda.device(k_cache.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.cache_slot_write(
            k_cache.data_ptr(), v_cache.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), B * H, L, D, k_cache.element_size(), index,
            stream)
    if status != 0:
        raise RuntimeError("cache_slot_write kernel failed: " +
                           lib.cache_update_error_string(status).decode())
    cache_slot_write_.launches += 1


cache_slot_write_.launches = 0
