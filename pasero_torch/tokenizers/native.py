# Copy of pasero_tpu/tokenizers/native.py, verbatim.
"""ctypes bindings for the C++ BPE merge core (native/bpe_core.cpp).

Loaded lazily; if the shared library is missing (or `make -C native` was never
run), the tokenizer falls back to the pure-python merge loop transparently.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional

logger = logging.getLogger("tokenizer")

_LIB = None
_LIB_FAILED = False


def _lib_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "native", "libbpe_core.so")


def load_library():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    path = _lib_path()
    if not os.path.exists(path):
        # best-effort build (the toolchain is available in the image)
        try:
            subprocess.run(["make", "-C", os.path.dirname(path)], check=True,
                           capture_output=True, timeout=60)
        except Exception:
            _LIB_FAILED = True
            return None
    try:
        lib = ctypes.CDLL(path)
        lib.bpe_new.restype = ctypes.c_void_p
        lib.bpe_new.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
        lib.bpe_free.argtypes = [ctypes.c_void_p]
        lib.bpe_encode_word.restype = ctypes.c_int64
        lib.bpe_encode_word.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64]
        _LIB = lib
    except OSError as e:
        logger.warning(f"could not load the native BPE core: {e}")
        _LIB_FAILED = True
    return _LIB


class NativeBPE:
    """One native model instance per tokenizer (ranks = merge order)."""

    def __init__(self, merges: list):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native BPE core unavailable")
        self._lib = lib
        blob = b"".join(left.encode() + b"\0" + right.encode() + b"\0"
                        for left, right in merges)
        self._handle = lib.bpe_new(blob, len(blob), len(merges))
        self._buf = ctypes.create_string_buffer(1 << 16)

    def encode_word(self, word: str) -> Optional[list]:
        data = word.encode()
        n = self._lib.bpe_encode_word(self._handle, data, len(data),
                                      self._buf, len(self._buf))
        if n < 0:  # extremely long word: let the python path handle it
            return None
        return self._buf.raw[:n].decode().split("\n") if n else []

    def __del__(self):
        try:
            self._lib.bpe_free(self._handle)
        except Exception:
            pass
