# Copy of pasero_tpu/data/files.py, verbatim.
"""Streaming record readers: text lines, JSONL, and the binary feature format.

Keeps on-disk compatibility with the reference's file formats
(pasero/files.py): the 'numpy' feature format is a pickled metadata block
``{positions, lengths, dim, dtype}`` followed by the raw ``tobytes()``
payload of each array (np.save/np.load per record is far too slow for
speech-feature streaming). Implementation is this repo's own:

- formats self-register through ``__init_subclass__`` (keyed by
  ``format_name``), so ``File.open(path, format=...)`` needs no hand-kept
  table;
- each reader owns a lazily (re)opened byte stream: ``close()`` remembers
  where reading stopped and the next read transparently reopens there, which
  lets dataset readers drop file descriptors between epochs. Files at most
  ``store_files_under`` bytes are pinned in RAM instead of re-read from disk;
- NumpyFile addresses records by explicit index->offset seeks (its
  ``seek``/``tell`` speak record indices, not bytes).
"""

from __future__ import annotations

import io
import json
import os
import pickle
from typing import Iterable, Iterator, Optional

import numpy as np

_FORMATS: dict = {}


class File:
    """Line-oriented reader with byte-offset random access.

    Iterating yields stripped, decoded lines. ``seek``/``tell`` use byte
    offsets (except NumpyFile, which uses record indices).
    """

    format_name = "txt"

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        name = cls.__dict__.get("format_name")
        if name:
            _FORMATS[name] = cls

    def __init__(self, path: str, store_files_under: Optional[int] = None):
        self._path = path
        self._resume_at = 0
        self._pinned: Optional[bytes] = None
        if store_files_under and os.path.getsize(path) <= store_files_under:
            with open(path, "rb") as f:
                self._pinned = f.read()
        self._stream = self._make_stream()

    # -- factory -------------------------------------------------------------
    @classmethod
    def get_formats(cls) -> dict:
        return dict(_FORMATS)

    @classmethod
    def open(cls, path: str, *args, format: str = "txt", **kwargs) -> "File":
        return _FORMATS.get(format, File)(path, *args, **kwargs)

    # -- stream lifecycle ----------------------------------------------------
    def _make_stream(self):
        stream = (io.BytesIO(self._pinned) if self._pinned is not None
                  else open(self._path, "rb"))
        stream.seek(self._resume_at)
        return stream

    def _live(self):
        if self._stream.closed:
            self._stream = self._make_stream()
        return self._stream

    def close(self):
        if not self._stream.closed:
            self._resume_at = self._stream.tell()
            if self._pinned is None:  # keep pinned buffers; no fd to release
                self._stream.close()

    def seek(self, offset, whence=0):
        self._resume_at = offset
        self._live().seek(offset, whence)

    def tell(self) -> int:
        return self._live().tell()

    # -- records -------------------------------------------------------------
    def __next__(self) -> str:
        raw = self._live().readline()
        if not raw:
            raise StopIteration
        return raw.strip().decode()

    def __iter__(self) -> Iterator:
        while True:
            try:
                yield next(self)
            except StopIteration:
                return

    def get_positions(self) -> tuple:
        """(byte offset, decoded length) of every line — a full pass."""
        stream = self._live()
        origin = stream.tell()
        stream.seek(0)
        offsets, sizes = [], []
        at = 0
        for raw in iter(stream.readline, b""):
            offsets.append(at)
            sizes.append(len(raw.strip().decode()))
            at = stream.tell()
        stream.seek(origin)
        return (np.asarray(offsets, dtype=np.int64),
                np.asarray(sizes, dtype=np.int64))


class JSONLFile(File):
    format_name = "jsonl"

    def __next__(self):
        return json.loads(File.__next__(self))


def _feature_header(positions: np.ndarray, lengths: np.ndarray, dim: int,
                    dtype: str) -> dict:
    # fixed-size fields only: the serialized header must not change length
    # between the placeholder and the final rewrite in NumpyFile.build
    return {"positions": positions, "lengths": lengths,
            "dim": np.array(dim, dtype=np.int64), "dtype": dtype}


class NumpyFile(File):
    """Indexed feature matrices; ``seek``/``tell``/positions are record
    indices. Entries whose stored offset is 0 were never written (build was
    given an over-estimated record count) and are skipped."""

    format_name = "numpy"

    def __init__(self, path: str, store_files_under: Optional[int] = None):
        super().__init__(path, store_files_under=store_files_under)
        stream = self._live()
        stream.seek(0)
        meta = pickle.load(stream)
        written = np.asarray(meta["positions"], dtype=np.int64)
        valid = written > 0
        self._offsets = written[valid]
        self._sizes = np.asarray(meta["lengths"], dtype=np.int64)[valid]
        self._width = int(meta["dim"])
        self._dtype = np.dtype(meta["dtype"])
        self._record_bytes = max(self._width, 1) * self._dtype.itemsize
        self._cursor = 0

    @classmethod
    def build(cls, path: str, features: Iterable[np.ndarray],
              dtype: str = "float16",
              num_feats: Optional[int] = None) -> "NumpyFile":
        """Stream ``features`` to disk; rewrites the fixed-size header with
        real offsets once the payload is written."""
        if num_feats is None:
            assert hasattr(features, "__len__"), \
                "pass num_feats when building from a generator"
            num_feats = len(features)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        offsets = np.zeros(num_feats, dtype=np.int64)
        sizes = np.zeros(num_feats, dtype=np.int64)
        width = 0
        with open(path, "wb") as f:
            pickle.dump(_feature_header(offsets, sizes, width, dtype), f)
            for i, feat in enumerate(features):
                feat = np.asarray(feat).astype(dtype)
                offsets[i] = f.tell()
                sizes[i] = feat.shape[0]
                width = feat.shape[1] if feat.ndim > 1 else 0
                f.write(feat.tobytes())
            f.seek(0)
            pickle.dump(_feature_header(offsets, sizes, width, dtype), f)
        return cls(path)

    def __len__(self) -> int:
        return len(self._offsets)

    def get_positions(self):
        return np.arange(len(self._offsets)), self._sizes

    def __next__(self) -> np.ndarray:
        if self._cursor >= len(self._offsets):
            raise StopIteration
        stream = self._live()
        stream.seek(int(self._offsets[self._cursor]))
        n = int(self._sizes[self._cursor])
        payload = stream.read(n * self._record_bytes)
        arr = np.frombuffer(payload, dtype=self._dtype).copy()
        self._cursor += 1
        return arr.reshape(n, self._width) if self._width > 1 else arr

    def close(self):
        if not self._stream.closed and self._pinned is None:
            self._stream.close()

    def seek(self, index, whence=0):
        self._cursor = int(index)

    def tell(self) -> int:
        return self._cursor
