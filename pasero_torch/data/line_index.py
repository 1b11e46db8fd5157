# Copy of pasero_tpu/data/line_index.py, verbatim.
"""Block-based line index over training corpora.

Lines are grouped into blocks of ``block_size`` (default 256) whose start
positions are stored; sampling picks blocks and reads them sequentially
(pasero/datasets.py:59-233). The index is cached on disk (pickle, not
torch.save) and invalidated by corpus mtime. In the TPU build there is no NCCL
object broadcast: every host builds or loads the index itself (the cache file
makes this cheap), matching per-host input pipelines.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Optional

import numpy as np

logger = logging.getLogger("data")


class LineIndex:
    def __init__(self, corpora, block_size: int = 256,
                 index_path: Optional[str] = None, save_index: bool = True,
                 reset: bool = False):
        self.block_size = block_size
        self.index: dict = {}
        self.changed = False
        self.index_path = index_path

        if index_path is not None and not reset:
            self.load()
        for corpus in corpora:
            self.index_corpus(corpus)
        if index_path is not None and save_index:
            self.save()

        relevant = {tuple(sorted(c.realpaths)) for c in corpora}
        self.index = {k: v for k, v in self.index.items() if k in relevant}

    def __getitem__(self, corpus):
        paths = tuple(corpus.realpaths)
        order = np.argsort(paths)
        sorted_paths = tuple(np.array(paths)[order])
        blocks, block_size, size, mtime = self.index[sorted_paths]
        inverse = np.argsort(order)
        return blocks[:, inverse], block_size, size, mtime

    def index_corpus(self, corpus) -> None:
        paths = tuple(corpus.realpaths)
        corpus_mtime = corpus.getmtime()
        try:
            *_, index_mtime = self[corpus]
            if corpus_mtime <= index_mtime:
                return
            logger.info(f"index for {corpus} is outdated")
        except KeyError:
            pass

        logger.info(f"indexing {corpus}")
        files = corpus.open_files()
        order = np.argsort(paths)
        sorted_paths = [paths[i] for i in order]
        files = [files[i] for i in order]

        positions, lengths = [], []
        for f in files:
            p, l = f.get_positions()
            positions.append(p)
            lengths.append(l)
        assert len({len(p) for p in positions}) == 1, \
            f"source/target line-count mismatch in corpus {corpus}"

        blocks = []
        size = in_block = 0
        block_start = None
        for pos_tuple, len_tuple in zip(zip(*positions), zip(*lengths)):
            if not all(len_tuple):  # skip tuples with an empty side
                continue
            if in_block == 0:
                block_start = pos_tuple
            size += 1
            in_block += 1
            if in_block == self.block_size:
                blocks.append(block_start)
                in_block = 0
        if in_block:
            blocks.append(block_start)
        for f in files:
            f.close()

        self.index[tuple(sorted_paths)] = (np.array(blocks), self.block_size,
                                           size, corpus_mtime)
        self.changed = True

    def load(self) -> None:
        if not self.index_path or not os.path.exists(self.index_path):
            return
        try:
            with open(self.index_path, "rb") as f:
                raw = pickle.load(f)
        except Exception:
            logger.warning(f"could not read line index at {self.index_path}")
            return
        self.index = {}
        for paths, value in raw.items():
            try:
                blocks, block_size, size, mtime = value
                assert (list(paths) == sorted(paths)
                        and all(os.path.exists(p) for p in paths)
                        and isinstance(blocks, np.ndarray)
                        and block_size > 0 and size > 0 and mtime > 0)
                self.index[tuple(map(os.path.realpath, paths))] = value
            except Exception:
                self.changed = True

    def save(self) -> None:
        if not self.changed or not self.index_path:
            return
        try:
            index_dir = os.path.dirname(self.index_path)
            if index_dir:
                os.makedirs(index_dir, exist_ok=True)
            # atomic write: multi-host runs may build the index concurrently
            # on a shared filesystem; readers must never see a partial file
            tmp = f"{self.index_path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(self.index, f)
            os.replace(tmp, self.index_path)
            self.changed = False
        except OSError:
            logger.warning(f"could not save line index at {self.index_path}")

    @classmethod
    def build(cls, cfg, corpora) -> "LineIndex":
        return cls(corpora, index_path=cfg.line_index_path,
                   reset=cfg.reset_line_index, save_index=cfg.cache_line_index,
                   block_size=cfg.block_size or 256)
