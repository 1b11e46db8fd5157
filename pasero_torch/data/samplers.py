# Copy of pasero_tpu/data/samplers.py, verbatim.
"""Corpus and line samplers (pasero/datasets.py:236-512).

``CorpusSampler`` draws corpus ids multinomially with probability proportional
to size x multiplier, with language-pair temperature (T >= 100 means uniform
over language pairs) and optional fixed per-corpus probabilities.
``LineReader`` iterates a corpus in shuffled blocks of sequential reads and
optionally merges consecutive sentences into documents. All randomness flows
through an explicit numpy Generator so the pipeline can be made deterministic
per (host, epoch) — unlike the reference, which uses the global RNG.
"""

from __future__ import annotations

import itertools
import logging
import math
from collections import defaultdict
from typing import Iterator, Optional

import numpy as np

from .line_index import LineIndex

logger = logging.getLogger("data")


def _defined(x, default):
    return default if x is None else x


class CorpusSampler:
    def __init__(self, corpora, sizes, lang_temperature: float = 1.0,
                 rng: Optional[np.random.Generator] = None):
        self.corpora = list(corpora)
        self.rng = rng or np.random.default_rng()
        self.corpus_ids = np.arange(len(self.corpora))
        assert all(c.exists() for c in self.corpora), \
            "some training files do not exist or are empty"

        multipliers = np.array([_defined(c.multiplier, 1) for c in self.corpora])
        self.sizes = (np.asarray(sizes, dtype=np.int64) * multipliers).astype(np.int64)
        self.total_lines = int(self.sizes.sum())

        # corpora with fixed probabilities don't take part in temperature scaling
        free_sizes = np.array([0 if c.probability is not None else s
                               for c, s in zip(self.corpora, self.sizes)],
                              dtype=np.int64)

        if lang_temperature and lang_temperature != 1:
            per_lang: dict = defaultdict(lambda: (0, []))
            for cid, (size, corpus) in enumerate(zip(free_sizes, self.corpora)):
                total, ids = per_lang[tuple(corpus.langs)]
                per_lang[tuple(corpus.langs)] = (total + int(size), ids + [cid])
            uniform = lang_temperature >= 100
            if uniform:
                denom = sum(int(s > 0) for s, _ in per_lang.values())
            else:
                denom = sum(s ** (1 / lang_temperature) for s, _ in per_lang.values())
            probs = np.zeros(len(self.corpora))
            for size, ids in per_lang.values():
                p = (int(size > 0) if uniform else size ** (1 / lang_temperature)) / denom
                for cid in ids:
                    probs[cid] = p * free_sizes[cid] / max(1, size)
            self.probs = probs.astype(np.float64)
        else:
            self.probs = free_sizes / max(1, free_sizes.sum())

        fixed = np.array([_defined(c.probability, -1.0) for c in self.corpora])
        if (fixed != -1).any():
            has_fixed = fixed != -1
            remaining = 1 - fixed[has_fixed].sum()
            self.probs[has_fixed] = fixed[has_fixed]
            free = ~has_fixed
            self.probs[free] *= remaining / max(1, self.probs[free].sum())

        assert (self.probs >= 0).all()
        self.probs = self.probs / self.probs.sum()

        for corpus, prob, size in zip(self.corpora, self.probs, self.sizes):
            logger.info(f"{type(self).__name__} | {corpus} | prob {prob:.5f} | "
                        f"lines {size} ({size / max(1, self.total_lines):.3%})")

    def __iter__(self) -> Iterator[int]:
        while True:
            yield from self.rng.choice(self.corpus_ids, p=self.probs, size=1000)


class LineReader:
    """Shuffled block-sequential reads over one corpus; skips empty lines,
    shards blocks across workers, merges documents (datasets.py:388-512)."""

    def __init__(self, corpus, shuffle: bool = True,
                 line_index: Optional[LineIndex] = None,
                 store_files_under: Optional[int] = None,
                 shard_id: int = 0, shard_count: int = 1,
                 max_lines: Optional[int] = None, endless: bool = True,
                 close_files: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.shuffle = shuffle
        self.endless = endless
        self.close_files = close_files
        self.max_doc_size = getattr(corpus, "max_doc_size", 1)
        self.corpus = corpus
        self.rng = rng or np.random.default_rng()

        self.files = corpus.open_files(store_files_under=store_files_under)
        if close_files:
            for f in self.files:
                f.close()
        if line_index is None:
            line_index = LineIndex([corpus])
        self.blocks, self.block_size, self.size, _ = line_index[corpus]

        self.block_indices = np.arange(len(self.blocks))
        self.block_sizes = np.full(len(self.blocks), self.block_size)
        self.block_sizes[-1] = self.size - self.block_sizes[:-1].sum()
        assert self.block_sizes[-1] > 0

        if max_lines:
            num_blocks = math.ceil(max_lines / self.block_size)
            self.block_indices = self.block_indices[:num_blocks]
            self.blocks = self.blocks[:num_blocks]
            self.block_sizes = self.block_sizes[:num_blocks]
            self.size = min(int(self.block_sizes.sum()), max_lines)
            self.block_sizes[-1] = self.size - self.block_sizes[:-1].sum()
            assert self.block_sizes[-1] > 0

        if shard_count > 1:
            num_blocks = len(self.block_indices) // shard_count
            if shuffle:  # all workers derive the same permutation from the seed
                shard_rng = np.random.default_rng(12345)
                shard_rng.shuffle(self.block_indices)
            lo = shard_id * num_blocks
            hi = None if shard_id == shard_count - 1 else lo + num_blocks
            self.block_indices = self.block_indices[lo:hi]
        assert len(self.block_indices) > 0, (
            "some file shards are empty (tiny corpus across too many workers): "
            "reduce worker count")
        self._iter = iter(self)

    def __next__(self):
        try:
            return next(self._iter)
        except StopIteration:
            if not self.endless:
                raise
            self._iter = iter(self)
            return next(self._iter)

    def __iter__(self):
        order = (self.rng.permutation(self.block_indices) if self.shuffle
                 else self.block_indices)
        for block_id in order:
            for pos, f in zip(self.blocks[block_id], self.files):
                f.seek(pos)
            block = []
            while len(block) < self.block_sizes[block_id]:
                line_tuple = tuple(next(f) for f in self.files)
                if all(len(line) > 0 for line in line_tuple):
                    block.append(line_tuple)
            if self.close_files:
                for f in self.files:
                    f.close()
            if self.max_doc_size > 1:
                it = iter(block)
                while True:
                    doc_size = int(self.rng.integers(1, self.max_doc_size + 1))
                    tuples = list(itertools.islice(it, doc_size))
                    if not tuples:
                        break
                    yield self.corpus.tuple_to_dict(self._merge(tuples))
            else:
                for line_tuple in block:
                    yield self.corpus.tuple_to_dict(line_tuple)

    @staticmethod
    def _merge(line_tuples):
        if len(line_tuples) == 1:
            return line_tuples[0]
        return tuple(lines for lines in zip(*line_tuples))


class LineSampler(CorpusSampler):
    """Infinite sampler over several corpora: pick a corpus, read its next line."""

    def __init__(self, corpora, line_index: LineIndex,
                 lang_temperature: float = 1.0,
                 store_files_under: Optional[int] = None, shuffle: bool = True,
                 shard_id: int = 0, shard_count: int = 1,
                 max_lines: Optional[int] = None, close_files: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.readers = [
            LineReader(corpus, line_index=line_index,
                       store_files_under=store_files_under, shuffle=shuffle,
                       shard_id=shard_id, shard_count=shard_count,
                       max_lines=max_lines, close_files=close_files, rng=rng)
            for corpus in corpora
        ]
        sizes = [r.size for r in self.readers]
        super().__init__(corpora, sizes, lang_temperature=lang_temperature, rng=rng)

    def __iter__(self):
        for corpus_id in super().__iter__():
            yield next(self.readers[corpus_id])
