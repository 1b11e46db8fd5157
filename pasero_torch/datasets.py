# Copy of pasero_tpu/datasets.py; only the multi-host sharded mode differs: it raises not_ported.
"""Training and validation datasets: the host-side input pipeline.

Re-design of pasero/datasets.py:515-1147 for per-host TPU feeding:

- the reference's process tree (reader proc -> tokenizer workers -> batcher ->
  per-GPU mp.Queues, datasets.py:794-964) becomes: a reader thread feeding
  ``--num-workers`` spawn-context tokenizer processes (order-preserving imap
  with bounded in-flight work), whose output streams into a batcher thread
  and a bounded prefetch queue.  Workers never import JAX — the task is
  pickled into them once at startup;
- a telemetry thread logs queue depths, skipped %, throughput and host RSS
  every ``--telemetry-interval`` seconds (reference datasets.py:811-832);
- ``--cache-data`` keeps preprocessed samples in host memory up to
  ``--max-cache-size`` GiB for small/speech datasets
  (reference datasets.py:975-1143);
- batches are length-sorted inside a large buffer then token-budget batched
  (same buffered_batching semantics incl. --batch-by homogeneous grouping,
  datasets.py:708-730), and padded to bucketed shapes for XLA;
- ValidationDataset preprocesses once and yields deterministic batches,
  sharded round-robin with dummy batches for DP lockstep
  (datasets.py:515-607).
"""

from __future__ import annotations

import logging
import pickle
import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np

from .config import register_dataset
from .data.line_index import LineIndex
from .data.samplers import LineSampler
from .utils.metrics import Metrics

logger = logging.getLogger("data")


# -- tokenizer worker processes (module-level for picklability) --------------

_WORKER_TASK = None
_WORKER_TRUNCATE = False


def _worker_init(task_blob: bytes, truncate: bool) -> None:
    global _WORKER_TASK, _WORKER_TRUNCATE
    _WORKER_TASK = pickle.loads(task_blob)
    _WORKER_TRUNCATE = truncate


def _worker_preprocess(raw: dict):
    return _WORKER_TASK.preprocess(raw, truncate=_WORKER_TRUNCATE,
                                   append_eos=True) or None


def _sample_tokens(sample: dict) -> int:
    n = 0
    for key in ("decoder_input", "encoder_input", "source", "target"):
        value = sample.get(key)
        if hasattr(value, "__len__"):
            n += len(value)
    return n


def _cache_key(raw: dict):
    parts = []
    for key in sorted(raw):
        value = raw[key]
        if isinstance(value, np.ndarray):
            parts.append((key, value.shape, str(value.dtype),
                          hash(value.tobytes())))
        elif isinstance(value, dict):
            parts.append((key, tuple(sorted(value.items()))))
        else:
            parts.append((key, value))
    return tuple(parts)


def _sample_nbytes(sample: dict) -> int:
    n = 0
    for value in sample.values():
        if isinstance(value, np.ndarray):
            n += value.nbytes
        elif isinstance(value, (str, bytes)):
            n += len(value)
        else:
            n += 64
    return n


def batch_sort_key(batch_by, sample) -> tuple:
    meta = sample.get("meta", {})
    key = tuple(meta.get(k) for k in batch_by or ())
    # multimodal batches must also be homogeneous in dtype/rank
    enc = sample.get("encoder_input")
    if enc is not None:
        key += (enc.ndim, str(enc.dtype))
    return key


class TrainingDatasetBase:
    def __init__(self, cfg, dist_cfg, task, corpora, rng=None):
        self.cfg = cfg
        self.dist_cfg = dist_cfg
        self.task = task
        self.corpora = corpora
        self.rng = rng or np.random.default_rng(dist_cfg.seed)
        # multi-host 'sharded' input mode: this process samples a disjoint
        # stream (its own seed) and emits 1/num_processes of every global
        # batch, fixed-shape so all hosts agree without coordinating
        # (replaces the reference's batch broadcast, utils.py:146-172)
        self._host_shard = None
        if getattr(dist_cfg, "per_host_data", "replicated") == "sharded":
            from . import not_ported
            raise not_ported("per-host sharded data (--per-host-data "
                             "sharded)", "A.12 parallelism")
        self.metrics = Metrics(window=None)
        # pipeline statistics, read by the telemetry thread
        self.skipped = 0
        self.samples_out = 0
        self.tokens_out = 0
        self.cache_hits = 0
        self._cache: dict = {}
        self._cache_bytes = 0
        self._cache_full = False
        self._cache_cap = (int(getattr(cfg, "max_cache_size", 0) * 2 ** 30)
                           if getattr(cfg, "cache_data", False) else 0)
        task.register_corpora(*corpora)

    def _raw_stream(self) -> Iterator[dict]:
        index = LineIndex.build(self.cfg, self.corpora)
        sampler = LineSampler(
            self.corpora, index, lang_temperature=self.cfg.lang_temperature,
            store_files_under=self.cfg.store_files_under,
            shuffle=self.cfg.shuffle, max_lines=self.cfg.max_lines,
            close_files=self.cfg.close_files, rng=self.rng)
        yield from sampler

    def _count(self, sample: Optional[dict]) -> Optional[dict]:
        """Track pipeline statistics; returns the sample (None if skipped)."""
        if not sample:
            self.skipped += 1
            if self.skipped % 10000 == 0:
                logger.info(
                    f"skipped {self.skipped} too-long/filtered samples")
            return None
        self.samples_out += 1
        self.tokens_out += _sample_tokens(sample)
        return sample

    def _preprocess_cached(self, raw: dict) -> Optional[dict]:
        """Preprocess with the GiB-capped in-memory sample cache
        (--cache-data, reference datasets.py:975-1143)."""
        key = _cache_key(raw)
        sample = self._cache.get(key)
        if sample is not None:
            self.cache_hits += 1
            return dict(sample) if sample else None
        sample = self.task.preprocess(raw, truncate=self.cfg.truncate,
                                      append_eos=True)
        size = _sample_nbytes(sample) if sample else 64
        if self._cache_bytes + size <= self._cache_cap:
            self._cache[key] = sample or {}
            self._cache_bytes += size
        elif not self._cache_full:
            self._cache_full = True
            logger.info(f"preprocessed-sample cache is full "
                        f"({self._cache_bytes / 2**30:.2f} GiB, "
                        f"{len(self._cache)} samples)")
        return sample

    def _sample_stream(self) -> Iterator[dict]:
        for raw in self._raw_stream():
            if self._cache_cap:
                sample = self._preprocess_cached(raw)
            else:
                sample = self.task.preprocess(
                    raw, truncate=self.cfg.truncate, append_eos=True)
            if self._count(sample):
                yield sample

    def _batched_stream(self) -> Iterator[dict]:
        """buffer -> (group by batch_by) -> length-sort -> token-budget batches."""
        buffer: list = []
        for sample in self._sample_stream():
            buffer.append(sample)
            if len(buffer) < self.cfg.buffer_size:
                continue
            yield from self._flush(buffer)
            buffer = []

    def _flush(self, buffer: list) -> Iterator[dict]:
        if self._host_shard is not None:
            yield from self._flush_fixed_shape(buffer)
            return
        groups: dict = {}
        for sample in buffer:
            groups.setdefault(batch_sort_key(self.cfg.batch_by, sample),
                              []).append(sample)
        all_batches = []
        for group in groups.values():
            all_batches += self.task.build_batches(group, shuffle=True,
                                                   rng=self.rng)
        if self.cfg.shuffle:
            order = self.rng.permutation(len(all_batches))
        else:
            order = np.arange(len(all_batches))
        for i in order:
            batch = self.task.collate(all_batches[i])
            if batch is not None:
                yield batch

    def _fixed_rows(self) -> int:
        """Rows per host-local batch in 'sharded' mode: the local token
        budget at the maximum padded length, a multiple of 8."""
        task = self.task
        _, n = self._host_shard
        max_len = task.cfg_max_target_len()
        if task.model_type == "encoder_decoder":
            max_len = max(max_len, task.cfg_max_source_len())
        rows = (task.cfg.batch_size // n) // max_len
        return max(8, rows // 8 * 8)

    def _flush_fixed_shape(self, buffer: list) -> Iterator[dict]:
        """Fixed-shape local batches for the multi-host 'sharded' mode:
        constant row count, every sequence padded to the max bucket.
        Incomplete tail chunks are dropped (bounded waste per flush)."""
        rows = self._fixed_rows()
        groups: dict = {}
        for sample in buffer:
            groups.setdefault(batch_sort_key(self.cfg.batch_by, sample),
                              []).append(sample)
        chunks = []
        for group in groups.values():
            order = (self.rng.permutation(len(group)) if self.cfg.shuffle
                     else np.arange(len(group)))
            for start in range(0, len(group) - rows + 1, rows):
                chunks.append([group[i] for i in order[start:start + rows]])
        if self.cfg.shuffle:
            self.rng.shuffle(chunks)
        for chunk in chunks:
            batch = self.task.collate(chunk, rows_multiple=rows,
                                      fixed_len=True)
            if batch is not None:
                batch["_local_rows"] = True
                yield batch

    def endless_iterator(self) -> Iterator[dict]:
        raise NotImplementedError


@register_dataset("simple")
@register_dataset("debug")
class DebugTrainingDataset(TrainingDatasetBase):
    """Synchronous pipeline — breakpoint-friendly (--debug,
    pasero/config.py:1730-1732)."""

    def endless_iterator(self) -> Iterator[dict]:
        while True:
            yield from self._batched_stream()


@register_dataset("dynamic")
class DynamicTrainingDataset(TrainingDatasetBase):
    """reader thread -> N tokenizer worker processes -> batcher thread ->
    bounded prefetch queue (reference process tree, datasets.py:794-964).

    The worker pool uses the spawn context (JAX in the parent makes fork
    unsafe) and order-preserving ``imap`` with a bounded number of in-flight
    samples, so the batch stream is identical to the single-threaded
    pipeline whenever preprocessing is deterministic."""

    QUEUE_SIZE = 16
    MAX_INFLIGHT_PER_WORKER = 128
    IMAP_CHUNK = 16          # samples per IPC message to/from pool workers

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._queue: queue.Queue = queue.Queue(maxsize=self.QUEUE_SIZE)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._telemetry_thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pool = None

    def _sample_stream(self) -> Iterator[dict]:
        import os
        workers = getattr(self.cfg, "num_workers", 0) or 0
        # worker processes only help when there are spare cores; on small
        # hosts fall back to inline preprocessing (saves the IPC overhead).
        # PASERO_FORCE_WORKERS bypasses the clamp (tests prove the pool's
        # order preservation and shutdown even on a 1-core host)
        forced = os.environ.get("PASERO_FORCE_WORKERS")
        if forced:
            workers = int(forced)
        else:
            workers = min(workers, max((os.cpu_count() or 1) - 1, 0))
        if workers <= 0:
            yield from super()._sample_stream()
            return
        if self._pool is None:
            import multiprocessing as mp
            ctx = mp.get_context("spawn")
            self._pool = ctx.Pool(
                workers, initializer=_worker_init,
                initargs=(pickle.dumps(self.task), self.cfg.truncate))
            logger.info(f"started {workers} tokenizer worker processes")
        # floor: the budget must exceed imap's chunk size or the first
        # chunk can never fill and the pipeline deadlocks at startup
        inflight = self._inflight = threading.Semaphore(
            max(workers * self.MAX_INFLIGHT_PER_WORKER, 2 * self.IMAP_CHUNK))

        def feed():
            # runs on the pool's task-handler thread. The acquire must stay
            # interruptible: when training stops mid-stream the consumer
            # never releases again, and an uninterruptible blocked acquire
            # here deadlocks multiprocessing's atexit _terminate_pool join
            # (the process then hangs at interpreter exit)
            for raw in self._raw_stream():
                while not self._stop.is_set():
                    if inflight.acquire(timeout=1.0):
                        break
                if self._stop.is_set():
                    return
                yield raw

        for sample in self._pool.imap(_worker_preprocess, feed(),
                                      chunksize=self.IMAP_CHUNK):
            inflight.release()
            if self._count(sample):
                yield sample

    def _worker(self):
        try:
            while not self._stop.is_set():
                for batch in self._batched_stream():
                    if self._stop.is_set():
                        return
                    self._queue.put(batch)
        except BaseException as e:  # propagate pipeline crashes to the consumer
            self._error = e
            self._queue.put(None)

    def _telemetry(self, interval: float):
        """Periodic pipeline statistics (reference datasets.py:811-832)."""
        import resource
        prev_samples = prev_tokens = 0
        prev_time = time.monotonic()
        while not self._stop.wait(interval):
            now = time.monotonic()
            dt = max(now - prev_time, 1e-6)
            samples = self.samples_out
            tokens = self.tokens_out
            total = samples + self.skipped
            rss_gib = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                       / 2 ** 20)
            logger.info(
                f"pipeline | batches queued {self._queue.qsize()}/"
                f"{self.QUEUE_SIZE} | samples/s {(samples - prev_samples) / dt:.0f}"
                f" | tokens/s {(tokens - prev_tokens) / dt:.0f}"
                f" | skipped {self.skipped / max(total, 1):.2%}"
                f" | cpu_mem_used {rss_gib:.2f}" +
                (f" | cache {len(self._cache)} samples "
                 f"{self._cache_bytes / 2**30:.2f}GiB" if self._cache_cap
                 else ""))
            prev_samples, prev_tokens, prev_time = samples, tokens, now

    def endless_iterator(self) -> Iterator[dict]:
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True,
                                            name="data-pipeline")
            self._thread.start()
            interval = getattr(self.cfg, "telemetry_interval", 180)
            if interval and interval > 0:
                self._telemetry_thread = threading.Thread(
                    target=self._telemetry, args=(interval,), daemon=True,
                    name="data-telemetry")
                self._telemetry_thread.start()
        while True:
            batch = self._queue.get()
            if batch is None:
                raise RuntimeError("data pipeline crashed") from self._error
            yield batch

    def close(self):
        self._stop.set()
        if self._pool is not None:
            self._pool.terminate()
            # join proves the imap task-handler thread unblocked (its feed
            # generator polls _stop with a 1s-timeout acquire); without
            # this, an abandoned saturated pool deadlocks multiprocessing's
            # atexit finalizer and the process hangs at interpreter exit
            self._pool.join()
            self._pool = None
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass


class ValidationDataset:
    """Whole-corpus, preprocessed once, deterministic batches
    (pasero/datasets.py:515-607)."""

    def __init__(self, cfg, task, corpus, max_lines: Optional[int] = None):
        self.task = task
        self.corpus = corpus
        self.samples = []
        files = corpus.open_files()
        count = 0
        while True:
            line_tuple = []
            try:
                for f in files:
                    line_tuple.append(next(f))
            except StopIteration:
                break
            line_tuple = tuple(line_tuple)
            if not all(len(x) > 0 for x in line_tuple):
                continue
            raw = corpus.tuple_to_dict(line_tuple)
            sample = task.preprocess(raw, truncate=True, append_eos=True)
            if sample:
                sample["index"] = count
                sample["raw"] = raw
                self.samples.append(sample)
            count += 1
            if max_lines and count >= max_lines:
                break
        for f in files:
            f.close()
        task.register_corpora(corpus)

    def __len__(self):
        return len(self.samples)

    def batches(self, shard_id: int = 0, shard_count: int = 1) -> Iterator[dict]:
        batches = self.task.build_batches(list(self.samples), shuffle=False)
        for i, batch_samples in enumerate(batches):
            if i % shard_count != shard_id:
                continue
            batch = self.task.collate(batch_samples)
            if batch is not None:
                yield batch

    @property
    def references(self) -> list:
        return [self.task.get_reference(s["raw"]) for s in self.samples]
