# Copy of pasero_tpu/tasks/task.py; the port adds ``collate_source`` (one rule
# for padding token and feature sources) and the ``device`` attribute.
"""Task base: corpora, preprocessing, collation, batching, scoring.

Re-design of pasero/tasks/task.py:23-815. Differences for TPU:

- ``collate`` produces fixed-shape numpy batches: sequence lengths snap to a
  geometric bucket ladder and row counts to a multiple of 8, so the jitted
  train step compiles a small closed set of shapes (SURVEY.md §7);
- batches are plain dicts of numpy arrays + a 'meta' dict; device placement
  and sharding happen in the trainer.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional

import numpy as np

from ..config import TaskConfig
from ..data.batching import build_batches, length_buckets, pad_to_bucket
from ..data.files import File
from ..preprocessing import TextPreprocessor

logger = logging.getLogger("task")


class Corpus:
    """Paths + metadata of a (multi-file parallel) corpus
    (pasero/tasks/task.py:23-157)."""

    def __init__(self, paths: list, *, langs: Optional[list] = None,
                 file_formats: Optional[list] = None, domain: Optional[str] = None,
                 multiplier: float = 1.0, probability: Optional[float] = None,
                 early_stopping: bool = True, max_doc_size: int = 1):
        self.paths = list(paths)
        self.langs = langs or [p.split(".")[-1] for p in self.paths]
        if file_formats:
            self.file_formats = list(file_formats)
        else:
            self.file_formats = [
                "jsonl" if p and "jsonl" in os.path.basename(p).split(".")[1:]
                else "npy" if p and p.endswith(".npy")
                else "numpy" if p and (p.endswith(".feats") or p.endswith(".npz"))
                else "txt"
                for p in self.paths
            ]
        self.domain = domain
        self.multiplier = multiplier
        self.probability = probability
        self.early_stopping = early_stopping
        self.max_doc_size = max_doc_size

    @property
    def corpus_id(self) -> str:
        names = [os.path.basename(p) for p in self.paths if p]
        if not names:  # stdin/interactive corpora have no file paths
            return "stdin"
        prefix = os.path.commonprefix(names).rstrip(".")
        return prefix or names[0]

    @property
    def realpaths(self) -> list:
        return [os.path.realpath(p) for p in self.paths]

    def exists(self) -> bool:
        return all(os.path.isfile(p) and os.path.getsize(p) > 0 for p in self.paths)

    def getmtime(self) -> float:
        return max(os.path.getmtime(p) for p in self.paths)

    def open_files(self, store_files_under: Optional[int] = None) -> list:
        return [File.open(path, format=fmt, store_files_under=store_files_under)
                for path, fmt in zip(self.paths, self.file_formats)]

    def tuple_to_dict(self, line_tuple: tuple) -> dict:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self.corpus_id})"


class InferenceCorpus(Corpus):
    """Adds input/output/reference paths for decode-time evaluation
    (pasero/tasks/task.py:158-200)."""

    def __init__(self, input_path: Optional[str] = None,
                 output_path: Optional[str] = None,
                 ref_path: Optional[str] = None, **kwargs):
        self.input_path = input_path
        self.output_path = output_path
        self.ref_path = ref_path
        paths = kwargs.pop("paths", [p for p in [input_path] if p])
        super().__init__(paths or [input_path], **kwargs)

    @property
    def input_file(self):
        if self.input_path is None:
            import sys
            return iter(sys.stdin.readline, "")
        fmt = self.file_formats[0] if self.paths and self.paths[0] else "txt"
        return File.open(self.input_path, format=fmt)


def collate_source(enc: list, buckets, pad: int, rows_multiple: int):
    """Encoder sources padded to a bucket, with their mask: token ids (1-D)
    with ``pad`` as int32, speech features (T, F) with 0.0 in their own
    float dtype."""
    is_features = enc[0].ndim > 1
    return pad_to_bucket(enc, buckets, 0.0 if is_features else pad,
                         rows_multiple=rows_multiple)


class Task:
    """Base text-generation task (pasero/tasks/task.py:203-815)."""

    preprocessor: TextPreprocessor
    preprocessors: dict

    def __init__(self, data_dir: str, cfg: TaskConfig):
        self.cfg = cfg
        self.model_type: Optional[str] = None
        self.training = False
        self.data_dir = data_dir
        self.find_unused_parameters = False
        # padded sequence lengths are rounded up to this (context parallelism
        # needs lengths divisible by the 'seq' mesh axis; set by cli/train)
        self.length_multiple = 1
        # where input_to_sample computes what it computes from raw input (the
        # speech task's log-mel); None is the card (TextGenerator sets its own)
        self.device = None

    # -- model wiring -------------------------------------------------------
    def setup_for_model(self, model_cfg) -> None:
        """Align the preprocessors' special ids with the model's
        (tasks/task.py:242-257)."""
        self.model_type = model_cfg.model_type
        self.model_cfg = model_cfg
        for pp in self.preprocessors.values():
            for prop in ("unk_idx", "bos_idx", "padding_idx", "eos_idx"):
                if getattr(pp, prop) != getattr(model_cfg, prop):
                    setattr(pp, prop, getattr(model_cfg, prop))

    @property
    def prepend_bos(self) -> bool:
        cfg = getattr(self, "model_cfg", None)
        return cfg is not None and cfg.bos_idx >= 0

    @property
    def padding_idx(self):
        return self.preprocessor.padding_idx

    @property
    def eos_idx(self):
        return self.preprocessor.eos_idx

    @property
    def bos_idx(self):
        return self.preprocessor.bos_idx

    @property
    def task_info(self) -> dict:
        return {"model_type": self.model_type}

    def train(self):
        self.training = True
        for pp in self.preprocessors.values():
            pp.train()

    def eval(self):
        self.training = False
        for pp in self.preprocessors.values():
            pp.eval()

    # -- abstract task API --------------------------------------------------
    def register_corpora(self, *corpora) -> None:
        raise NotImplementedError

    def make_meta(self, **kwargs) -> dict:
        raise NotImplementedError

    def check_meta(self, meta: dict) -> None:
        raise NotImplementedError

    def get_langs_or_domains(self, key: str) -> set:
        raise NotImplementedError

    def input_to_sample(self, input: Any, meta: dict = {}) -> dict:
        raise NotImplementedError

    def preprocess(self, sample: dict, truncate: bool = False,
                   tokenize: bool = True, append_eos: bool = False) -> dict:
        raise NotImplementedError

    @classmethod
    def get_train_corpora(cls, cfg, data_dir: str, corpus_defs) -> list:
        raise NotImplementedError

    @classmethod
    def get_valid_corpora(cls, cfg, data_dir: str, corpus_defs) -> list:
        raise NotImplementedError

    @classmethod
    def get_inference_corpora(cls, cfg, input_paths=None, output_paths=None,
                              ref_paths=None, corpus_prefix=None) -> list:
        raise NotImplementedError

    # -- batching -----------------------------------------------------------
    def build_batches(self, data: list, shuffle: bool = True, sort: bool = True,
                      batch_size: Optional[int] = None,
                      rng: Optional[np.random.Generator] = None) -> list:
        """Length-sorted token-budget batches over preprocessed samples
        (tasks/task.py:573-610)."""
        if not data:
            return []
        rng = rng or np.random.default_rng()
        if self.model_type == "encoder_decoder":
            enc_len = np.array([len(s["encoder_input"]) for s in data])
            dec_len = np.array([len(s["decoder_input"]) for s in data])
            length = np.maximum(enc_len, dec_len)
            indices = rng.permutation(len(data)) if shuffle else np.arange(len(data))
            if sort:
                indices = indices[np.argsort(dec_len[indices], kind="stable")]
                indices = indices[np.argsort(enc_len[indices], kind="stable")]
        else:
            length = np.array([len(s["decoder_input"]) for s in data])
            indices = rng.permutation(len(data)) if shuffle else np.arange(len(data))
            if sort:
                indices = indices[np.argsort(length[indices], kind="stable")]
        batch_indices = build_batches(
            indices, length.__getitem__, batch_size or self.cfg.batch_size,
            self.cfg.batch_size_multiple, self.cfg.lines_per_batch)
        return [[{**data[i], "index": int(i)} for i in idxs]
                for idxs in batch_indices]

    def collate(self, samples: list, max_source_len: Optional[int] = None,
                max_target_len: Optional[int] = None,
                rows_multiple: int = 8, pad_to_fixed: bool = True,
                fixed_len: bool = False) -> Optional[dict]:
        """Pad a list of preprocessed samples into a bucketed batch.

        ``fixed_len`` pads every batch to the single maximum bucket
        (multi-host 'sharded' input mode: all hosts must emit identical
        shapes each step without coordinating)."""
        if not samples:
            return None
        pad = self.padding_idx
        mult = getattr(self, "length_multiple", 1)
        if fixed_len:
            tgt_bucket = [-(-(max_target_len or self.cfg_max_target_len())
                            // mult) * mult]
        elif pad_to_fixed:
            tgt_bucket = length_buckets(
                max_target_len or self.cfg_max_target_len(), multiple=mult)
        else:
            tgt_bucket = None

        dec = [s["decoder_input"] for s in samples]
        if not pad_to_fixed:
            longest = max(len(d) for d in dec)
            tgt_bucket = [-(-longest // mult) * mult]
        decoder_input, tgt_mask = pad_to_bucket(dec, tgt_bucket, pad,
                                                rows_multiple=rows_multiple)
        prompt = [np.asarray(s.get("prompt_mask",
                                   np.zeros(len(d), bool)), dtype=np.int32)
                  for s, d in zip(samples, dec)]
        prompt_mask, _ = pad_to_bucket(prompt, tgt_bucket, 0,
                                       rows_multiple=rows_multiple)
        batch = {
            "decoder_input": decoder_input,
            "target_mask": tgt_mask,
            "prompt_mask": prompt_mask.astype(bool),
            "indices": np.array([s.get("index", i)
                                 for i, s in enumerate(samples)], np.int32),
            "num_real_rows": len(samples),
        }
        # prompt_length: last prompt position + 1 (0s inside count as prompt,
        # like the reference's mask_to_len, tasks/task.py:547-558)
        pm = prompt_mask.astype(bool)
        has = pm.any(axis=1)
        last = np.where(has, pm.shape[1] - 1 - np.argmax(pm[:, ::-1], axis=1), -1)
        batch["prompt_length"] = (last + 1).astype(np.int32)

        if self.model_type == "encoder_decoder":
            enc = [s["encoder_input"] for s in samples]
            if fixed_len:
                src_bucket = [-(-(max_source_len or self.cfg_max_source_len())
                                // mult) * mult]
            elif pad_to_fixed:
                src_bucket = length_buckets(
                    max_source_len or self.cfg_max_source_len(), multiple=mult)
            else:
                src_bucket = [-(-max(len(e) for e in enc) // mult) * mult]
            src_tokens, src_mask = collate_source(enc, src_bucket, pad,
                                                  rows_multiple)
            batch["src_tokens"] = src_tokens
            batch["src_mask"] = src_mask

        meta = samples[0].get("meta", {})
        batch["meta"] = {k: v for k, v in meta.items()
                         if all(s.get("meta", {}).get(k) == v for s in samples[1:])}
        return batch

    def cfg_max_source_len(self) -> int:
        return getattr(self.cfg, "max_source_len", None) or 1024

    def cfg_max_target_len(self) -> int:
        return (getattr(self.cfg, "max_target_len", None)
                or getattr(self.cfg, "max_len", None) or 1024)

    # -- postprocessing -----------------------------------------------------
    def debinarize(self, ids) -> list:
        return self.preprocessor.debinarize(ids)

    def detokenize(self, tokens) -> str:
        return self.preprocessor.detokenize(tokens)

    def postprocess(self, ids, sample: Optional[dict] = None,
                    strip_prompt: Optional[bool] = None) -> str:
        """ids -> detokenized text; strips EOS/prompt and de-escapes emojis."""
        ids = [int(i) for i in ids if int(i) != self.padding_idx]
        strip = self.cfg.strip_prompt if strip_prompt is None else strip_prompt
        if strip and sample is not None and "prompt_length" in sample:
            ids = ids[sample["prompt_length"]:]
        tokens = self.debinarize(ids)
        text = self.detokenize(tokens)
        if sample and sample.get("emojis"):
            text = self.preprocessor.deescape_emojis(text, sample["emojis"])
        return text

    def hypothesis_to_str(self, sample: dict, hypothesis: dict,
                          verbose: bool = False) -> str:
        """fairseq-style verbose output lines (tasks/task.py:679-733)."""
        if not verbose:
            return hypothesis["detok"]
        lines = []
        idx = sample.get("index", 0)
        if "source" in sample:
            lines.append(f"S-{idx}\t{sample['source']}")
        if "target" in sample and sample["target"]:
            lines.append(f"T-{idx}\t{sample['target']}")
        score = hypothesis.get("score")
        score_str = f"{score:.4f}\t" if score is not None else ""
        lines.append(f"H-{idx}\t{score_str}{hypothesis.get('tokens_str', '')}")
        lines.append(f"D-{idx}\t{score_str}{hypothesis['detok']}")
        if "positional_scores" in hypothesis:
            ps = " ".join(f"{p:.4f}" for p in hypothesis["positional_scores"])
            lines.append(f"P-{idx}\t{ps}")
        return "\n".join(lines)

    # -- scoring ------------------------------------------------------------
    def compute_score(self, metric: str, hypotheses: list, references: list,
                      sources: Optional[list] = None, lang: Optional[str] = None):
        from .. import evaluation
        return evaluation.safe_score(
            metric, hypotheses, references, sources=sources, lang=lang,
            bleu_tok=getattr(self.cfg, "bleu_tok", None),
            lowercase=getattr(self.cfg, "eval_lc", False))

    # -- inference batch sharding (DP decoding lockstep) --------------------
    @classmethod
    def shard_batch(cls, batch: dict, shard_id: int = 0, shard_count: int = 1) -> dict:
        """Split a batch along rows; rank without data gets a 1-row dummy batch
        so collective-dependent models stay in lockstep (tasks/task.py:612-645)."""
        if shard_count == 1:
            return {**batch, "dummy": False}
        dummy_batch = {"dummy": True}
        sharded = {"dummy": False}
        is_dummy = False
        for k, v in batch.items():
            if not isinstance(v, np.ndarray) or v.ndim == 0:
                dummy_batch[k] = v
                sharded[k] = v
                continue
            bsz = len(v)
            size = bsz // shard_count
            lo = shard_id * size
            hi = None if shard_id == shard_count - 1 else lo + size
            dummy_batch[k] = v[:1]
            sharded[k] = v[lo:hi]
            if len(sharded[k]) == 0:
                is_dummy = True
        return dummy_batch if is_dummy else sharded
