"""TextGenerator: the inference API on one device.

PyTorch counterpart of pasero_tpu/decoding/generator.py.
``TextGenerator.build(model_dir, device=None, **opts)`` loads a trained model
(config.json + npz checkpoint + inference.yaml defaults) and exposes:

- ``decode(*inputs, **opts)`` — batched n-best decoding with scores;
- ``decode_corpus(corpus, ...)`` — buffered corpus decoding with
  ``--continue`` resume, verbose S/H/D/P output and metric computation.

As in pasero_tpu, prompts are sorted by length, cut into chunks of 16,
bucketed and left-aligned, and the model computes in bfloat16 with float32
parameters and float32 norm statistics. Encoder-decoder and decoder-only
models decode by beam search, greedy search, sampling (drawn from a
``torch.Generator`` seeded from the config's ``seed``) or speculative greedy
search (``--speculative``); ``--quantize int8`` stores the large weights as
int8 after loading (ops/quantize.py). The generator runs on the card unless
the caller asks for the CPU (``device="cpu"``). Streaming, teacher-forced
scoring, ensembles and multi-device decoding come with later slices
(ROADMAP.md).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import sys
import time
from typing import Any, Optional

import numpy as np
import torch

from .. import checkpoints, not_ported, resolve_device
from ..config import (DecodingAPIConfig, get_model_cls, get_model_config_cls,
                      get_task_cls)
from ..data.batching import length_buckets, pad_to_bucket
from ..ops.quantize import quantize_params, quantized_bytes
from ..tasks.task import collate_source
from ..utils.metrics import Metrics
from .search import (beam_search, left_align, sample_decode,
                     speculative_greedy_decode)

logger = logging.getLogger("decoding")

# '!key=value' commands of interactive corpus decoding
# (pasero_tpu/serving/server.py DECODE_PARAMS)
DECODE_PARAMS = {
    "beam_size": int, "max_output_len": int, "sampling": bool,
    "sampling_topk": int, "sampling_topp": float, "sampling_temperature": float,
    "repeat_penalty": float, "len_penalty": float, "nbest": int,
    "source_lang": str, "target_lang": str, "domain": str,
}

CHUNK_ROWS = 16
# batch rows are padded to a multiple of this: pasero_tpu's lcm(4, the
# data-parallel degree), on one device
ROWS_MULTIPLE = 4


def load_model_config(model_dir: str, arch: Optional[str] = None):
    path = os.path.join(model_dir, "config.json")
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
        arch = arch or data.pop("arch", "transformer")
        cfg = get_model_config_cls(arch)(strict=False, **data)
        return arch, cfg
    if not arch:
        raise ValueError(f"no config.json in {model_dir}; pass --arch")
    return arch, get_model_config_cls(arch)()


def _device_option(cfg) -> Optional[str]:
    """The device named by --device (pasero_tpu's --devices list)."""
    devices = list(cfg.devices or [])
    if len(devices) > 1:
        raise not_ported("multi-device decoding", "A.12 parallelism")
    if not devices:
        return None
    name = str(devices[0])
    return f"cuda:{name}" if name.isdigit() else name


def _check_supported(cfg) -> None:
    def todo(what, item):
        raise not_ported(what, item)
    if (cfg.tp_size or 1) * (cfg.dp_size or 1) * (getattr(cfg, "ep_size", 1) or 1) > 1:
        todo("mesh-sharded decoding", "A.12 parallelism")
    if cfg.ensemble_ckpt:
        todo("ensembles", "A.6 decoding")


def to_tensor(array, device, dtype=None) -> torch.Tensor:
    """A host array on ``device`` as ``dtype``, or by its own kind: float
    arrays (speech features) as float32, integer ones (token ids) as
    long."""
    array = np.asarray(array)
    if dtype is None:
        dtype = torch.float32 if array.dtype.kind == "f" else torch.long
    return torch.as_tensor(array).to(device, dtype)


class TextGenerator:
    """Build once, decode many times."""

    def __init__(self, cfg: DecodingAPIConfig, device=None,
                 start: bool = True):
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device if device is not None
                                     else _device_option(cfg))
        self.dtype = cfg.compute_dtype
        self.metrics = Metrics(window=None)
        arch, model_cfg = load_model_config(cfg.model_dir, cfg.arch)
        self.arch = arch
        self.model_cfg = model_cfg
        model_cfg.setup_for_inference(cfg)
        # the sampling draws (pasero_tpu seeds its PRNGKey the same way)
        self.rng = torch.Generator(device=self.device).manual_seed(
            cfg.seed or 42)

        task_cls = get_task_cls(cfg.task)
        self.task = task_cls(cfg.model_dir, cfg.task_cfg)
        self.task.device = self.device
        self.task.setup_for_model(model_cfg)
        self.task.eval()

        self.model_cls, _ = get_model_cls(arch)
        self.model = None
        if start:
            self.start_model()

    @classmethod
    def build(cls, model: str, device=None, **kwargs) -> "TextGenerator":
        """``device=None`` runs on the card (and raises without one);
        ``device="cpu"`` runs on the CPU."""
        cfg = DecodingAPIConfig(model=model, strict=True, **kwargs)
        return cls(cfg, device=device)

    @property
    def src_vocab_size(self) -> int:
        return (self.task.encoder_num_embeddings
                or self.task.decoder_num_embeddings)

    def start_model(self):
        if self.model is not None:
            return
        t0 = time.time()
        model = self.model_cls(self.model_cfg,
                               src_vocab_size=self.src_vocab_size,
                               tgt_vocab_size=self.task.decoder_num_embeddings,
                               dtype=self.dtype)
        checkpoints.load_into(model, self.cfg.ckpt,
                              other_paths=tuple(self.cfg.other_ckpt or ()))
        self.model = model.to(self.device).eval()
        if self.cfg.quantize == "int8":
            # weight-only int8 (ops/quantize.py): the last load step
            n_q = quantize_params(self.model)
            qb, fb = quantized_bytes(self.model)
            logger.info(f"quantized {n_q} weights to int8: {qb / 2**20:.0f} "
                        f"MiB int8 + {fb / 2**20:.0f} MiB float on "
                        f"{self.device}")
        logger.info(f"loaded model in {time.time() - t0:.1f}s on {self.device}")

    # -- preprocessing -------------------------------------------------------
    def _prepare_batch(self, samples: list):
        """Collate preprocessed samples into a left-aligned prompt batch, with
        a source batch for an encoder-decoder model: token ids padded with
        the padding index, or speech features padded with 0.0
        (pasero_tpu/decoding/generator.py:213-235)."""
        pad = self.task.padding_idx
        dec = [s["decoder_input"] for s in samples]
        max_len = max(len(d) for d in dec)
        buckets = length_buckets(max(max_len, 8), min_len=8)
        prompt, prompt_mask = pad_to_bucket(dec, buckets, pad,
                                            rows_multiple=ROWS_MULTIPLE)
        prompt, prompt_mask = left_align(prompt, prompt_mask, pad)
        batch = {"prompt": prompt, "prompt_mask": prompt_mask}
        if self.model_cfg.model_type != "decoder":
            enc = [s["encoder_input"] for s in samples]
            src_buckets = length_buckets(max(max(len(e) for e in enc), 8),
                                         min_len=8)
            src, src_mask = collate_source(enc, src_buckets, pad,
                                           ROWS_MULTIPLE)
            batch["src_tokens"] = src
            batch["src_mask"] = src_mask
        return batch

    def _tensor(self, array, dtype=None):
        return to_tensor(array, self.device, dtype)

    # -- decoding ------------------------------------------------------------
    @torch.inference_mode()
    def _decode_batch(self, batch: dict, opts: dict) -> dict:
        """One batch through beam search, sampling / greedy search or
        speculative greedy search, by pasero_tpu's rules
        (pasero_tpu/decoding/generator.py:270-420)."""
        cfg = self.cfg
        beam = opts["beam_size"]
        use_sampling = opts.get("sampling", cfg.sampling)
        use_spec = (cfg.speculative and beam == 1 and not use_sampling
                    and not self.task.preprocessor.blacklist
                    and not any(len(s) for s in
                                self.task.preprocessor.bin_stop_sequences))
        encoder_out = encoder_mask = None
        if "src_tokens" in batch:
            encoder_out, encoder_mask = self.model.encode(
                self._tensor(batch["src_tokens"]),
                self._tensor(batch["src_mask"], torch.bool))
        common = dict(max_new=opts["max_new"], eos_idx=self.task.eos_idx,
                      pad_idx=self.task.padding_idx,
                      encoder_out=encoder_out, encoder_mask=encoder_mask)
        blacklist = tuple(self.task.preprocessor.blacklist)
        prompt = self._tensor(batch["prompt"])
        prompt_mask = self._tensor(batch["prompt_mask"], torch.bool)
        if use_spec:
            lookup = lookup_mask = None
            # speech features (3-D) cannot seed token drafts
            if "src_tokens" in batch and batch["src_tokens"].ndim == 2:
                lookup = self._tensor(batch["src_tokens"])
                lookup_mask = self._tensor(batch["src_mask"], torch.bool)
            out = speculative_greedy_decode(
                self.model, prompt, prompt_mask, lookup=lookup,
                lookup_mask=lookup_mask, draft_len=cfg.speculative_draft_len,
                **common)
        elif use_sampling or beam == 1:
            stop_seqs = tuple(tuple(int(i) for i in s)
                              for s in self.task.preprocessor.bin_stop_sequences
                              if len(s))
            out = sample_decode(
                self.model, prompt, prompt_mask, greedy=not use_sampling,
                temperature=opts.get("sampling_temperature",
                                     cfg.sampling_temperature),
                top_k=opts.get("sampling_topk", cfg.sampling_topk),
                top_p=opts.get("sampling_topp", cfg.sampling_topp),
                repeat_penalty=opts.get("repeat_penalty", cfg.repeat_penalty),
                stop_sequences=stop_seqs, blacklist=blacklist,
                generator=self.rng, **common)
        else:
            out = beam_search(
                self.model, prompt, prompt_mask, beam_size=beam,
                len_penalty=opts.get("len_penalty", cfg.len_penalty),
                blacklist=blacklist, **common)
            out = {k: v.cpu().numpy() for k, v in out.items()
                   if k != "model_calls"}
            return {"tokens": out["tokens"],
                    "positional_scores": out["positional_scores"],
                    "lengths": out["lengths"], "scores": out["scores"]}
        out = {k: v.cpu().numpy() for k, v in out.items() if k != "model_calls"}
        pos_scores = out["scores"][:, None]                    # (B, 1, T)
        lengths = out["lengths"][:, None]
        return {"tokens": out["tokens"][:, None],
                "positional_scores": pos_scores, "lengths": lengths,
                "scores": pos_scores.sum(-1)
                / (lengths + 1.0) ** cfg.len_penalty}

    def decode(self, *inputs, return_scores: bool = False, nbest: int = 1,
               meta: Optional[dict] = None, **opts) -> Any:
        """Decode raw text inputs; returns str (single input) or list[str],
        or hypothesis dicts with return_scores."""
        if opts.get("return_layers") or opts.get("return_weights"):
            raise not_ported("return_layers / return_weights",
                             "A.6 decoding")
        self.start_model()
        single = len(inputs) == 1 and isinstance(inputs[0], str)
        flat_inputs = list(inputs[0]) if (len(inputs) == 1 and
                                         isinstance(inputs[0], (list, tuple))) \
            else list(inputs)
        meta = self.task.make_meta(**(meta or {}))
        self.task.check_meta(meta)
        samples = [self.task.preprocess(
            self.task.input_to_sample(text, meta)) for text in flat_inputs]
        for i, s in enumerate(samples):
            s["index"] = i
            s["prompt_length"] = int(s["prompt_mask"].sum())

        merged = {
            "max_new": opts.get("max_output_len", self.cfg.max_output_len),
            "beam_size": opts.get("beam_size") or self.cfg.beam_size or 1,
            "sampling": opts.get("sampling", self.cfg.sampling),
            "sampling_temperature": opts.get("sampling_temperature",
                                             self.cfg.sampling_temperature),
            "sampling_topk": opts.get("sampling_topk", self.cfg.sampling_topk),
            "sampling_topp": opts.get("sampling_topp", self.cfg.sampling_topp),
            "repeat_penalty": opts.get("repeat_penalty", self.cfg.repeat_penalty),
            "len_penalty": opts.get("len_penalty", self.cfg.len_penalty),
        }
        # sort by prompt length for tighter buckets, then restore order
        order = np.argsort([len(s["decoder_input"]) for s in samples])
        hypotheses: list = [None] * len(samples)
        wall = time.time()
        for start in range(0, len(order), CHUNK_ROWS):
            chunk = [samples[i] for i in order[start:start + CHUNK_ROWS]]
            batch = self._prepare_batch(chunk)
            result = self._decode_batch(batch, merged)
            for row, sample in enumerate(chunk):
                hyps = []
                for k in range(min(nbest, result["tokens"].shape[1])):
                    ids = result["tokens"][row, k]
                    n = int(result["lengths"][row, min(
                        k, result["lengths"].shape[1] - 1)])
                    ids = [int(t) for t in ids[:n]]
                    detok = self.task.postprocess(
                        [t for t in ids if t != self.task.eos_idx])
                    hyps.append({
                        "detok": detok,
                        "tokens": ids,
                        "tokens_str": " ".join(self.task.debinarize(ids)),
                        "score": float(result["scores"][row, k]),
                        "positional_scores":
                            result["positional_scores"][row, k][:n].tolist(),
                    })
                hypotheses[sample["index"]] = hyps
        elapsed = time.time() - wall
        total_tokens = sum(len(h[0]["tokens"]) for h in hypotheses if h)
        self.metrics.update("wps", total_tokens / max(elapsed, 1e-6))

        if return_scores or nbest > 1:
            out = hypotheses
        else:
            out = [h[0]["detok"] for h in hypotheses]
        if single:
            return out[0]
        return out

    # -- corpus decoding -----------------------------------------------------
    def decode_corpus(self, corpus, buffer_size: int = 100,
                      max_lines: Optional[int] = None, verbose: bool = False,
                      quiet: bool = False, continue_: bool = False,
                      metrics: Optional[list] = None, **opts) -> dict:
        """Buffered decode of an inference corpus with optional resume and
        metric computation."""
        self.start_model()
        meta = self.task.make_meta(
            **{k: v for k, v in corpus.meta.items()
               if k in ("source_lang", "target_lang", "domain", "lang",
                        "corpus_id")})
        out_file = sys.stdout
        skip = 0
        if corpus.output_path:
            if continue_ and os.path.exists(corpus.output_path):
                with open(corpus.output_path) as f:
                    skip = sum(1 for _ in f)
            if continue_ and skip:
                out_file = open(corpus.output_path, "a")
            else:
                os.makedirs(os.path.dirname(corpus.output_path) or ".",
                            exist_ok=True)
                out_file = open(corpus.output_path, "w")

        inputs = corpus.input_file
        refs_file = open(corpus.ref_path) if getattr(corpus, "ref_path", None) \
            and os.path.exists(corpus.ref_path or "") else None

        hypotheses, references = [], []
        start_time = time.time()
        total_tokens = 0
        line_iter = iter(inputs)
        n_read = 0
        runtime_opts: dict = {}
        try:
            while True:
                buffer = list(itertools.islice(line_iter, buffer_size))
                if not buffer:
                    break
                # interactive '!opt=value' commands update decoding options;
                # a feature file yields arrays, not lines
                commands = [l for l in buffer
                            if isinstance(l, str) and l.startswith("!")]
                for command in commands:
                    try:
                        key, value = command[1:].strip().split("=", 1)
                        caster = DECODE_PARAMS.get(key, str)
                        runtime_opts[key] = (value.lower() in ("1", "true")
                                             if caster is bool
                                             else caster(value))
                        logger.info(f"set {key} = {runtime_opts[key]}")
                    except ValueError:
                        logger.warning(f"could not parse command {command!r}")
                buffer = [l for l in buffer if not (isinstance(l, str)
                                                    and l.startswith("!"))]
                if not buffer:
                    continue
                opts = {**opts, **runtime_opts}
                ref_buffer = (list(itertools.islice(refs_file, len(buffer)))
                              if refs_file else [None] * len(buffer))
                if skip > 0:
                    take = min(skip, len(buffer))
                    buffer, ref_buffer = buffer[take:], ref_buffer[take:]
                    skip -= take
                    if not buffer:
                        continue
                # skip pairs where either side is empty
                keep = [(line, ref) for line, ref in zip(buffer, ref_buffer)
                        if (not isinstance(line, str) or line.strip())
                        and (ref is None or ref.strip())]
                if not keep:
                    continue
                lines = [line.strip() if isinstance(line, str) else line
                         for line, _ in keep]
                refs = [ref.strip() if ref else None for _, ref in keep]
                outs = self.decode(lines, return_scores=True, meta=dict(
                    source_lang=meta.get("source_lang"),
                    target_lang=meta.get("target_lang"),
                    domain=meta.get("domain")), **opts)
                for j, (line, hyp_list) in enumerate(zip(lines, outs)):
                    hyp = hyp_list[0]
                    total_tokens += len(hyp["tokens"])
                    if verbose:
                        sample = {"index": n_read + j, "source": line}
                        if refs[j]:
                            sample["target"] = refs[j]
                        print(self.task.hypothesis_to_str(sample, hyp,
                                                          verbose=True),
                              file=out_file)
                    elif not quiet or out_file is not sys.stdout:
                        print(hyp["detok"], file=out_file)
                    hypotheses.append(hyp["detok"])
                    if refs[j] is not None:
                        references.append(refs[j])
                out_file.flush()
                n_read += len(lines)
                if max_lines and n_read >= max_lines:
                    break
        finally:
            if out_file is not sys.stdout:
                out_file.close()
            if refs_file is not None:
                refs_file.close()

        elapsed = time.time() - start_time
        results = {"wps": total_tokens / max(elapsed, 1e-6),
                   "lines": len(hypotheses), "time": elapsed}
        for metric in metrics or []:
            if references and len(references) == len(hypotheses):
                value = self.task.compute_score(
                    metric, hypotheses, references,
                    lang=meta.get("target_lang"))
                if value is not None:
                    results[metric] = value
        return results
