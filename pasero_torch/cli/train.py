"""The training entry point of the PyTorch port (the counterpart of cli/train.py),
on one card:

    python -m pasero_torch.cli.train --config examples/deen-mini/deen-mini.yaml \
        [--model-dir DIR] [--device cpu] [any TrainingConfig option]

As in the JAX training CLI: training.yaml / inference.yaml / config.json and the
tokenizer files are written to the model directory; validation computes the
teacher-forced loss and beam-decodes each validation corpus with the current
weights, scored with the configured metrics; ``expected_scores`` gates the
run (a regression raises); early stopping with patience; SIGINT/SIGTERM save
``model_latest`` and exit 143, SIGUSR1 saves and restarts from the model
directory's training.yaml. The log lines have the JAX training CLI's format
(``step N | loss … | lr …``), so one parser reads both.

``--device`` is the port's own option: the card by default (an error
without one), ``--device cpu`` to train on the CPU.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import signal
import sys
import time

import numpy as np
import yaml

logger = logging.getLogger("train")


class Restart(BaseException):
    """SIGUSR1 warm restart. BaseException so broad `except Exception`
    blocks in the data/step path cannot swallow it."""


class Interrupt(BaseException):
    """SIGINT/SIGTERM graceful shutdown (save model_latest, exit 143)."""


def setup_logging(model_dir: str, log_file: str):
    os.makedirs(model_dir, exist_ok=True)
    handlers = [logging.StreamHandler()]
    if log_file:
        handlers.append(logging.FileHandler(os.path.join(model_dir, log_file)))
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s | %(name)s | %(message)s",
                        handlers=handlers, force=True)


def save_config_files(cfg, task):
    """training.yaml dump + inference.yaml + config.json + tokenizer files
    (cli/train.py:58)."""
    os.makedirs(cfg.model_dir, exist_ok=True)
    with open(os.path.join(cfg.model_dir, "training.yaml"), "w") as f:
        yaml.safe_dump(cfg.as_dict(), f, default_flow_style=False,
                       sort_keys=True)
    for pp in task.preprocessors.values():
        for path in pp.files:
            target = os.path.join(cfg.model_dir, os.path.basename(path))
            if os.path.realpath(path) != os.path.realpath(target):
                shutil.copy(path, target)
    inference = dict(cfg.inference_options)
    inference["task"] = cfg.task
    inference["arch"] = cfg.arch
    if hasattr(task, "inference_options"):
        inference.update(task.inference_options)
    with open(os.path.join(cfg.model_dir, "inference.yaml"), "w") as f:
        yaml.safe_dump(inference, f, default_flow_style=False, sort_keys=True)
    model_dict = cfg.model_cfg.as_dict()
    model_dict["arch"] = cfg.arch
    with open(os.path.join(cfg.model_dir, "config.json"), "w") as f:
        json.dump(model_dict, f, indent=2, default=str)


def check_scores(cfg, scores_at_step: dict, step: int):
    """expected_scores regression test: raise on regression
    (cli/train.py:89)."""
    from pasero_torch.evaluation import LOWER_IS_BETTER
    for spec in cfg.expected_scores or []:
        if spec.get("steps") != step:
            continue
        corpus = spec.get("corpus")
        for metric, expected in (spec.get("metrics") or {}).items():
            actual = scores_at_step.get(corpus, {}).get(metric)
            if actual is None:
                continue
            eps = 0.01
            worse = (actual > expected + eps if metric in LOWER_IS_BETTER
                     else actual < expected - eps)
            if worse:
                raise RuntimeError(
                    f"score regression at step {step}: {corpus}/{metric} "
                    f"= {actual} (expected {expected})")
            logger.info(f"expected_scores OK: {corpus}/{metric} = {actual} "
                        f"(expected {expected})")


def evaluate(cfg, task, trainer, valid_sets, generator_factory):
    """Teacher-forced loss + beam decode + metrics per validation corpus
    (cli/train.py:112)."""
    from pasero_torch.evaluation import safe_score
    all_scores = {}
    for name, valid_set in valid_sets.items():
        loss_sum = nll_sum = tokens = 0.0
        for batch in valid_set.batches():
            out = trainer.valid_step(batch)
            loss_sum += out["loss_sum"]
            nll_sum += out["nll_sum"]
            tokens += out["num_tokens"]
        scores = {
            "valid_loss": round(loss_sum / max(1, tokens), 3),
            "nll_loss": round(nll_sum / max(1, tokens), 3),
            "ppl": round(float(2 ** (nll_sum / max(1, tokens) / np.log(2))), 2),
        }
        if cfg.metrics:
            generator = generator_factory()
            # a speech source is an array, whose truth value is undefined
            sources = [s["raw"]["source"] if s["raw"].get("source") is not None
                       else s["raw"].get("target") for s in valid_set.samples]
            references = valid_set.references
            t0 = time.time()
            hypotheses = generator(sources, valid_set)
            elapsed = time.time() - t0
            for metric in cfg.metrics:
                value = safe_score(metric, hypotheses, references,
                                   lang=valid_set.corpus.meta.get("target_lang"),
                                   bleu_tok=cfg.bleu_tok, lowercase=cfg.eval_lc)
                if value is not None:
                    scores[metric] = value
            scores["eval_time"] = round(elapsed, 1)
        all_scores[name] = scores
        logger.info(f"valid | {name} | " +
                    " | ".join(f"{k} {v}" for k, v in scores.items()))
    return all_scores


def make_generator_factory(cfg, task, trainer):
    """Beam-decode validation sources with the trainer's current weights:
    chunks of 16 prompts, bucketed and left-aligned as in the JAX training CLI
    (cli/train.py:218-326), through the port's beam_search. Language models
    validate on the loss only (their tasks name no metrics)."""
    import torch
    from pasero_torch import not_ported
    from pasero_torch.data.batching import length_buckets, pad_to_bucket
    from pasero_torch.decoding.generator import to_tensor
    from pasero_torch.decoding.search import beam_search, left_align
    from pasero_torch.tasks.task import collate_source

    model, device = trainer.model, trainer.device
    if not model.is_encoder_decoder:
        raise not_ported("validation metrics that decode with a decoder-only "
                         "model", "A.8 decoder-only")

    def tensor(array, dtype=None):
        return to_tensor(array, device, dtype)

    @torch.inference_mode()
    def generate(sources, valid_set):
        model.eval()
        meta = getattr(valid_set.corpus, "meta", {})
        samples = [task.preprocess(task.input_to_sample(src, meta))
                   for src in sources]
        pad = task.padding_idx
        hypotheses = []
        for start in range(0, len(samples), 16):
            chunk = samples[start:start + 16]
            dec = [s["decoder_input"] for s in chunk]
            buckets = length_buckets(max(max(len(d) for d in dec), 8), 8)
            prompt, pmask = pad_to_bucket(dec, buckets, pad, rows_multiple=4)
            prompt, pmask = left_align(prompt, pmask, pad)
            enc = [s["encoder_input"] for s in chunk]
            sbuckets = length_buckets(max(max(len(e) for e in enc), 8), 8)
            src, smask = collate_source(enc, sbuckets, pad, 4)
            encoder_out, encoder_mask = model.encode(
                tensor(src), tensor(smask, torch.bool))
            out = beam_search(model, tensor(prompt), tensor(pmask, torch.bool),
                              beam_size=cfg.beam_size or 1,
                              max_new=cfg.max_output_len, eos_idx=task.eos_idx,
                              pad_idx=pad, encoder_out=encoder_out,
                              encoder_mask=encoder_mask,
                              len_penalty=cfg.len_penalty)
            tokens = out["tokens"][:, 0].cpu().numpy()
            lengths = out["lengths"][:, 0].cpu().numpy()
            for row in range(len(chunk)):
                ids = [int(t) for t in tokens[row][:lengths[row]]
                       if int(t) != task.eos_idx]
                hypotheses.append(task.postprocess(ids))
        return hypotheses

    return lambda: generate


def run_training(cfg, device=None):
    from pasero_torch.config import get_model_cls, get_task_cls
    from pasero_torch.config.registry import DATASET_REGISTRY
    from pasero_torch.datasets import ValidationDataset
    from pasero_torch.evaluation import is_better
    from pasero_torch.training import Trainer

    setup_logging(cfg.model_dir, cfg.log_file)
    logger.info(f"config: {json.dumps({k: str(v) for k, v in cfg.non_default().items()})}")

    task_cls = get_task_cls(cfg.task)
    train_corpora = task_cls.get_train_corpora(
        cfg.task_cfg, cfg.data_dir, cfg.train_corpora)
    valid_corpora = task_cls.get_valid_corpora(
        cfg.task_cfg, cfg.data_dir, cfg.valid_corpora)
    task = task_cls(cfg.data_dir, cfg.task_cfg)

    model_cls, _ = get_model_cls(cfg.arch)
    task.setup_for_model(cfg.model_cfg)
    task.register_corpora(*train_corpora)
    save_config_files(cfg, task)

    model = model_cls(cfg.model_cfg,
                      src_vocab_size=(task.encoder_num_embeddings
                                      or task.decoder_num_embeddings),
                      tgt_vocab_size=task.decoder_num_embeddings,
                      dtype=cfg.compute_dtype)
    trainer = Trainer(cfg, task, model, device=device)

    dataset_cls = DATASET_REGISTRY[cfg.dataset_type]
    task.train()
    train_set = dataset_cls(cfg.dataset_cfg, cfg, task, train_corpora,
                            rng=np.random.default_rng(cfg.seed))
    task.eval()
    valid_sets = {c.corpus_id: ValidationDataset(cfg, task, c)
                  for c in valid_corpora}
    generator_factory = (make_generator_factory(cfg, task, trainer)
                         if cfg.metrics else None)

    # raise immediately AND set a flag: if the raise lands inside native code
    # or a try/except that discards it, the per-step flag check still fires
    pending = {"signal": None}

    def on_interrupt(signum, frame):
        pending["signal"] = Interrupt
        raise Interrupt()

    def on_usr1(signum, frame):
        pending["signal"] = Restart
        raise Restart()

    signal.signal(signal.SIGINT, on_interrupt)
    signal.signal(signal.SIGTERM, on_interrupt)
    try:
        signal.signal(signal.SIGUSR1, on_usr1)
    except (ValueError, AttributeError):
        pass

    best_score = None
    best_step = trainer.loaded_step or 0
    patience_left = cfg.patience
    batch_iterator = train_set.endless_iterator() if cfg.max_steps else None

    start_wall = time.time()
    try:
        if cfg.validate_at_start or cfg.only_validate:
            scores = evaluate(cfg, task, trainer, valid_sets,
                              generator_factory)
            check_scores(cfg, scores, trainer.step)

        while trainer.step < (cfg.max_steps or 0):
            if pending["signal"] is not None:
                raise pending["signal"]()
            logs = trainer.train_step(batch_iterator)
            step = trainer.step

            if step % cfg.log_interval == 0:
                m = trainer.metrics
                wall = m.timer("train_wall").elapsed
                ups = m.sum("updates") / max(wall, 1e-6)
                wps = m.sum("wps") / max(wall, 1e-6)
                m.timer("train_wall").elapsed = 0
                nll = m.avg("nll_loss")
                logger.info(
                    f"step {step} | loss {m.avg('loss'):.3f} | "
                    f"nll_loss {nll:.3f} | ppl {2 ** (nll / np.log(2)):.2f} | "
                    f"wps {wps:.0f} | ups {ups:.2f} | wpb {m.avg('wps'):.0f} | "
                    f"bsz {m.avg('bsz'):.1f} | gnorm {m.avg('gnorm'):.3f} | "
                    f"lr {logs['lr']:.3e}")

            if cfg.save_interval and step % cfg.save_interval == 0:
                trainer.save()
                trainer.cleanup(best_step=best_step)

            if cfg.valid_interval and step % cfg.valid_interval == 0:
                scores = evaluate(cfg, task, trainer, valid_sets,
                                  generator_factory)
                check_scores(cfg, scores, step)
                metric = cfg.early_stopping_metric or "nll_loss"
                values = [s.get(metric) for name, s in scores.items()
                          if s.get(metric) is not None
                          and getattr(valid_sets[name].corpus, "early_stopping",
                                      True)]
                if values:
                    value = float(np.mean(values))
                    if best_score is None or is_better(metric, value, best_score):
                        best_score, best_step = value, step
                        from pasero_torch.checkpoints import mark_best
                        if os.path.exists(os.path.join(cfg.model_dir,
                                                       f"model_{step}.npz")):
                            mark_best(cfg.model_dir, step)
                        patience_left = cfg.patience
                    elif (cfg.patience is not None
                          and step >= cfg.patience_min_steps):
                        patience_left = (patience_left or 0) - 1
                        if patience_left < 0:
                            logger.info("early stopping: out of patience")
                            break
    except Interrupt:
        pending["signal"] = None
        logger.info("interrupted: saving model_latest and exiting 143")
        trainer.save(name="model_latest", update_last=False, blocking=True)
        sys.exit(143)
    except Restart:
        pending["signal"] = None
        trainer.save(blocking=True)
        raise
    finally:
        if hasattr(train_set, "close"):
            train_set.close()

    if cfg.max_steps and trainer.step > trainer.loaded_step:
        trainer.save(blocking=True)
        trainer.cleanup(best_step=best_step)
    trainer.finalize()
    logger.info(f"done at step {trainer.step} "
                f"({time.time() - start_wall:.0f}s)")
    log_launches(trainer)
    return trainer


def log_launches(trainer):
    """The run's kernel launches beside the batches that should cause them
    (read by chip_smoke.py): one fused-CE forward per training micro-batch
    and per validation batch, one backward per training micro-batch; a
    model whose attention takes the flash kernels launches one flash
    forward per layer and batch, one backward per layer and micro-batch (the
    biased kernels with an ALiBi bias, and no dbias kernel: the bias is a
    constant)."""
    from pasero_torch.ops import flash_attention as fa
    from pasero_torch.ops.cache_update import cache_slot_write_
    from pasero_torch.ops.fused_ce import fused_ce_bwd, fused_ce_fwd
    micro = (trainer.step - trainer.loaded_step) * max(
        1, trainer.cfg.virtual_dp_size)
    flash = " | ".join(f"{name} {n}"
                       for name, n in fa.launch_counts().items())
    logger.info(f"launches | fused_ce_fwd {fused_ce_fwd.launches} | "
                f"fused_ce_bwd {fused_ce_bwd.launches} | cache_slot_write "
                f"{cache_slot_write_.launches} | {flash} | train micro-batches "
                f"{micro} | valid batches {trainer.valid_batches}")


def split_device(args: list) -> tuple:
    """(TrainingConfig arguments, --device value or None)."""
    args, device = list(args), None
    for i, arg in enumerate(args):
        if arg == "--device" and i + 1 < len(args):
            device = args[i + 1]
            return args[:i] + args[i + 2:], device
        if arg.startswith("--device="):
            return args[:i] + args[i + 1:], arg.split("=", 1)[1]
    return args, device


def main(argv=None):
    from pasero_torch import resolve_device
    from pasero_torch.config import TrainingConfig
    args, device = split_device(sys.argv[1:] if argv is None else argv)
    try:
        device = resolve_device(device)
    except RuntimeError as e:
        raise RuntimeError(f"{e} (pass --device cpu to train on the CPU)")
    while True:
        cfg = TrainingConfig(*args)
        try:
            run_training(cfg, device=device)
            return
        except Restart:
            logger.info("SIGUSR1: reloading training.yaml and restarting")
            training_yaml = os.path.join(cfg.model_dir, "training.yaml")
            if os.path.exists(training_yaml):
                args = ["--config", training_yaml]
            continue


if __name__ == "__main__":
    main()
