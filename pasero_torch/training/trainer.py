"""Trainer: train and validation steps on one device, and checkpointing.

PyTorch counterpart of pasero_tpu/training/trainer.py, on one card (or the
CPU) with no device mesh:

- gradient accumulation over ``update_freq = virtual_dp_size`` micro-batches:
  each micro-batch's loss *sum* is differentiated and the gradients add up
  in ``.grad``; the sum is then divided by the total target-token count,
  its global norm is logged, and the optimizer clips and updates
  (pasero_tpu/training/trainer.py:335-356);
- the step's statistics are read back to the host once per update, not once
  per micro-batch;
- float32 master parameters and Adam moments, compute in the model's type;
- dropout draws from a ``torch.Generator`` seeded from ``cfg.seed``;
- checkpoints in the JAX package's flat npz format, with the optimizer state
  and ``state_{step}.json`` beside them, and the same resume rules.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from .. import checkpoints, not_ported, resolve_device
from ..optimization import (flax_name, global_norm, lr_schedule_from_config,
                            make_optimizer, trainable_mask)
from ..utils.metrics import Metrics

logger = logging.getLogger("train")

BATCH_KEYS = ("decoder_input", "target_mask", "prompt_mask", "src_tokens",
              "src_mask")


def shift_targets(decoder_input, pad_idx: int):
    """logits[t] predicts decoder_input[t+1]; the last column becomes
    padding."""
    return torch.cat([decoder_input[:, 1:],
                      torch.full_like(decoder_input[:, :1], pad_idx)], dim=1)


def check_supported(cfg) -> None:
    """Raise NotImplementedError for training options a later slice brings."""
    for name in ("dp_size", "tp_size", "ep_size", "cp_size", "pp_size"):
        if (getattr(cfg, name, 1) or 1) > 1:
            raise not_ported(f"--{name.replace('_', '-')} > 1",
                             "A.12 parallelism")
    if cfg.fsdp:
        raise not_ported("--fsdp", "A.12 parallelism")


class Trainer:
    def __init__(self, cfg, task, model, device=None,
                 metrics: Optional[Metrics] = None):
        check_supported(cfg)
        self.cfg = cfg
        self.task = task
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.metrics = metrics or Metrics(window=cfg.log_interval)
        self.pad_idx = model.cfg.padding_idx
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed or 0)
        model.set_dropout_generator(self.generator)
        self._checkpointer = checkpoints.AsyncCheckpointer()

        self.params = dict(model.named_parameters())
        logger.info(f"initialized {sum(p.numel() for p in self.params.values()):,}"
                    " parameters")
        names = {k: flax_name(k, p) for k, p in self.params.items()}
        by_flax = trainable_mask(names.values(), cfg.freeze_params_regex,
                                 cfg.train_params_regex)
        self.mask = {k: by_flax[names[k]] for k in self.params}
        trainable = sum(p.numel() for k, p in self.params.items()
                        if self.mask[k])
        logger.info(f"{trainable:,} trainable parameters")
        self.optimizer = make_optimizer(cfg, self.params, self.mask)
        self.schedule = lr_schedule_from_config(cfg)
        self.step = 0
        self.valid_batches = 0      # batches seen by valid_step
        self._load_checkpoint()

    # -- setup ---------------------------------------------------------------
    def _load_checkpoint(self):
        cfg = self.cfg
        self.loaded_step = 0
        path = checkpoints.find_checkpoint_to_load(cfg.model_dir, cfg.ckpt,
                                                   reset=cfg.reset)
        if path is None:
            return
        logger.info(f"loading checkpoint {path}")
        init = checkpoints.state_dict_to_params(self.model.state_dict())
        flat, *_ = checkpoints.load_params(
            path, init, flexible=cfg.flexible,
            reset_params_regex=cfg.reset_params_regex)
        with torch.no_grad():
            for key, value in checkpoints.params_to_state_dict(flat).items():
                self.params[key].copy_(value)
        is_latest = os.path.basename(path) == "model_latest.npz"
        tag = "latest" if is_latest else None
        step = checkpoints.checkpoint_step(cfg.model_dir, path)
        in_model_dir = os.path.realpath(path).startswith(
            os.path.realpath(cfg.model_dir))
        resume = in_model_dir and not cfg.reset_optimizer and step
        if resume or (cfg.continue_ and step and not cfg.reset_optimizer):
            opt_flat = checkpoints.load_optimizer_flat(cfg.model_dir,
                                                       tag or step)
            if opt_flat is not None:
                try:
                    self.optimizer.load_state_dict(
                        checkpoints.optimizer_from_flat(opt_flat))
                except (KeyError, ValueError, RuntimeError):
                    logger.warning("optimizer state mismatch; resetting "
                                   "optimizer")
            state_meta = checkpoints.load_state(cfg.model_dir, tag or step)
            if state_meta.get("metrics"):
                self.metrics.load_state_dict(state_meta["metrics"])
            self.step = self.loaded_step = step
            logger.info(f"resumed at step {step}")
        elif getattr(cfg, "only_validate", False) and step:
            # validation reports (and expected_scores gates) at the
            # checkpoint's own step
            self.step = self.loaded_step = step
        if is_latest:
            checkpoints.discard_latest(cfg.model_dir)

    # -- steps ---------------------------------------------------------------
    def _device_batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(batch[k])).to(self.device)
                for k in BATCH_KEYS if k in batch}

    def _loss(self, batch: dict, training: bool) -> tuple:
        """(loss_sum, nll_sum, weight sum) of one device batch
        (pasero_tpu/training/trainer.py:290-333, 358-382)."""
        targets = shift_targets(batch["decoder_input"], self.pad_idx)
        target_mask = shift_targets(batch["target_mask"].int(), 0).bool()
        weights = target_mask.float()
        prompt_loss = self.model.cfg.prompt_loss
        if training and prompt_loss != 1.0:
            prompt_mask = shift_targets(batch["prompt_mask"].int(), 0).bool()
            weights = weights * torch.where(prompt_mask, prompt_loss, 1.0)
        out = self.model(batch.get("src_tokens"), batch["decoder_input"],
                         src_mask=batch.get("src_mask"), targets=targets,
                         loss_weights=weights)
        count = target_mask.sum() if training else weights.sum()
        return out["loss_sum"], out["nll_sum"], count.float()

    def train_step(self, batch_iterator) -> dict:
        """One update: gradients summed over ``update_freq`` micro-batches."""
        cfg = self.cfg
        update_freq = max(1, cfg.virtual_dp_size)
        timers = self.metrics
        self.model.train()
        for p in self.params.values():
            p.grad = None
        totals = None
        bsz = wpb = 0
        with timers.timer("train_wall"):
            for _ in range(update_freq):
                with timers.timer("data"):
                    batch = next(batch_iterator)
                    device_batch = self._device_batch(batch)
                with timers.timer("forward_backward"):
                    loss_sum, nll_sum, num_tokens = self._loss(device_batch,
                                                               True)
                    loss_sum.backward()
                stats = torch.stack([loss_sum.detach(), nll_sum.detach(),
                                     num_tokens])
                totals = stats if totals is None else totals + stats
                bsz += batch.get("num_real_rows", len(batch["decoder_input"]))
                wpb += int(batch["target_mask"].sum())
            with timers.timer("optimizer"):
                denom = totals[2].clamp(min=1.0)
                with torch.no_grad():
                    grads = torch._foreach_div(
                        [p.grad if p.grad is not None else torch.zeros_like(p)
                         for p in self.params.values()], denom)
                    gnorm = global_norm(grads)
                    self.optimizer.step(dict(zip(self.params, grads)))
                self.step += 1
            # the one read-back of the update
            loss_total, nll_total, num_tokens, gnorm = torch.cat(
                [totals, gnorm[None]]).tolist()

        logs = {
            "loss": loss_total / max(1.0, num_tokens),
            "nll_loss": nll_total / max(1.0, num_tokens),
            "gnorm": gnorm,
            "lr": self.schedule(self.step),
            "wpb": wpb, "bsz": bsz, "num_tokens": num_tokens,
        }
        m = self.metrics
        m.update("loss", logs["loss"] * num_tokens, n=int(num_tokens))
        m.update("nll_loss", logs["nll_loss"] * num_tokens, n=int(num_tokens))
        m.update("gnorm", logs["gnorm"])
        m.update("wps", wpb)
        m.update("bsz", bsz)
        m.update("updates", 1)
        return logs

    @torch.no_grad()
    def valid_step(self, batch: dict) -> dict:
        self.model.eval()
        self.valid_batches += 1
        loss_sum, nll_sum, num_tokens = self._loss(self._device_batch(batch),
                                                   False)
        values = torch.stack([loss_sum, nll_sum, num_tokens]).tolist()
        return dict(zip(("loss_sum", "nll_sum", "num_tokens"), values))

    # -- checkpointing -------------------------------------------------------
    def save(self, name: Optional[str] = None, update_last: bool = True,
             blocking: Optional[bool] = None):
        """Checkpoint; with --async-save only the npz write runs in a
        background thread (one save in flight; the next save joins it). The
        copy to host memory happens here, before training goes on."""
        cfg = self.cfg
        mask_flat = None
        if cfg.save_trainable_only:
            mask_flat = {flax_name(k, p).replace(".", "/"): self.mask[k]
                         for k, p in self.params.items()}
        if blocking is None:
            blocking = not getattr(cfg, "async_save", False)
        params_host = checkpoints.state_dict_to_params(self.model.state_dict())
        opt_flat = checkpoints.optimizer_to_flat(self.optimizer.state_dict())
        if not blocking:
            # on the CPU these arrays are views of the live tensors, which the
            # next update changes in place while the writer runs
            params_host = {k: v.copy() for k, v in params_host.items()}
            opt_flat = {k: v.copy() for k, v in opt_flat.items()}
        step, extra = self.step, {"metrics": self.metrics.state_dict()}

        def write():
            return checkpoints.save_checkpoint(
                cfg.model_dir, step, params_host, opt_state_flat=opt_flat,
                extra=extra, name=name, trainable_mask=mask_flat,
                update_last=update_last)

        if blocking:
            self._checkpointer.wait()
            return write()
        self._checkpointer.submit(write)
        return os.path.join(cfg.model_dir, f"{name or f'model_{step}'}.npz")

    def cleanup(self, best_step: Optional[int] = None):
        # never join an in-flight async write here; only surface its error
        self._checkpointer.check()
        checkpoints.cleanup_checkpoints(
            self.cfg.model_dir, keep_last=self.cfg.keep_last,
            keep_interval=self.cfg.keep_interval, best_step=best_step)

    def finalize(self):
        """Join any in-flight async save (once, at the end of training)."""
        self._checkpointer.wait()
