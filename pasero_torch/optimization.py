"""Optimizer and learning-rate schedules (PyTorch counterpart of
pasero_tpu/optimization.py).

``make_optimizer`` is the optax chain of the JAX package written out for
named float32 tensors: clip by global norm (only when ``clip_norm > 0``),
Adam with float32 moments, weight decay on every trainable tensor, then the
learning rate; a ``trainable_mask`` restricts the chain to the trainable
tensors. The arithmetic follows optax 0.2 step for step, so the two packages
update the same weights alike:

- the clip scales by ``max_norm / norm`` when ``norm >= max_norm``, with no
  epsilon (not ``torch.nn.utils.clip_grad_norm_``), and its norm covers the
  trainable tensors only;
- Adam keeps ``eps = 1e-8`` outside the square root and corrects the bias
  with ``1 - beta ** count`` in float32;
- the learning rate reads the optimizer's own update count, which starts at
  0, so the first update uses ``schedule(0)``, and the inverse-sqrt schedule
  clamps the step to 1 (updates 1 and 2 both use ``lr / warmup``).

One difference is deliberate: a frozen tensor stays as it is. In the JAX
package ``optax.masked`` hands a frozen leaf's gradient back as its update
and the trainer adds it (``p + u``), so a frozen parameter moves by its
gradient at every step (ROADMAP.md, queue C).

There is no loss scaling: ``--dtype float16`` maps to bfloat16, which needs
none.
"""

from __future__ import annotations

import re
from typing import Callable, Optional

import numpy as np
import torch

f32 = np.float32


def inverse_sqrt_schedule(lr: float, warmup: int, init_lr: float = 0.0,
                          min_lr: float = 0.0) -> Callable[[int], float]:
    """Linear warmup from ``init_lr`` to ``lr`` over ``warmup`` steps, then
    decay proportional to 1/sqrt(step); float32 arithmetic, as in JAX."""
    w = max(warmup, 1)

    def schedule(step: int) -> float:
        step = max(int(step), 1)
        warm = f32(init_lr) + f32(lr - init_lr) * f32(step) / f32(w)
        decay = f32(lr * w ** 0.5) * (f32(1.0) / np.sqrt(f32(step)))
        value = warm if step < warmup else decay
        return float(max(f32(value), f32(min_lr)))

    return schedule


def linear_decay_schedule(lr: float, max_steps: int, init_lr: float = 0.0,
                          min_lr: float = 0.0) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        frac = np.clip(f32(step) / f32(max(max_steps, 1)), f32(0), f32(1))
        return float(max(f32(lr) + f32(min_lr - lr) * frac, f32(min_lr)))

    return schedule


def lr_schedule_from_config(cfg) -> Callable[[int], float]:
    if cfg.warmup and cfg.warmup > 0:
        return inverse_sqrt_schedule(cfg.lr, cfg.warmup, cfg.init_lr,
                                     cfg.min_lr)
    return linear_decay_schedule(cfg.lr, cfg.max_steps or 1, cfg.init_lr,
                                 cfg.min_lr)


def trainable_mask(names, freeze_regex: Optional[str] = None,
                   train_regex: Optional[str] = None,
                   default_trainable: Optional[Callable[[str], bool]] = None
                   ) -> dict:
    """{name: bool}: which parameters receive updates.

    ``names`` are dotted flax parameter names
    (``encoder.layers_0.self_attn.q_proj.kernel``, see ``flax_name``), the
    names the --freeze-params-regex / --train-params-regex regexes match in
    the JAX package."""
    def decide(name: str) -> bool:
        if train_regex:
            return bool(re.search(train_regex, name))
        if freeze_regex:
            return not re.search(freeze_regex, name)
        if default_trainable is not None:
            return default_trainable(name)
        return True

    return {name: decide(name) for name in names}


def flax_name(name: str, tensor: torch.Tensor) -> str:
    """The dotted flax name of a module parameter: a 2-D ``weight`` is a
    Linear ``kernel``, a 3-D one a Conv ``kernel``, a 1-D one a norm
    ``scale`` (checkpoints.state_dict_to_params)."""
    prefix, _, leaf = name.rpartition(".")
    if leaf == "weight":
        leaf = "kernel" if tensor.dim() in (2, 3) else "scale"
    return f"{prefix}.{leaf}" if prefix else leaf


def global_norm(tensors) -> torch.Tensor:
    """The 2-norm of all tensors together, in float32 (the norm of the
    per-tensor norms)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        [t.float() for t in tensors])))


class Optimizer:
    """clip-by-global-norm -> Adam (float32 moments) -> weight decay -> lr,
    over the trainable tensors of ``params`` ({name: tensor}), updated in
    place by ``step(grads)``.

    State: ``count`` (the Adam and learning-rate count, one per update),
    and ``mu``/``nu`` per trainable tensor."""

    def __init__(self, cfg, params: dict, mask: Optional[dict] = None):
        self.schedule = lr_schedule_from_config(cfg)
        self.clip_norm = cfg.clip_norm if cfg.clip_norm and cfg.clip_norm > 0 \
            else None
        self.b1, self.b2 = (float(b) for b in cfg.adam_betas)
        self.eps = 1e-8
        self.weight_decay = cfg.weight_decay or 0.0
        self.params = params
        self.trainable = [k for k in params if mask is None or mask[k]]
        self.count = 0
        self.mu = {k: torch.zeros_like(params[k], dtype=torch.float32)
                   for k in self.trainable}
        self.nu = {k: torch.zeros_like(params[k], dtype=torch.float32)
                   for k in self.trainable}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        """One update from ``grads`` ({name: tensor}, already normalized by
        the token count); frozen tensors are left as they are. Multi-tensor
        (``_foreach``) operations, in optax's order of operations."""
        g = [grads[k].float() for k in self.trainable]
        if self.clip_norm is not None:
            norm = global_norm(g)
            # optax: keep when norm < max_norm, else (g / norm) * max_norm
            keep = norm < self.clip_norm
            one = torch.ones_like(norm)
            g = torch._foreach_mul(
                torch._foreach_div(g, torch.where(keep, one, norm)),
                torch.where(keep, one, one * self.clip_norm))
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        mu = [self.mu[k] for k in self.trainable]
        nu = [self.nu[k] for k in self.trainable]
        params = [self.params[k] for k in self.trainable]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1 - self.b2))
        den = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(nu, bc2)), self.eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        if self.weight_decay:
            u = torch._foreach_add(u, torch._foreach_mul(params,
                                                         self.weight_decay))
        torch._foreach_add_(params, torch._foreach_mul(u, -lr))

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        if set(state["mu"]) != set(self.mu) or set(state["nu"]) != set(self.nu):
            raise ValueError("optimizer state does not cover the trainable "
                             "parameters")
        self.count = int(state["count"])
        for k in self.trainable:
            self.mu[k].copy_(state["mu"][k])
            self.nu[k].copy_(state["nu"][k])


def make_optimizer(cfg, params: dict, mask: Optional[dict] = None
                   ) -> Optimizer:
    """The optimizer of ``cfg`` over ``params`` ({name: tensor}), restricted
    to ``mask``'s trainable names (pasero_tpu/optimization.py:93)."""
    return Optimizer(cfg, params, mask)
