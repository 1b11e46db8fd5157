"""Checkpoint IO in pasero_tpu's format, and the JAX <-> PyTorch weight map.

A checkpoint is one flat ``model_{step}.npz``: '/'-joined flax parameter keys
mapping to float32 arrays (pasero_tpu/checkpoints.py:29-37,120-165), with
``model_best``/``model_last`` symlinks. Both packages read and write the same
files. ``params_to_state_dict`` carries the flat arrays into a module's
``state_dict``: '/' becomes '.', a flax ``Linear`` kernel (in, out) becomes
``weight`` (out, in), a LayerNorm ``scale`` becomes ``weight``, and an
``embedding`` table stays as it is. ``state_dict_to_params`` inverts it.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger("checkpoints")

CHECKPOINT_NAMES = ("model_best.npz", "model_latest.npz", "model_last.npz")


def params_to_state_dict(flat: dict) -> dict:
    """Flat flax params {'a/b/kernel': ndarray} -> torch state_dict."""
    out = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        value = np.asarray(value)
        if leaf == "kernel":
            if value.ndim != 2:
                raise ValueError(f"{key}: expected a 2-D Linear kernel, got "
                                 f"shape {value.shape}")
            leaf, value = "weight", value.T
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(path + [leaf])] = torch.tensor(value)   # a copy
    return out


def state_dict_to_params(state_dict: dict) -> dict:
    """torch state_dict -> flat flax params (the inverse of
    ``params_to_state_dict``): 2-D ``weight`` is a Linear kernel, 1-D
    ``weight`` a norm scale."""
    out = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        value = value.detach().cpu().numpy()
        if leaf == "weight":
            if value.ndim == 2:
                leaf, value = "kernel", value.T
            elif value.ndim == 1:
                leaf = "scale"
            else:
                raise ValueError(f"{key}: unexpected weight of shape "
                                 f"{value.shape}")
        out["/".join(path + [leaf])] = np.ascontiguousarray(value)
    return out


def load_flat(path: str) -> dict:
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def save_flat(path: str, flat: dict) -> None:
    """Write-then-rename, so a crash mid-save never corrupts a checkpoint."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def find_checkpoint(model_dir: str, ckpt: Optional[str] = None) -> str:
    """An explicit checkpoint (a path, or a file name in ``model_dir``), else
    model_best > model_latest > model_last, as pasero_tpu's
    DecodingAPIConfig resolves it."""
    if ckpt:
        path = ckpt if os.path.isfile(ckpt) else os.path.join(model_dir, ckpt)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"checkpoint {ckpt!r} not found")
        return path
    for name in CHECKPOINT_NAMES:
        path = os.path.join(model_dir, name)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"no checkpoint found in {model_dir!r}")


def load_into(module: torch.nn.Module, path: str,
              other_paths: tuple = ()) -> None:
    """Load a flat npz (plus ``other_paths`` merged on top) into ``module``.
    Missing, unexpected or mis-shaped parameters raise."""
    flat = load_flat(path)
    for other in other_paths:
        flat.update(load_flat(other))
    state = params_to_state_dict(flat)
    expected = module.state_dict()
    missing = [k for k in expected if k not in state]
    unexpected = [k for k in state if k not in expected]
    mismatched = [k for k in state if k in expected
                  and tuple(expected[k].shape) != tuple(state[k].shape)]
    if missing or unexpected or mismatched:
        raise ValueError(f"checkpoint mismatch: missing={missing[:5]} "
                         f"unexpected={unexpected[:5]} "
                         f"shape-mismatch={mismatched[:5]}")
    module.load_state_dict({k: v.to(expected[k].dtype)
                            for k, v in state.items()})
    logger.info(f"loaded {len(state)} parameters from {path}")


def save_checkpoint(model_dir: str, step: int, module: torch.nn.Module,
                    update_last: bool = True) -> str:
    """Write ``model_{step}.npz`` (and point ``model_last.npz`` at it)."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, f"model_{step}.npz")
    save_flat(path, state_dict_to_params(module.state_dict()))
    if update_last:
        link = os.path.join(model_dir, "model_last.npz")
        if os.path.islink(link) or os.path.exists(link):
            os.remove(link)
        os.symlink(os.path.basename(path), link)
    return path
