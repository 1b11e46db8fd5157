"""Checkpoint IO in pasero_tpu's format, and the JAX <-> PyTorch weight map.

A checkpoint is one flat ``model_{step}.npz``: '/'-joined flax parameter keys
mapping to float32 arrays (pasero_tpu/checkpoints.py:29-37,120-165), with
``model_best``/``model_last``/``model_latest`` symlinks and files. Both
packages read and write the same model files. ``params_to_state_dict``
carries the flat arrays into a module's ``state_dict``: '/' becomes '.', a
flax ``Linear`` kernel (in, out) becomes ``weight`` (out, in), a flax
``nn.Conv`` kernel (k, in, out) becomes ``conv1d``'s ``weight`` (out, in,
k), a LayerNorm ``scale`` becomes ``weight``, and an ``embedding`` table
stays as it is.
``state_dict_to_params`` inverts it.

Beside a model file, training writes ``optimizer_{step}.npz`` and
``state_{step}.json`` (step and metrics), as pasero_tpu does. The optimizer
file uses the port's own keys (pasero_tpu's are optax tree paths):
``count`` (int32 scalar, the update count) and ``mu/<flat key>`` /
``nu/<flat key>`` (float32 Adam moments in the model file's layout, so a
Linear's moments are stored (in, out) like its kernel), one pair per
trainable parameter.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
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
            if value.ndim not in (2, 3):
                raise ValueError(f"{key}: expected a 2-D Linear or 3-D Conv "
                                 f"kernel, got shape {value.shape}")
            leaf, value = "weight", value.T
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(path + [leaf])] = torch.tensor(value)   # a copy
    return out


def state_dict_to_params(state_dict: dict) -> dict:
    """torch state_dict -> flat flax params (the inverse of
    ``params_to_state_dict``): 2-D ``weight`` is a Linear kernel, 1-D
    ``weight`` a norm scale, 3-D ``weight`` a Conv kernel."""
    out = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        value = value.detach().cpu().numpy()
        if leaf == "weight":
            if value.ndim in (2, 3):
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


def _symlink(target: str, link: str):
    if os.path.islink(link) or os.path.exists(link):
        os.remove(link)
    os.symlink(os.path.basename(target), link)


def optimizer_to_flat(state: dict) -> dict:
    """The optimizer state ({"count", "mu", "nu"} keyed by module parameter
    names) as flat arrays under the module docstring's keys."""
    flat = {"count": np.asarray(state["count"], np.int32)}
    for kind in ("mu", "nu"):
        for key, value in state_dict_to_params(state[kind]).items():
            flat[f"{kind}/{key}"] = value
    return flat


def optimizer_from_flat(flat: dict) -> dict:
    """Inverse of ``optimizer_to_flat``: {"count", "mu", "nu"} with torch
    tensors under module parameter names."""
    state = {"count": int(flat["count"])}
    for kind in ("mu", "nu"):
        sub = {k[len(kind) + 1:]: v for k, v in flat.items()
               if k.startswith(kind + "/")}
        state[kind] = params_to_state_dict(sub)
    return state


def save_checkpoint(model_dir: str, step: int, params,
                    opt_state_flat: Optional[dict] = None,
                    extra: Optional[dict] = None, name: Optional[str] = None,
                    trainable_mask: Optional[dict] = None,
                    update_last: bool = True) -> str:
    """Write ``{name or model_step}.npz`` (plus ``optimizer_{tag}.npz`` and
    ``state_{tag}.json``, tag = step, or 'latest' for the interrupt
    checkpoint ``model_latest``) and point ``model_last.npz`` at a numbered
    model file (pasero_tpu/checkpoints.py:120). ``params`` is a module or
    flat arrays; ``trainable_mask`` ({flat key: bool}) limits what is
    saved. Returns the model path."""
    os.makedirs(model_dir, exist_ok=True)
    name = name or f"model_{step}"
    tag = "latest" if name == "model_latest" else str(step)
    flat = (state_dict_to_params(params.state_dict())
            if isinstance(params, torch.nn.Module) else dict(params))
    if trainable_mask:
        flat = {k: v for k, v in flat.items() if trainable_mask.get(k, True)}
    path = os.path.join(model_dir, f"{name}.npz")
    save_flat(path, flat)
    if opt_state_flat is not None:
        save_flat(os.path.join(model_dir, f"optimizer_{tag}.npz"),
                  opt_state_flat)
    tmp = os.path.join(model_dir, f"state_{tag}.json.tmp")
    with open(tmp, "w") as f:
        json.dump({"step": step, **(extra or {})}, f)
    os.replace(tmp, os.path.join(model_dir, f"state_{tag}.json"))
    if update_last and name.startswith("model_") and name != "model_latest":
        _symlink(path, os.path.join(model_dir, "model_last.npz"))
    logger.info(f"saved checkpoint {path}")
    return path


class AsyncCheckpointer:
    """One-in-flight background checkpoint writer
    (pasero_tpu/checkpoints.py:69): the caller snapshots the tensors to host
    memory first, and only the npz write runs in the thread."""

    def __init__(self):
        self._thread = None
        self._error = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise()

    def check(self):
        """Surface a stored write error without joining an in-flight save."""
        if self._thread is not None and not self._thread.is_alive():
            self._thread.join()
            self._thread = None
        self._raise()

    def _raise(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, fn, *args, **kwargs):
        self.wait()

        def run():
            try:
                fn(*args, **kwargs)
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()


def mark_best(model_dir: str, step: int):
    path = os.path.join(model_dir, f"model_{step}.npz")
    if os.path.exists(path):
        _symlink(path, os.path.join(model_dir, "model_best.npz"))


def checkpoint_step(model_dir: str, model_path: str) -> Optional[int]:
    """The step of a model file: from its name, or from
    ``state_latest.json`` for the interrupt checkpoint."""
    base = os.path.basename(os.path.realpath(model_path))
    m = re.match(r"model_(\d+)\.npz", base)
    if m:
        return int(m.group(1))
    if base == "model_latest.npz":
        state = load_state(model_dir, "latest")
        if state.get("step"):
            return int(state["step"])
    return None


def discard_latest(model_dir: str):
    """Delete the interrupt checkpoint after a resume, so a stale
    model_latest never shadows a newer model_last."""
    for fname in ("model_latest.npz", "optimizer_latest.npz",
                  "state_latest.json"):
        path = os.path.join(model_dir, fname)
        if os.path.exists(path) or os.path.islink(path):
            os.remove(path)
            logger.info(f"removed interrupt checkpoint file {fname}")


def find_checkpoint_to_load(model_dir: str, ckpt: Optional[str] = None,
                            reset: bool = False) -> Optional[str]:
    """Training's resume order: model_latest > model_last > ``ckpt`` (a path
    or a file name in ``model_dir``)."""
    if not reset:
        for name in ("model_latest.npz", "model_last.npz"):
            path = os.path.join(model_dir, name)
            if os.path.exists(path):
                return path
    if ckpt:
        if os.path.isfile(ckpt):
            return ckpt
        path = os.path.join(model_dir, ckpt)
        if os.path.isfile(path):
            return path
        raise FileNotFoundError(f"checkpoint {ckpt!r} not found")
    return None


def load_params(path: str, init_flat: dict, flexible: bool = False,
                reset_params_regex: Optional[str] = None,
                other_paths: tuple = ()) -> tuple:
    """Load a flat npz into the keys and shapes of ``init_flat`` (flat
    arrays, e.g. ``state_dict_to_params(model.state_dict())``).

    Returns (flat params, missing, unexpected). Keys matching
    ``reset_params_regex`` are dropped from the file; missing keys keep
    their initial value; without ``flexible`` any mismatch raises."""
    loaded = load_flat(path)
    for other in other_paths:
        loaded.update(load_flat(other))
    if reset_params_regex:
        loaded = {k: v for k, v in loaded.items()
                  if not re.search(reset_params_regex, k)}
    missing = [k for k in init_flat if k not in loaded]
    unexpected = [k for k in loaded if k not in init_flat]
    mismatched = [k for k in loaded if k in init_flat
                  and init_flat[k].shape != loaded[k].shape]
    if (missing or unexpected or mismatched) and not flexible \
            and not reset_params_regex:
        raise ValueError(
            f"checkpoint mismatch: missing={missing[:5]}... "
            f"unexpected={unexpected[:5]}... shape-mismatch={mismatched[:5]}"
            f"... (use --flexible to load anyway)")
    out = {}
    for k, init in init_flat.items():
        value = loaded.get(k)
        out[k] = (value.astype(init.dtype)
                  if value is not None and value.shape == init.shape else init)
    if missing:
        logger.warning(f"{len(missing)} parameters missing from checkpoint")
    if unexpected:
        logger.warning(f"{len(unexpected)} unexpected checkpoint parameters")
    return out, missing, unexpected


def load_state(model_dir: str, step) -> dict:
    """``state_{step}.json``; ``step`` may be an int or 'latest'."""
    path = os.path.join(model_dir, f"state_{step}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def load_optimizer_flat(model_dir: str, step) -> Optional[dict]:
    """``optimizer_{step}.npz``; ``step`` may be an int or 'latest'."""
    path = os.path.join(model_dir, f"optimizer_{step}.npz")
    return load_flat(path) if os.path.exists(path) else None


def cleanup_checkpoints(model_dir: str, keep_last: int = 1,
                        keep_interval: Optional[int] = None,
                        best_step: Optional[int] = None):
    """Delete old numbered checkpoints, keeping the last ``keep_last``, the
    multiples of ``keep_interval``, the best and every symlink target."""
    steps = sorted(
        int(m.group(1)) for f in os.listdir(model_dir)
        if (m := re.fullmatch(r"model_(\d+)\.npz", f)))
    keep = set(steps[-keep_last:] if keep_last else [])
    if keep_interval:
        keep |= {s for s in steps if s % keep_interval == 0}
    if best_step is not None:
        keep.add(best_step)
    for link in ("model_last.npz", "model_best.npz", "model_latest.npz"):
        path = os.path.join(model_dir, link)
        if os.path.islink(path):
            m = re.match(r"model_(\d+)\.npz", os.readlink(path))
            if m:
                keep.add(int(m.group(1)))
    for s in steps:
        if s not in keep:
            for pattern in (f"model_{s}.npz", f"optimizer_{s}.npz",
                            f"state_{s}.json"):
                path = os.path.join(model_dir, pattern)
                if os.path.exists(path):
                    os.remove(path)
