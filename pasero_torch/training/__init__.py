"""Training: the single-device Trainer (pasero_tpu/training)."""

from .trainer import Trainer, shift_targets

__all__ = ["Trainer", "shift_targets"]
