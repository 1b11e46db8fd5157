"""pasero_torch: the PyTorch / CUDA port of pasero_tpu for one NVIDIA H100.

The package mirrors pasero_tpu's file names (``pasero_torch/models/attention.py``
is the counterpart of ``pasero_tpu/models/attention.py``) and imports nothing
of it: the jax-free front half (config, tokenizers, preprocessing, tasks,
metrics) is kept as a copy. Every Pallas kernel on a ported path becomes a
kernel written by hand for Hopper (``csrc/``), with a plain PyTorch version
beside it that CPU tensors take.
"""

from __future__ import annotations

__version__ = "0.1.0"


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a feature a later slice brings; ``item`` names its
    ROADMAP.md entry (queue A)."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item})")


def resolve_device(device=None):
    """The torch device an entry point runs on.

    ``None`` means the card: ``cuda`` when CUDA is available, else an error —
    an entry point never carries on silently on the CPU. Pass ``"cpu"`` to
    run there on purpose (the tests do).
    """
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pasero_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' (CLI: --device cpu) to run on "
                "the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


# populate the task registry (translation and language modeling); imported
# last, since the modules it reaches import the helpers above
from . import tasks as _tasks  # noqa: E402,F401
