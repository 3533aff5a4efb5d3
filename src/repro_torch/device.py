"""The port's device rule: entry points run on the card unless asked not to.

Every entry point takes ``device=None``; ``None`` means ``"cuda"``.  Without
CUDA the call raises instead of quietly running on the CPU — the CPU is used
only when the caller names it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Map ``device`` to a ``torch.device``; raise if CUDA is asked for (or
    defaulted to) on a machine without it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev

