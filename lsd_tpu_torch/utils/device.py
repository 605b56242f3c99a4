"""Device resolution for the port's entry points.

CUDA is the default.  The CPU is used only when the caller asks for it
(``device="cpu"``, as the tests do); a call that names no device on a
machine without a card raises instead of falling back quietly.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the torch device an entry point should run on."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "lsd_tpu_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev

