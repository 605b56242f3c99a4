"""Device resolution for the port's entry points.

CUDA is the default.  The CPU is used only when the caller asks for it
(``device="cpu"``, as the tests do); a call that names no device on a
machine without a card raises instead of falling back quietly.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
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


def to_device(a: Union[np.ndarray, torch.Tensor, list, tuple, float, int, bool],
              device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Host data as a tensor on ``device`` without stalling the host.

    A tensor already there passes through without a copy.  Host data bound
    for a card goes through pinned memory as a non-blocking copy: a plain
    copy from pageable memory makes the host wait for all queued work of
    the stream (a host sync per upload).  A program being traced
    (``torch.export``) records a plain copy: tracing cannot pin memory."""
    if isinstance(a, torch.Tensor) and a.device == device:
        return a if dtype is None else a.to(dtype)
    t = torch.as_tensor(a, dtype=dtype)
    if device.type == "cuda" and t.device.type == "cpu" and not torch.compiler.is_compiling():
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def fetch(*tensors: torch.Tensor) -> list:
    """The tensors on the host through one packed copy (one host sync), as
    numpy arrays of their own dtypes; integers below 2**24 and booleans
    pass through the float32 pack exactly."""
    packed = torch.cat([t.reshape(-1).float() for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        part = packed[at:at + t.numel()].reshape(t.shape)
        out.append(part.astype(str(t.dtype).removeprefix("torch.")))
        at += t.numel()
    return out
