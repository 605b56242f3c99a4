"""SE(3) rigid transforms in PyTorch (counterpart of ``lsd_tpu/geometry/se3.py``).

Poses are 4x4 homogeneous matrices, batchable as (..., 4, 4).
"""
from __future__ import annotations

import torch


def make_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # built on the device (no host-to-device copy per call)
    bottom = R.new_zeros(*batch, 1, 4)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)
