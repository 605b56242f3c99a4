"""Full-fp32 matmul policy for the SLAM path.

Counterpart of ``lsd_tpu/utils/precision.py``: the reference traces its SLAM
functions under float32 matmul precision because bf16-truncated matmuls
cost about 10x in trajectory error (ATE 0.0214 m vs 0.0017 m on the
225-scan circle benchmark).  On Hopper the equivalent truncation is TF32,
which PyTorch enables by default for cuDNN convolutions and may be enabled
for matmuls; the SLAM entry points turn both off.
"""
from __future__ import annotations

import functools

import torch


def set_slam_precision() -> None:
    """fp32 matmuls and convolutions, TF32 off (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def slam_f32(fn):
    """Decorator: run ``fn`` with the fp32 / no-TF32 policy set."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        set_slam_precision()
        return fn(*args, **kwargs)
    return wrapped
