"""The LIO replay as the plain reference runs it: ``lio_step`` over the
scans the program ran, from the same start, in a precision the caller sets."""
from __future__ import annotations

import numpy as np
import torch

from . import so3
from .lio import LioConfig, lio_init, lio_step
from .state import init_state


def set_precision(tf32: bool) -> None:
    """float32 matmuls with TF32 off (the configuration's precision), or
    with TF32 on (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def replay(lio: dict, lap, start, n_scans: int, device, tf32: bool = False):
    """``n_scans`` scans of the repeated ``lap`` (host arrays: points,
    stamps, mask, imu, imu_mask, each with a leading scan axis) from the
    start pose ``start`` = (R, p, v).  Returns (poses (n, 4, 4), P (n, 24,
    24)) as float64 numpy, and the surfel map after the last scan as numpy
    (keys, coords, moments)."""
    set_precision(tf32)
    try:
        cfg = LioConfig(**lio)
        R, p, v = start
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        nav = init_state(device=device)._replace(pos=f(p), quat=so3.matrix_to_quat(f(R)),
                                                 vel=f(v))
        st = lio_init(cfg, nav)
        K = lap[0].shape[0]
        poses, covs = [], []
        for k in range(n_scans):
            scan = [torch.as_tensor(a[k % K], device=device) for a in lap]
            st, info = lio_step(cfg, st, *scan)
            poses.append(info["pose"])
            covs.append(st.P)
        poses = torch.stack(poses).double().cpu().numpy()
        covs = torch.stack(covs).double().cpu().numpy()
        m = tuple(t.cpu().numpy() for t in (st.map.keys, st.map.coords, st.map.moments))
        return poses, covs, m
    finally:
        set_precision(False)
