"""Motion-compensated multi-frame point accumulation.

A numpy-only copy of ``lsd_tpu/detection/accumulate.py``; the port imports
nothing of the JAX package.

Re-derivation of the reference's detection preprocessing
(sensor_driver/inference/tensorRT/voxelize/preprocess_kernel.cu:7-17 with
A/B buffers in lidar_inference.cpp): previous scans are carried forward
through the per-frame ego motion and concatenated with the current scan,
with a timestamp-lag feature channel — the 2-frame accumulation behind the
CenterPoint-VoxelNet 4-frame results (README.md:43-47).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class FrameAccumulator:
    def __init__(self, num_frames: int = 2, capacity_per_frame: int = 2 ** 17):
        self.num_frames = max(1, int(num_frames))
        self.cap = capacity_per_frame
        self.history = []     # list of (points (N,4) in THEIR OWN frame-at-capture, lag)

    def reset(self) -> None:
        self.history = []

    def push(self, points: np.ndarray, mask: np.ndarray,
             motion: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Feed the newest scan + ego motion (prev->curr, 4x4).

        Returns (points (M, 5), mask (M,)) where column 4 is the frame lag
        (0 = newest), M = num_frames * capacity_per_frame, newest first.
        """
        pts = np.asarray(points, np.float32)
        m = np.asarray(mask, bool)
        n = min(int(m.sum()), self.cap)
        cur = pts[m][:n]
        inv = np.linalg.inv(motion) if motion is not None else np.eye(4)

        # age existing history into the new frame's coordinates
        aged = []
        for (p_old, lag) in self.history[: self.num_frames - 1]:
            p = p_old.copy()
            p[:, :3] = p[:, :3] @ inv[:3, :3].T + inv[:3, 3]
            aged.append((p, lag + 1))
        self.history = [(cur[:, :4].copy(), 0)] + aged

        out = np.zeros((self.num_frames * self.cap, 5), np.float32)
        out_mask = np.zeros(self.num_frames * self.cap, bool)
        off = 0
        for (p, lag) in self.history:
            k = min(len(p), self.cap)
            out[off:off + k, :4] = p[:k, :4]
            out[off:off + k, 4] = lag
            out_mask[off:off + k] = True
            off += self.cap
        return out, out_mask
