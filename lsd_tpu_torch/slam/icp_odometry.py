"""LiDAR-only scan-matching odometry, no IMU (counterpart of
``lsd_tpu/slam/icp_odometry.py``).

Frame-to-map registration odometry for when no IMU/INS is present:
maintain a local surfel map, align each incoming scan to it with
point-to-plane Gauss-Newton starting from a constant-velocity prediction,
and insert the aligned scan.  The alignment runs on the odometry's device;
the host keeps the pose (float64) and fetches it once per scan.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..geometry import np_so3, so3
from ..ops.surfel import surfel_create, surfel_insert, surfel_match, surfel_trim
from ..ops.voxelize import voxel_downsample
from ..utils.device import DeviceLike, resolve_device, to_device
from ..utils.precision import slam_f32


@dataclasses.dataclass
class IcpOdometryConfig:
    scan_voxel: float = 0.5
    ds_capacity: int = 8192
    map_capacity: int = 2 ** 17
    map_voxel: float = 0.5
    map_radius: float = 300.0
    recenter_thresh: float = 60.0
    iters: int = 8
    plane_thresh: float = 0.15


@slam_f32
def _align_step(m, pts, mask, q, t):
    """One plane search and Gauss-Newton step; makes no host sync."""
    pw = so3.quat_rotate(q[None], pts) + t
    normals, d, ok, _rms = surfel_match(m, pw, mask, 0.15)
    r = torch.einsum("ni,ni->n", pw, normals) + d
    w = (mask & ok & (torch.abs(r) < 1.0)).to(pts.dtype)
    nR = normals @ so3.quat_to_matrix(q)
    H = torch.cat([-torch.linalg.cross(nR, pts), normals], dim=-1) * w[:, None]
    A = H.T @ H + 1e-4 * torch.eye(6, dtype=pts.dtype, device=pts.device)
    b = H.T @ (r * w)
    dx = -torch.linalg.solve_ex(A, b).result
    q2 = so3.quat_normalize(so3.quat_mul(q, so3.quat_from_rotvec(dx[:3])))
    return q2, t + dx[3:], torch.sum(w)


class IcpOdometry:
    def __init__(self, cfg: IcpOdometryConfig = IcpOdometryConfig(),
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.map = surfel_create(cfg.map_capacity, cfg.map_voxel, device=self.device)
        self.pose = np.eye(4)
        self.prev_delta = np.eye(4)     # constant-velocity prediction
        self.map_center = np.zeros(3)
        self.initialized = False

    def process_scan(self, points: np.ndarray, mask: np.ndarray) -> Dict:
        cfg, dev = self.cfg, self.device
        pts = to_device(points, dev, torch.float32)[:, :3]
        msk = to_device(mask, dev)
        ds, ds_mask = voxel_downsample(pts, msk, cfg.scan_voxel, cfg.ds_capacity)
        ds = ds[:, :3]

        nvalid = 0
        if self.initialized:
            guess = self.pose @ self.prev_delta
            g = to_device(guess[:3], dev, torch.float32)
            q, t = so3.matrix_to_quat(g[:, :3]), g[:, 3]
            for _ in range(cfg.iters):
                q, t, n_dev = _align_step(self.map, ds, ds_mask, q, t)
            # one fetch per scan: the pose and the inlier count
            flat = torch.cat([q, t, n_dev[None]]).cpu().numpy()
            new_pose = np.eye(4)
            new_pose[:3, :3] = np_so3.quat_to_matrix(flat[:4])
            new_pose[:3, 3] = flat[4:7]
            nvalid = int(flat[7])
            self.prev_delta = np.linalg.inv(self.pose) @ new_pose
            self.pose = new_pose

        # insert into map at current pose
        Tw = to_device(self.pose[:3], dev, torch.float32)
        world = ds @ Tw[:, :3].T + Tw[:, 3]
        self.map = surfel_insert(self.map, world, ds_mask)
        if np.linalg.norm(self.pose[:3, 3] - self.map_center) > cfg.recenter_thresh:
            self.map = surfel_trim(self.map, Tw[:, 3], cfg.map_radius)
            self.map_center = self.pose[:3, 3].copy()
        self.initialized = True
        return dict(pose=self.pose.copy(), num_valid=nvalid)
