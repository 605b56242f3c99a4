"""Synthetic LiDAR+IMU world simulator (numpy only).

A copy of ``SimConfig`` and ``CircleSim`` from ``lsd_tpu/sim.py``, kept in
the port so that it can make scans without importing the JAX package.  The
simulator synthesizes a structured world (ground plane, a ring of wall
patches, interior pillars), an analytic circular trajectory, and
motion-distorted, per-point-timestamped scans with exact IMU, so the LIO
step can be checked against a known ground truth.  The same config and seed
give the same scans as the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class SimConfig:
    radius: float = 10.0          # trajectory radius (m)
    omega: float = 0.25           # yaw rate (rad/s)
    scan_hz: float = 10.0
    imu_hz: float = 100.0
    n_scans: int = 50
    points_per_scan: int = 16384
    max_range: float = 40.0
    point_noise: float = 0.0      # per-axis lidar noise sigma (m)
    gyro_noise: float = 0.0       # rad/s
    acc_noise: float = 0.0        # g
    seed: int = 0
    # realistic cold start: sit still for ``rest_time`` seconds (so an
    # IMU-at-rest initializer, e.g. FAST-LIO's gravity/bias estimator, can
    # converge), then spin up to ``omega`` linearly over ``ramp_time``.
    # Defaults preserve the original instant-motion trajectory.
    rest_time: float = 0.0
    ramp_time: float = 0.0
    # constant IMU biases (robustness scenarios; the filter carries bias
    # states and should absorb these)
    gyro_bias: Tuple[float, float, float] = (0.0, 0.0, 0.0)   # rad/s
    acc_bias: Tuple[float, float, float] = (0.0, 0.0, 0.0)    # g
    # corridor scenarios (CorridorSim)
    speed: float = 2.5                # cruise speed (m/s)
    corridor_half_width: float = 3.0  # wall distance from centerline (m)
    feature_density: float = 1.0      # door-frame/clutter density scale;
                                      # 0 = perfectly smooth (degenerate)


def _rz(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


class CircleSim:
    """Circular trajectory through a room-like world."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.world = self._build_world()

    # ---- world ---------------------------------------------------------
    def _build_world(self) -> np.ndarray:
        cfg = self.cfg
        rng = self.rng
        pts = []
        # ground plane (annulus around the trajectory)
        n_g = 120000
        r = np.sqrt(rng.uniform(0.0, 1.0, n_g)) * (cfg.radius + 25.0)
        th = rng.uniform(0, 2 * np.pi, n_g)
        ground = np.stack([r * np.cos(th), r * np.sin(th), np.zeros(n_g)], axis=1)
        pts.append(ground)
        # ring of vertical wall patches (buildings) outside the loop
        n_walls = 36
        for i in range(n_walls):
            ang = 2 * np.pi * i / n_walls + rng.uniform(-0.05, 0.05)
            wr = cfg.radius + rng.uniform(6.0, 14.0)
            center = np.array([wr * np.cos(ang), wr * np.sin(ang), 2.5])
            # wall tangent to the ring, with random yaw jitter
            yaw = ang + np.pi / 2 + rng.uniform(-0.3, 0.3)
            t_dir = np.array([np.cos(yaw), np.sin(yaw), 0.0])
            n_w = 3000
            u = rng.uniform(-4.0, 4.0, n_w)
            v = rng.uniform(-2.5, 2.5, n_w)
            wall = center + u[:, None] * t_dir + v[:, None] * np.array([0.0, 0.0, 1.0])
            pts.append(wall)
        # a few interior pillars for extra constraint diversity
        for i in range(8):
            ang = 2 * np.pi * i / 8
            c = np.array([(cfg.radius - 4.0) * np.cos(ang), (cfg.radius - 4.0) * np.sin(ang), 1.5])
            yaw = rng.uniform(0, np.pi)
            t_dir = np.array([np.cos(yaw), np.sin(yaw), 0.0])
            u = rng.uniform(-1.0, 1.0, 800)
            v = rng.uniform(-1.5, 1.5, 800)
            pts.append(c + u[:, None] * t_dir + v[:, None] * np.array([0.0, 0.0, 1.0]))
        return np.concatenate(pts, axis=0).astype(np.float64)

    # ---- analytic trajectory ------------------------------------------
    def _profile(self, t: float) -> Tuple[float, float, float]:
        """(theta, omega, alpha) of the trajectory angle at time t,
        honoring the rest + linear spin-up profile."""
        cfg = self.cfg
        t0, tr = cfg.rest_time, cfg.ramp_time
        if t0 == 0.0 and tr == 0.0:       # original instant-cruise profile
            return cfg.omega * t, cfg.omega, 0.0
        if t <= t0:
            return 0.0, 0.0, 0.0
        if tr > 0.0 and t < t0 + tr:
            dt = t - t0
            a = cfg.omega / tr
            return 0.5 * a * dt * dt, a * dt, a
        th0 = 0.5 * cfg.omega * tr if tr > 0.0 else 0.0
        return th0 + cfg.omega * (t - t0 - tr), cfg.omega, 0.0

    def pose(self, t: float) -> Tuple[np.ndarray, np.ndarray]:
        """Return (R_wb, p_w) at time t."""
        cfg = self.cfg
        th, _, _ = self._profile(t)
        p = np.array([cfg.radius * np.cos(th), cfg.radius * np.sin(th), 1.8])
        yaw = th + np.pi / 2
        return _rz(yaw), p

    def velocity(self, t: float) -> np.ndarray:
        cfg = self.cfg
        th, w, _ = self._profile(t)
        s = cfg.radius * w
        return np.array([-s * np.sin(th), s * np.cos(th), 0.0])

    def imu_sample(self, t: float) -> np.ndarray:
        """[t, gyro(3) rad/s, accel(3) g-units] in body frame."""
        cfg = self.cfg
        R, _ = self.pose(t)
        th, w, al = self._profile(t)
        # a_w = d2p/dt2: centripetal (r w^2 inward) + tangential (r alpha)
        a_w = (np.array([-np.cos(th), -np.sin(th), 0.0]) * cfg.radius * w * w
               + np.array([-np.sin(th), np.cos(th), 0.0]) * cfg.radius * al)
        g_w = np.array([0.0, 0.0, -9.81])
        acc_b = R.T @ (a_w - g_w) / 9.81
        gyr_b = np.array([0.0, 0.0, w])
        gyr_b = gyr_b + self.rng.normal(0, cfg.gyro_noise, 3) + np.asarray(cfg.gyro_bias)
        acc_b = acc_b + self.rng.normal(0, cfg.acc_noise, 3) + np.asarray(cfg.acc_bias)
        return np.array([t, *gyr_b, *acc_b])

    # ---- scan generation ----------------------------------------------
    def scan(self, t0: float) -> Tuple[np.ndarray, np.ndarray]:
        """Generate one sweep starting at t0.

        Returns (points (N,3) float32 in the lidar frame at each point's own
        capture time — i.e. motion-distorted, like a real spinning lidar —
        and stamps (N,) float32 seconds from scan start).
        """
        cfg = self.cfg
        period = 1.0 / cfg.scan_hz
        _, p0 = self.pose(t0)
        d2 = np.sum((self.world[:, :2] - p0[None, :2]) ** 2, axis=1)
        near = np.flatnonzero(d2 < cfg.max_range ** 2)
        take = self.rng.choice(near, size=min(cfg.points_per_scan, near.size), replace=False)
        pw = self.world[take]
        # stamp by azimuth angle in the start frame (spinning sweep)
        rel = pw - p0[None, :]
        az = np.arctan2(rel[:, 1], rel[:, 0])
        stamps = (az + np.pi) / (2 * np.pi) * period
        # transform each point into the lidar frame at its capture time
        order = np.argsort(stamps)
        pw, stamps = pw[order], stamps[order]
        pts_l = np.empty_like(pw)
        # batch by unique-ish stamp buckets for speed
        n_buckets = 64
        bucket = np.minimum((stamps / period * n_buckets).astype(int), n_buckets - 1)
        for b in range(n_buckets):
            sel = bucket == b
            if not np.any(sel):
                continue
            tb = t0 + (b + 0.5) / n_buckets * period
            R, p = self.pose(tb)
            pts_l[sel] = (pw[sel] - p) @ R
        if cfg.point_noise > 0:
            pts_l = pts_l + self.rng.normal(0, cfg.point_noise, pts_l.shape)
        return pts_l.astype(np.float32), stamps.astype(np.float32)

    def imu_batch(self, t0: float) -> np.ndarray:
        """IMU samples covering (t0 - dt, t0 + period], stamps rel to t0."""
        cfg = self.cfg
        period = 1.0 / cfg.scan_hz
        dt = 1.0 / cfg.imu_hz
        ts = np.arange(t0, t0 + period + dt / 2, dt)
        batch = np.stack([self.imu_sample(t) for t in ts])
        batch[:, 0] -= t0
        return batch

    def duration(self) -> float:
        return self.cfg.n_scans / self.cfg.scan_hz

    def generate(self, capacity: int = 16384, imu_capacity: int = 16,
                 t_start: float = 0.0):
        """Yield (points, stamps, mask, imu, imu_mask, gt_pose) per scan,
        all padded to static shapes.  ``t_start`` offsets the trajectory
        (e.g. a second mapping session covering a different arc)."""
        cfg = self.cfg
        period = 1.0 / cfg.scan_hz
        out = []
        for k in range(cfg.n_scans):
            t0 = t_start + k * period
            pts, stamps = self.scan(t0)
            n = min(len(pts), capacity)
            P = np.zeros((capacity, 3), np.float32)
            S = np.zeros((capacity,), np.float32)
            M = np.zeros((capacity,), bool)
            P[:n], S[:n], M[:n] = pts[:n], stamps[:n], True
            imu = self.imu_batch(t0)
            m = min(len(imu), imu_capacity)
            I = np.zeros((imu_capacity, 7), np.float32)
            IM = np.zeros((imu_capacity,), bool)
            I[:m], IM[:m] = imu[:m], True
            # ground-truth pose at scan END (LIO estimates scan-end pose)
            R, p = self.pose(t0 + period)
            T = np.eye(4)
            T[:3, :3], T[:3, 3] = R, p
            out.append((P, S, M, I, IM, T))
        return out
