"""LiDAR + IMU recordings of a vehicle on a circle through a room-like world.

A copy of the port's ``sim.CircleSim`` (itself the reference's) with one
change: the world (ground, 36 wall patches, 8 pillars) is drawn from
``world_seed`` and the sensor noise from ``seed``, so that a run's seed
changes the noise and never the geometry, and with it the work.
"""
from __future__ import annotations

import numpy as np

GRAVITY = 9.81


def _rz(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def build_world(radius: float, world_seed: int) -> np.ndarray:
    """(M, 3) world points: a ground annulus, a ring of walls outside the
    circle and pillars inside it (``CircleSim._build_world``)."""
    rng = np.random.default_rng(world_seed)
    pts = []
    n_g = 120000
    r = np.sqrt(rng.uniform(0.0, 1.0, n_g)) * (radius + 25.0)
    th = rng.uniform(0, 2 * np.pi, n_g)
    pts.append(np.stack([r * np.cos(th), r * np.sin(th), np.zeros(n_g)], axis=1))
    for i in range(36):
        ang = 2 * np.pi * i / 36 + rng.uniform(-0.05, 0.05)
        wr = radius + rng.uniform(6.0, 14.0)
        center = np.array([wr * np.cos(ang), wr * np.sin(ang), 2.5])
        yaw = ang + np.pi / 2 + rng.uniform(-0.3, 0.3)
        t_dir = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        u = rng.uniform(-4.0, 4.0, 3000)
        v = rng.uniform(-2.5, 2.5, 3000)
        pts.append(center + u[:, None] * t_dir + v[:, None] * np.array([0.0, 0.0, 1.0]))
    for i in range(8):
        ang = 2 * np.pi * i / 8
        c = np.array([(radius - 4.0) * np.cos(ang), (radius - 4.0) * np.sin(ang), 1.5])
        yaw = rng.uniform(0, np.pi)
        t_dir = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        u = rng.uniform(-1.0, 1.0, 800)
        v = rng.uniform(-1.5, 1.5, 800)
        pts.append(c + u[:, None] * t_dir + v[:, None] * np.array([0.0, 0.0, 1.0]))
    return np.concatenate(pts, axis=0).astype(np.float64)


class Circle:
    """The trajectory (x, y) = r (cos wt, sin wt) at 1.8 m, heading along it,
    with exact IMU readings; scans sample the world within ``max_range``,
    stamped by azimuth and distorted by the motion during the sweep."""

    def __init__(self, radius: float, omega: float, world_seed: int, seed: int,
                 points_per_scan: int, max_range: float = 40.0, point_noise: float = 0.01,
                 scan_hz: float = 10.0, imu_hz: float = 100.0):
        self.radius, self.omega = radius, omega
        self.points_per_scan, self.max_range = points_per_scan, max_range
        self.point_noise, self.scan_hz, self.imu_hz = point_noise, scan_hz, imu_hz
        self.world = build_world(radius, world_seed)
        self.rng = np.random.default_rng(seed)

    def pose(self, t: float):
        th = self.omega * t
        p = np.array([self.radius * np.cos(th), self.radius * np.sin(th), 1.8])
        return _rz(th + np.pi / 2), p

    def velocity(self, t: float) -> np.ndarray:
        th, s = self.omega * t, self.radius * self.omega
        return np.array([-s * np.sin(th), s * np.cos(th), 0.0])

    def imu_sample(self, t: float) -> np.ndarray:
        """[t, gyro (3) rad/s, accel (3) in g] in the body frame."""
        R, _ = self.pose(t)
        th, w = self.omega * t, self.omega
        a_w = np.array([-np.cos(th), -np.sin(th), 0.0]) * self.radius * w * w
        acc_b = R.T @ (a_w - np.array([0.0, 0.0, -GRAVITY])) / GRAVITY
        return np.array([t, 0.0, 0.0, w, *acc_b])

    def scan(self, t0: float):
        """(points (N, 3) float32 in the lidar frame at each point's capture
        time, stamps (N,) float32 seconds from the sweep's start)."""
        period = 1.0 / self.scan_hz
        _, p0 = self.pose(t0)
        d2 = np.sum((self.world[:, :2] - p0[None, :2]) ** 2, axis=1)
        near = np.flatnonzero(d2 < self.max_range ** 2)
        take = self.rng.choice(near, size=min(self.points_per_scan, near.size), replace=False)
        pw = self.world[take]
        rel = pw - p0[None, :]
        stamps = (np.arctan2(rel[:, 1], rel[:, 0]) + np.pi) / (2 * np.pi) * period
        order = np.argsort(stamps)
        pw, stamps = pw[order], stamps[order]
        pts_l = np.empty_like(pw)
        n_buckets = 64
        bucket = np.minimum((stamps / period * n_buckets).astype(int), n_buckets - 1)
        for b in range(n_buckets):
            sel = bucket == b
            if np.any(sel):
                R, p = self.pose(t0 + (b + 0.5) / n_buckets * period)
                pts_l[sel] = (pw[sel] - p) @ R
        if self.point_noise > 0:
            pts_l = pts_l + self.rng.normal(0, self.point_noise, pts_l.shape)
        return pts_l.astype(np.float32), stamps.astype(np.float32)

    def imu_batch(self, t0: float) -> np.ndarray:
        """The IMU rows of (t0 - dt, t0 + period], stamps relative to t0."""
        dt = 1.0 / self.imu_hz
        ts = np.arange(t0, t0 + 1.0 / self.scan_hz + dt / 2, dt)
        batch = np.stack([self.imu_sample(t) for t in ts])
        batch[:, 0] -= t0
        return batch


def lap(tr: dict, seed: int, points: int, imu_slots: int):
    """One lap of ``tr["scans_per_lap"]`` scans, the angular rate set so that
    the lap closes on a whole scan: the next lap continues without a jump.
    Returns (points (K, N, 3), stamps (K, N), mask (K, N), imu (K, M, 7),
    imu_mask (K, M)) as float32/bool numpy arrays, and the start pose
    (R, p, v)."""
    k = int(tr["scans_per_lap"])
    omega = 2 * np.pi / (k / 10.0)
    sim = Circle(tr["radius_m"], omega, tr["world_seed"], seed, points,
                 point_noise=tr["point_noise_m"])
    P = np.zeros((k, points, 3), np.float32)
    S = np.zeros((k, points), np.float32)
    M = np.zeros((k, points), bool)
    I = np.zeros((k, imu_slots, 7), np.float32)
    IM = np.zeros((k, imu_slots), bool)
    for i in range(k):
        t0 = i * 0.1
        pts, st = sim.scan(t0)
        n = min(len(pts), points)
        P[i, :n], S[i, :n], M[i, :n] = pts[:n], st[:n], True
        imu = sim.imu_batch(t0)
        m = min(len(imu), imu_slots)
        I[i, :m], IM[i, :m] = imu[:m], True
    R, p = sim.pose(0.0)
    return (P, S, M, I, IM), (R, p, sim.velocity(0.0))
