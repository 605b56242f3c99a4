"""Synthetic LiDAR+IMU world simulators (numpy only).

A copy of ``lsd_tpu/sim.py`` (``SimConfig``, ``CircleSim``, ``CorridorSim``,
``FigureEightSim``, ``RouteSim``), kept in the port so that it can make scans
without importing the JAX package.  The simulators synthesize a structured
world, an analytic trajectory, and motion-distorted, per-point-timestamped
scans with exact IMU (and, for the figure-eight and the route, GNSS fixes),
so the SLAM stack can be checked against a known ground truth.  Every random
draw is made in the reference's order: the same config and seed give the
same scans, IMU rows and fixes, byte for byte.
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


class CorridorSim(CircleSim):
    """Straight corridor along +x — the degenerate-geometry robustness
    scenario (long smooth walls constrain y/z/roll/pitch/yaw but leave the
    travel direction weakly observable; ref: FAST-LIO degeneracy gating,
    laserMapping.cpp:934-983).  ``feature_density`` controls how many door
    frames / wall fixtures break the translational symmetry; 0 leaves the
    corridor perfectly smooth."""

    # ---- speed profile (rest -> linear ramp -> cruise) ------------------
    def _sprofile(self, t: float) -> Tuple[float, float, float]:
        """(distance, speed, accel) along +x at time t."""
        cfg = self.cfg
        t0, tr, v = cfg.rest_time, cfg.ramp_time, cfg.speed
        if t <= t0:
            return 0.0, 0.0, 0.0
        if tr > 0.0 and t < t0 + tr:
            dt = t - t0
            a = v / tr
            return 0.5 * a * dt * dt, a * dt, a
        s0 = 0.5 * v * tr if tr > 0.0 else 0.0
        return s0 + v * (t - t0 - tr), v, 0.0

    def pose(self, t: float) -> Tuple[np.ndarray, np.ndarray]:
        s, _, _ = self._sprofile(t)
        return np.eye(3), np.array([s, 0.0, 1.5])

    def velocity(self, t: float) -> np.ndarray:
        _, v, _ = self._sprofile(t)
        return np.array([v, 0.0, 0.0])

    def imu_sample(self, t: float) -> np.ndarray:
        cfg = self.cfg
        _, _, a = self._sprofile(t)
        g_w = np.array([0.0, 0.0, -9.81])
        acc_b = (np.array([a, 0.0, 0.0]) - g_w) / 9.81
        gyr_b = self.rng.normal(0, cfg.gyro_noise, 3) + np.asarray(cfg.gyro_bias)
        acc_b = acc_b + self.rng.normal(0, cfg.acc_noise, 3) + np.asarray(cfg.acc_bias)
        return np.array([t, *gyr_b, *acc_b])

    def _build_world(self) -> np.ndarray:
        cfg = self.cfg
        rng = self.rng
        # corridor long enough for the full run + sensor range
        length = cfg.speed * (cfg.n_scans / cfg.scan_hz) + cfg.max_range + 20.0
        w = cfg.corridor_half_width
        pts = []
        # floor + ceiling
        n_f = 90000
        fx = rng.uniform(-cfg.max_range, length, n_f)
        fy = rng.uniform(-w, w, n_f)
        pts.append(np.stack([fx, fy, np.zeros(n_f)], axis=1))
        n_c = 30000
        cx = rng.uniform(-cfg.max_range, length, n_c)
        cy = rng.uniform(-w, w, n_c)
        pts.append(np.stack([cx, cy, np.full(n_c, 3.0)], axis=1))
        # two smooth walls
        for side in (-w, w):
            n_w = 60000
            wx = rng.uniform(-cfg.max_range, length, n_w)
            wz = rng.uniform(0.0, 3.0, n_w)
            pts.append(np.stack([wx, np.full(n_w, side), wz], axis=1))
        # door frames / fixtures every ~7 m (break the x-degeneracy)
        if cfg.feature_density > 0:
            n_doors = int((length + cfg.max_range) / 7.0 * cfg.feature_density)
            for i in range(n_doors):
                dx = -cfg.max_range + 7.0 * i / max(cfg.feature_density, 1e-6)
                side = w if i % 2 == 0 else -w
                # jamb: a 0.2 m-deep vertical post pair + lintel
                for off in (-0.5, 0.5):
                    u = rng.uniform(-0.1, 0.1, 400)
                    v = rng.uniform(0.0, 2.2, 400)
                    d = rng.uniform(0.0, 0.25, 400)
                    pts.append(np.stack([
                        np.full(400, dx + off) + u,
                        np.full(400, side) - np.sign(side) * d,
                        v], axis=1))
        return np.concatenate(pts, axis=0).astype(np.float64)


class FigureEightSim(CircleSim):
    """Two tangent circles traversed repeatedly (an ∞ track) through a
    town-like world — the multi-loop campaign trajectory for BASELINE
    configs 2/4/5 scale runs (VERDICT r3 #1).  Every lap revisits the
    crossing region and both lobes, so ScanContext loop closures fire on
    each revisit; `laps` controls total path length (lap length = 4πR).

    Also emits simulated GNSS fixes (`ins_sample_dict`) with configurable
    noise and outlier rate for exercising GPS priors + robust gating
    (ref: hdl_graph_slam_nodelet.cpp:349-460 gps edges,
    backend robust_graph_optimize)."""

    LAT0, LON0 = 42.2936, -83.7093          # arbitrary UTM anchor

    def __init__(self, cfg: SimConfig, laps: float = 5.0,
                 gps_noise: float = 0.05, gps_outlier_rate: float = 0.0,
                 gps_hz: float = 1.0):
        self.laps = laps
        self.gps_noise = gps_noise
        self.gps_outlier_rate = gps_outlier_rate
        self.gps_hz = gps_hz
        super().__init__(cfg)
        self._gps_rng = np.random.default_rng(cfg.seed + 101)

    # ---- speed profile (rest -> ramp -> cruise), same as CorridorSim ----
    def _sprofile(self, t: float) -> Tuple[float, float, float]:
        cfg = self.cfg
        t0, tr, v = cfg.rest_time, cfg.ramp_time, cfg.speed
        if t <= t0:
            return 0.0, 0.0, 0.0
        if tr > 0.0 and t < t0 + tr:
            dt = t - t0
            a = v / tr
            return 0.5 * a * dt * dt, a * dt, a
        s0 = 0.5 * v * tr if tr > 0.0 else 0.0
        return s0 + v * (t - t0 - tr), v, 0.0

    def _track_state(self, s: float):
        """Position/heading/curvature at arc length s.  Returns
        (pos(2,), heading(2,), signed_curvature)."""
        R = self.cfg.radius
        L = 4.0 * np.pi * R
        u = s % L
        if u < 2.0 * np.pi * R:          # circle A, center (R, 0), CW
            th = np.pi - u / R
            c = np.array([R, 0.0])
            pos = c + R * np.array([np.cos(th), np.sin(th)])
            head = np.array([np.sin(th), -np.cos(th)])
            kappa = -1.0 / R
        else:                             # circle B, center (-R, 0), CCW
            th = (u - 2.0 * np.pi * R) / R
            c = np.array([-R, 0.0])
            pos = c + R * np.array([np.cos(th), np.sin(th)])
            head = np.array([-np.sin(th), np.cos(th)])
            kappa = 1.0 / R
        return pos, head, kappa

    def pose(self, t: float) -> Tuple[np.ndarray, np.ndarray]:
        s, _, _ = self._sprofile(t)
        pos, head, _ = self._track_state(s)
        yaw = np.arctan2(head[1], head[0])
        return _rz(yaw), np.array([pos[0], pos[1], 1.8])

    def velocity(self, t: float) -> np.ndarray:
        s, v, _ = self._sprofile(t)
        _, head, _ = self._track_state(s)
        return np.array([v * head[0], v * head[1], 0.0])

    def imu_sample(self, t: float) -> np.ndarray:
        cfg = self.cfg
        s, v, a_t = self._sprofile(t)
        pos, head, kappa = self._track_state(s)
        R_wb, _ = self.pose(t)
        # a_w = tangential + centripetal (normal = rot90(head) * sign)
        normal = np.array([-head[1], head[0]])
        a_w3 = np.array([a_t * head[0] + v * v * kappa * normal[0],
                         a_t * head[1] + v * v * kappa * normal[1], 0.0])
        g_w = np.array([0.0, 0.0, -9.81])
        acc_b = R_wb.T @ (a_w3 - g_w) / 9.81
        gyr_b = np.array([0.0, 0.0, v * kappa])
        gyr_b = gyr_b + self.rng.normal(0, cfg.gyro_noise, 3) + np.asarray(cfg.gyro_bias)
        acc_b = acc_b + self.rng.normal(0, cfg.acc_noise, 3) + np.asarray(cfg.acc_bias)
        return np.array([t, *gyr_b, *acc_b])

    def ins_sample_dict(self, t: float, timestamp_us: int) -> dict:
        """Simulated GNSS/INS fix (reference ins_data schema) with noise
        and occasional gross outliers; Status 42 = RTK fixed."""
        from .geometry.utm import UTMProjector
        if not hasattr(self, "_proj"):
            self._proj = UTMProjector()
            self._x0, self._y0 = self._proj.project(
                self.LAT0, self.LON0, relative=False)
        _, p = self.pose(t)
        vel = self.velocity(t)
        err = self._gps_rng.normal(0, self.gps_noise, 2)
        if self.gps_outlier_rate > 0 and \
                self._gps_rng.uniform() < self.gps_outlier_rate:
            err = err + self._gps_rng.uniform(5.0, 15.0) * \
                self._gps_rng.choice([-1.0, 1.0], 2)
        lat, lon = self._proj.unproject(self._x0 + p[0] + err[0],
                                        self._y0 + p[1] + err[1])
        R_wb, _ = self.pose(t)
        yaw = np.degrees(np.arctan2(R_wb[1, 0], R_wb[0, 0]))
        return dict(timestamp=timestamp_us, latitude=float(lat),
                    longitude=float(lon), altitude=float(p[2]),
                    heading=float((90.0 - yaw) % 360.0), pitch=0.0, roll=0.0,
                    Ve=float(vel[0]), Vn=float(vel[1]), Vu=0.0,
                    Status=42, Sensor="SimGNSS")

    def _lap_length(self) -> float:
        return 4.0 * np.pi * self.cfg.radius

    def duration(self) -> float:
        cfg = self.cfg
        L = self._lap_length() * self.laps
        return cfg.rest_time + cfg.ramp_time + L / cfg.speed

    def _build_world(self) -> np.ndarray:
        cfg = self.cfg
        rng = self.rng
        # world bounds follow the track (generic over _track_state so
        # subclasses with other routes reuse the same town generator;
        # for the figure-eight these evaluate to the original
        # +-(2R+30) x +-(R+30) box bit-for-bit)
        L = self._lap_length()
        svals = np.linspace(0.0, L, 400)
        path = np.stack([self._track_state(s)[0] for s in svals])
        x_lo, x_hi = path[:, 0].min() - 30.0, path[:, 0].max() + 30.0
        y_lo, y_hi = path[:, 1].min() - 30.0, path[:, 1].max() + 30.0
        pts = []
        # ground
        n_g = 700000
        gx = rng.uniform(x_lo, x_hi, n_g)
        gy = rng.uniform(y_lo, y_hi, n_g)
        pts.append(np.stack([gx, gy, np.zeros(n_g)], axis=1))
        # building wall patches on a jittered grid, off the track
        step = 16.0
        for cx in np.arange(x_lo + 8, x_hi - 8, step):
            for cy in np.arange(y_lo + 8, y_hi - 8, step):
                c = np.array([cx, cy]) + rng.uniform(-4, 4, 2)
                if np.min(np.linalg.norm(path - c[None, :], axis=1)) < 5.0:
                    continue
                yaw = rng.uniform(0, np.pi)
                t_dir = np.array([np.cos(yaw), np.sin(yaw), 0.0])
                n_w = 2500
                u = rng.uniform(-4.0, 4.0, n_w)
                z = rng.uniform(0.0, 5.0, n_w)
                base = np.array([c[0], c[1], 0.0])
                pts.append(base + u[:, None] * t_dir
                           + z[:, None] * np.array([0.0, 0.0, 1.0]))
        # pillars near the track for close-range constraint
        for _ in range(120):
            s = rng.uniform(0, L)
            p2, head, _ = self._track_state(s)
            normal = np.array([-head[1], head[0]])
            side = rng.choice([-1.0, 1.0]) * rng.uniform(5.0, 12.0)
            c = np.array([p2[0], p2[1], 1.5]) + np.array(
                [normal[0], normal[1], 0.0]) * side
            yaw = rng.uniform(0, np.pi)
            t_dir = np.array([np.cos(yaw), np.sin(yaw), 0.0])
            u = rng.uniform(-1.0, 1.0, 600)
            z = rng.uniform(-1.5, 1.5, 600)
            pts.append(c + u[:, None] * t_dir
                       + z[:, None] * np.array([0.0, 0.0, 1.0]))
        return np.concatenate(pts, axis=0).astype(np.float64)


class RouteSim(FigureEightSim):
    """Rounded-rectangle route (asymmetric W x H, corner radius rc)
    through the same jittered-grid town — the DISTINCTIVE-WORLD
    localization eval (VERDICT r4 #2).

    The figure-eight is deliberately adversarial: its crossing admits
    near-symmetric aliased map-match hypotheses, so localization errors
    there cannot be attributed between world pathology and filter
    quality.  This route has no self-similar twin branch (W != H, four
    distinct corner neighborhoods in an irregular building grid), which
    matches the regime of the reference's published localization table
    (docs/slam.md:217-233: a distinctive outdoor map, RTK ground
    truth).  GNSS defaults stay at the constructor's (callers pass
    clean continuous RTK for the reference-comparable row).
    """

    def __init__(self, cfg: SimConfig, width: float = 120.0,
                 height: float = 60.0, corner: float = 15.0, **kw):
        self.W, self.H, self.rc = float(width), float(height), float(corner)
        super().__init__(cfg, **kw)

    def _lap_length(self) -> float:
        W, H, rc = self.W, self.H, self.rc
        return 2.0 * (W - 2 * rc) + 2.0 * (H - 2 * rc) + 2.0 * np.pi * rc

    def _track_state(self, s: float):
        W, H, rc = self.W, self.H, self.rc
        hw, hh = W / 2.0, H / 2.0
        arc = np.pi * rc / 2.0
        segs = [W - 2 * rc, arc, H - 2 * rc, arc,
                W - 2 * rc, arc, H - 2 * rc, arc]
        u = s % self._lap_length()
        i = 0
        while i < 7 and u > segs[i]:
            u -= segs[i]
            i += 1

        def corner_state(a, cx, cy):
            pos = np.array([cx + rc * np.cos(a), cy + rc * np.sin(a)])
            head = np.array([-np.sin(a), np.cos(a)])
            return pos, head, 1.0 / rc

        if i == 0:      # bottom edge, heading +x
            return (np.array([-hw + rc + u, -hh]),
                    np.array([1.0, 0.0]), 0.0)
        if i == 1:      # bottom-right corner (CCW quarter arc)
            return corner_state(-np.pi / 2 + u / rc, hw - rc, -hh + rc)
        if i == 2:      # right edge, +y
            return (np.array([hw, -hh + rc + u]),
                    np.array([0.0, 1.0]), 0.0)
        if i == 3:      # top-right corner
            return corner_state(u / rc, hw - rc, hh - rc)
        if i == 4:      # top edge, -x
            return (np.array([hw - rc - u, hh]),
                    np.array([-1.0, 0.0]), 0.0)
        if i == 5:      # top-left corner
            return corner_state(np.pi / 2 + u / rc, -hw + rc, hh - rc)
        if i == 6:      # left edge, -y
            return (np.array([-hw, hh - rc - u]),
                    np.array([0.0, -1.0]), 0.0)
        return corner_state(np.pi + u / rc, -hw + rc, -hh + rc)
