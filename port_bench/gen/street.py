"""A vehicle driving straight along a street of parked objects, seen by a
spinning LiDAR, frame by frame.

The street is the realistic scene sampler of the port's
``training/data.py:SyntheticDetectionDataset`` (``realistic=True``, as the
detection evaluation and ``tools/profile_detector.py`` use it) laid out
along the drive instead of around one point: vehicles, pedestrians and
cyclists at their class sizes, walls and poles, and azimuth shadows behind
every object.  An object returns as many points as a sensor of
``beams`` x ``columns`` gets from the faces that look at it (the solid
angle of each face over that of one return), spread uniformly over those
faces.  Every frame samples afresh around the vehicle's current position,
and ground returns fill the frame to exactly ``points_per_frame`` points,
so every frame carries the same number.
"""
from __future__ import annotations

import numpy as np

CLASS_SIZES = ((4.5, 1.9, 1.6), (0.8, 0.8, 1.7), (1.8, 0.6, 1.6))   # vehicle, ped, cyclist
SENSOR_Z = 1.8


def _beam_returns(rng, dims, rot, centre, sensor, tr) -> np.ndarray:
    """The returns a spinning LiDAR of ``tr["beams"]`` beams over
    ``tr["elevation_deg"]`` and ``tr["columns"]`` columns a turn gets from
    the faces of a box that look at it: per face, its area times the cosine
    to the line of sight over the solid angle of one return, spread
    uniformly over the face."""
    el_lo, el_hi = np.radians(tr["elevation_deg"])
    cell = (2 * np.pi / tr["columns"]) * ((el_hi - el_lo) / (tr["beams"] - 1))
    out = []
    for ax in range(3):
        other = [a for a in range(3) if a != ax]
        for sign in (-1.0, 1.0):
            normal = sign * rot[:, ax]
            face_c = centre + 0.5 * dims[ax] * normal
            to_sensor = sensor - face_c
            dist = float(np.linalg.norm(to_sensor))
            cos = float(normal @ to_sensor) / dist
            if cos <= 0:
                continue
            expect = dims[other[0]] * dims[other[1]] * cos / (dist * dist * cell)
            n = int(expect) + int(rng.uniform() < expect - int(expect))
            if not n:
                continue
            uv = rng.uniform(-0.5, 0.5, (n, 2)) * [dims[other[0]], dims[other[1]]]
            out.append(face_c + uv[:, :1] * rot[:, other[0]] + uv[:, 1:] * rot[:, other[1]])
    return np.concatenate(out, 0) if out else np.zeros((0, 3))


def _shadowed(bg: np.ndarray, shadows) -> np.ndarray:
    """Which of the points ``bg`` lie more than 1 m behind an object, within
    its azimuth half-width: (azimuth, half-width, range) per object."""
    az = np.arctan2(bg[:, 1], bg[:, 0])
    rr = np.hypot(bg[:, 0], bg[:, 1])
    order = np.argsort(az)
    az_s = az[order]
    occ = np.zeros(len(bg), bool)
    for a0, hw, r0 in shadows:
        for lo, hi in ((a0 - hw, a0 + hw), (a0 - hw + 2 * np.pi, a0 + hw + 2 * np.pi),
                       (a0 - hw - 2 * np.pi, a0 + hw - 2 * np.pi)):
            i, j = np.searchsorted(az_s, (lo, hi))
            sel = order[i:j]
            occ[sel] |= rr[sel] > r0 + 1.0
    return occ


class Street:
    def __init__(self, tr: dict, seed: int):
        self.tr = tr
        self.rng = np.random.default_rng(seed)
        rng, R = self.rng, tr["range_m"]
        step = tr["speed_mps"] * tr["dt_s"]
        self.length = step * tr["frames"]
        x0, x1 = -R, self.length + R
        area = (x1 - x0) * 2 * R
        n_obj = int(round(tr["objects_in_range"] * area / (np.pi * R * R)))
        self.cls = rng.integers(0, len(CLASS_SIZES), n_obj)
        xy = np.stack([rng.uniform(x0, x1, n_obj),
                       rng.choice([-1.0, 1.0], n_obj) * rng.uniform(2.5, R, n_obj)], 1)
        self.xy, self.yaw = xy, rng.uniform(-np.pi, np.pi, n_obj)
        n_walls = int(round(tr["walls_per_100m"] * (x1 - x0) / 100.0))
        self.walls = np.stack([rng.uniform(x0, x1, n_walls),
                               rng.choice([-1.0, 1.0], n_walls) * rng.uniform(0.6, 1.0, n_walls) * R,
                               rng.uniform(-0.3, 0.3, n_walls)], 1)
        n_poles = int(round(tr["poles_per_100m"] * (x1 - x0) / 100.0))
        self.poles = np.stack([rng.uniform(x0, x1, n_poles),
                               rng.choice([-1.0, 1.0], n_poles) * rng.uniform(2.0, R, n_poles)], 1)

    def ego(self, k: int) -> np.ndarray:
        return np.asarray([k * self.tr["speed_mps"] * self.tr["dt_s"], 0.0])

    def in_range(self, k: int) -> int:
        rel = self.xy - self.ego(k)
        return int(np.sum(np.hypot(rel[:, 0], rel[:, 1]) < self.tr["range_m"]))

    def frame(self, k: int) -> np.ndarray:
        """The k-th frame: (points_per_frame, 4) float32 [x y z intensity] in
        the vehicle's frame (x forward, z up from the ground)."""
        tr, rng, R = self.tr, self.rng, self.tr["range_m"]
        ego = self.ego(k)
        sensor = np.asarray([0.0, 0.0, SENSOR_Z])
        fg, shadows = [], []
        rel = self.xy - ego
        for i in np.flatnonzero(np.hypot(rel[:, 0], rel[:, 1]) < R):
            dx, dy, dz = CLASS_SIZES[self.cls[i]]
            cx, cy = rel[i]
            r = float(np.hypot(cx, cy))
            c, s = np.cos(self.yaw[i]), np.sin(self.yaw[i])
            rot = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
            centre = np.asarray([cx, cy, dz / 2.0])
            world = _beam_returns(rng, (dx, dy, dz), rot, centre, sensor, tr)
            if len(world):
                fg.append(world)
                shadows.append((np.arctan2(cy, cx), np.arctan2(max(dx, dy) / 2, max(r, 1.0)), r))
        bg = []
        for wx, wy, wyaw in self.walls:
            cw = np.asarray([wx - ego[0], wy, 1.5])
            if np.hypot(cw[0], cw[1]) < R:
                tdir = np.asarray([np.cos(wyaw), np.sin(wyaw), 0.0])
                u, v = rng.uniform(-6, 6, 1200), rng.uniform(-1.5, 1.5, 1200)
                bg.append(cw + u[:, None] * tdir + v[:, None] * np.asarray([0, 0, 1.0]))
        for px, py in self.poles:
            if np.hypot(px - ego[0], py) < R:
                h = rng.uniform(0, 4.0, 120)
                bg.append(np.stack([px - ego[0] + rng.normal(0, 0.03, 120),
                                    py + rng.normal(0, 0.03, 120), h], 1))
        n_fg = sum(len(a) for a in fg)

        def ground(n):
            r_g = 2.0 * (R / 2.0) ** rng.uniform(0, 1, n)
            th_g = rng.uniform(-np.pi, np.pi, n)
            return np.stack([r_g * np.cos(th_g), r_g * np.sin(th_g), rng.normal(0, 0.02, n)], 1)

        def unshadowed(pts):
            if not shadows:
                return pts
            return pts[~_shadowed(pts, shadows) | (rng.uniform(0, 1, len(pts)) > 0.85)]

        # ground with 1/r density, a quarter more than is needed, drawn
        # again while the shadows leave the frame short
        bg = np.concatenate(bg, 0) if bg else np.zeros((0, 3))
        short = tr["points_per_frame"] - n_fg - len(bg)
        bg = unshadowed(np.concatenate([bg, ground(max(int(1.25 * short), 0) + 1024)], 0))
        while (short := tr["points_per_frame"] - n_fg - len(bg)) > 0:
            bg = np.concatenate([bg, unshadowed(ground(int(1.25 * short) + 1024))], 0)
        pts = np.concatenate(fg + [bg], 0)[:tr["points_per_frame"]]
        inten = rng.uniform(0, 1, (len(pts), 1))
        return np.concatenate([pts, inten], 1).astype(np.float32)


def drive(tr: dict, seed: int):
    """``tr["frames"]`` frames of one drive as host arrays; the ego motion
    between frames as the program's INS source gives it
    (``sensors/ins.py``): the 4x4 pose of a frame in the previous frame's
    coordinates; and the number of objects within range of each frame."""
    street = Street(tr, seed)
    frames = [street.frame(k) for k in range(tr["frames"])]
    motion = np.eye(4)
    motion[0, 3] = tr["speed_mps"] * tr["dt_s"]
    return frames, motion, [street.in_range(k) for k in range(tr["frames"])]
