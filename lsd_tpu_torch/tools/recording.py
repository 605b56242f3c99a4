"""Recordings of simulated drives in the reference's on-disk format.

``chip_smoke.py`` (phase 10) and the pipeline's tests replay ``CircleSim``
scans through ``Perception``; this writes them as the sensors' frame dicts
(``%06d.pkl`` through ``io/recorder.py``): one LiDAR ``0-Custom`` with its
per-point stamps in ``points_attr``, the IMU rows with absolute microsecond
stamps, and optionally an INS fix made from the simulator's truth; or a
detection drive's frames (points and the vehicle's motion, no IMU).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..geometry.utm import UTMProjector, grid_convergence
from ..io.recorder import FrameRecorder

# the fixes' datum: the simulator's start projected here (42 N, 83 W, as
# chip_smoke.py's RTK mapping phase has it)
ORIGIN_LAT, ORIGIN_LON, ORIGIN_ALT = 42.0, -83.0, 100.0
PERIOD_US = 100_000


def fix_projector() -> UTMProjector:
    """The projector that ``truth_fix`` unprojects with: anchored at the datum."""
    proj = UTMProjector()
    proj.project(ORIGIN_LAT, ORIGIN_LON)
    return proj


def truth_fix(sim, t: float, stamp_us: int, proj: UTMProjector, p0: np.ndarray,
              status: int = 42) -> Dict:
    """An INS fix of ``sim`` at time ``t`` s, stamped ``stamp_us``: position
    (lat/lon of the offset from ``p0`` through ``proj``), ENU velocity and
    heading (NED degrees against true north, so the grid convergence is in
    it, as an INS reports it), with solution status ``status`` (42: RTK
    fixed)."""
    R, p = sim.pose(t)
    v = sim.velocity(t)
    lat, lon = proj.unproject(p[0] - p0[0], p[1] - p0[1])
    lat, lon = float(np.ravel(lat)[0]), float(np.ravel(lon)[0])
    yaw = np.degrees(np.arctan2(R[1, 0], R[0, 0]))
    return dict(timestamp=int(stamp_us), latitude=lat, longitude=lon,
                altitude=ORIGIN_ALT + float(p[2] - p0[2]),
                heading=float(90.0 - yaw + grid_convergence(proj.lon0, lat, lon)),
                pitch=0.0, roll=0.0, Ve=float(v[0]), Vn=float(v[1]), Vu=float(v[2]),
                Status=int(status))


def frame_dict(scan: Sequence[np.ndarray], stamp_us: int, fix: Optional[Dict] = None) -> Dict:
    """One generated scan (points, stamps, mask, imu, imu_mask, ...) as the
    frame dict the sources emit, starting at ``stamp_us``."""
    P, S, M, I, IM = scan[:5]
    n = int(np.sum(M))
    imu = np.asarray(I[: int(np.sum(IM))], np.float64).copy()
    imu[:, 0] = stamp_us + imu[:, 0] * 1e6
    return dict(
        frame_start_timestamp=int(stamp_us), frame_timestamp_monotonic=int(stamp_us),
        points={"0-Custom": np.concatenate([P[:n], np.zeros((n, 1), np.float32)], axis=1)},
        points_attr={"0-Custom": dict(timestamp=int(stamp_us), points_attr=np.stack(
            [S[:n], np.zeros(n, np.float32)], axis=1))},
        image={}, image_param={}, lidar_valid=True, image_valid=False, radar_valid=False,
        ins_valid=fix is not None, ins_data=dict(fix) if fix is not None else {},
        imu_data=imu, motion_valid=False, timestep=PERIOD_US)


def write_recording(root: str, sim, scans, t_start: float = 0.0, first_us: int = 1_000_000,
                    with_fixes: bool = False, p0: Optional[np.ndarray] = None) -> str:
    """Write ``scans`` (``sim.generate(..., t_start)``'s output) under
    ``root`` as one recording; frame k starts at ``first_us + k * 0.1 s``.
    With ``with_fixes`` each frame carries an RTK-fixed ``truth_fix`` at its
    scan's end, relative to ``p0`` (default: ``sim``'s start).  Returns the
    recording's directory."""
    rec = FrameRecorder(root)
    proj = fix_projector()
    p0 = sim.pose(0.0)[1] if p0 is None else p0
    for k, scan in enumerate(scans):
        ts = first_us + k * PERIOD_US
        fix = (truth_fix(sim, t_start + (k + 1) * PERIOD_US / 1e6, ts + PERIOD_US, proj, p0)
               if with_fixes else None)
        rec.write(frame_dict(scan, ts, fix))
    return rec.log_dir


def points_frame_dict(points: np.ndarray, mask: np.ndarray, stamp_us: int,
                      motion: Optional[np.ndarray] = None) -> Dict:
    """A LiDAR-only frame dict (the valid rows of ``points`` (N, 4)) with the
    4x4 ``motion`` from the previous frame, where there is one."""
    pts = np.asarray(points, np.float32)[np.asarray(mask, bool)]
    return dict(
        frame_start_timestamp=int(stamp_us), frame_timestamp_monotonic=int(stamp_us),
        points={"0-Custom": pts},
        points_attr={"0-Custom": dict(timestamp=int(stamp_us),
                                      points_attr=np.zeros((len(pts), 2), np.float32))},
        image={}, image_param={}, lidar_valid=True, image_valid=False, radar_valid=False,
        ins_valid=False, ins_data={},
        motion_t=None if motion is None else np.asarray(motion, np.float32),
        motion_valid=motion is not None, timestep=PERIOD_US)
