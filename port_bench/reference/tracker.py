"""3D multi-object tracker: GIoU + two-stage association + KF bank.

Counterpart of ``lsd_tpu/detection/tracker.py``: the same numpy float64
filter bank and scipy assignment; the GIoU cost matrix comes from the
port's ``ops/iou3d.py`` on the tracker's device (uploaded pinned, fetched
once per association).

Re-derivation of the reference's improved AB3DMOT
(sensor_fusion/tracker.py:50-84 + MOT3D/model.py:22-99 update loop,
MOT3D/tracklet.py BoxTracker/StaticBoxTracker/IDTable, with the Kalman
filters of sensor_driver/common_lib/cpp_utils/src/KalmanFilter.cpp):

- constant-velocity Kalman filter per track over [x y z yaw l w h vx vy vz]
- ego-motion compensation of track states between frames
- two-stage association (high-score dets first, then low-score for the
  leftovers — the "two-stage" in README.md:37-40) on a GIoU3D cost matrix
  (device, ops.iou3d) solved by Hungarian assignment (host scipy, like the
  reference's linear_sum_assignment)
- recycled ID table, hit/miss lifecycle, constant-velocity trajectory
  prediction (20 x 7) matching the proto Trajectory output
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .iou3d import boxes_giou3d
from .device import DeviceLike, resolve_device, to_device

try:
    from scipy.optimize import linear_sum_assignment
except Exception:  # pragma: no cover
    linear_sum_assignment = None


@dataclasses.dataclass
class TrackerConfig:
    max_tracks: int = 128
    giou_thresh_high: float = -0.5    # stage-1 gate (GIoU in [-1, 1])
    giou_thresh_low: float = -0.7     # stage-2 gate
    score_high: float = 0.4
    max_misses: int = 3
    min_hits: int = 2
    traj_len: int = 20
    traj_dt: float = 0.5
    q_pos: float = 0.1
    q_vel: float = 1.0
    r_meas: float = 0.1


class _IDTable:
    """Recycling id allocator (ref tracklet.py IDTable)."""

    def __init__(self, capacity: int = 1 << 16):
        self.free: List[int] = list(range(capacity - 1, -1, -1))

    def acquire(self) -> int:
        return self.free.pop()

    def release(self, i: int) -> None:
        self.free.append(i)


class _Track:
    __slots__ = ("id", "x", "P", "label", "score", "hits", "misses", "static")

    def __init__(self, tid, box, label, score, cfg: TrackerConfig):
        # state: [x y z yaw l w h vx vy vz]
        self.id = tid
        self.x = np.zeros(10)
        self.x[0:3] = box[0:3]
        self.x[3] = box[6]               # yaw
        self.x[4:7] = box[3:6]           # l w h
        self.P = np.eye(10) * 1.0
        self.P[7:, 7:] *= 10.0
        self.label = int(label)
        self.score = float(score)
        self.hits = 1
        self.misses = 0
        self.static = False

    def box(self) -> np.ndarray:
        return np.asarray([self.x[0], self.x[1], self.x[2],
                           self.x[4], self.x[5], self.x[6], self.x[3]])


class Tracker3D:
    def __init__(self, cfg: TrackerConfig = TrackerConfig(), device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tracks: List[_Track] = []
        self.ids = _IDTable()

    # ------------------------------------------------------------------
    def _predict(self, dt: float, motion: Optional[np.ndarray]) -> None:
        cfg = self.cfg
        F = np.eye(10)
        F[0, 7] = F[1, 8] = F[2, 9] = dt
        Q = np.diag([cfg.q_pos] * 3 + [cfg.q_pos] + [1e-3] * 3 + [cfg.q_vel] * 3) * dt
        for t in self.tracks:
            t.x = F @ t.x
            t.P = F @ t.P @ F.T + Q
            if motion is not None:
                # ego-motion compensation: new_ego_from_old applied to pose
                p = motion[:3, :3] @ t.x[:3] + motion[:3, 3]
                v = motion[:3, :3] @ t.x[7:10]
                yaw_rot = np.arctan2(motion[1, 0], motion[0, 0])
                t.x[:3] = p
                t.x[7:10] = v
                t.x[3] += yaw_rot

    # ------------------------------------------------------------------
    def _associate(self, det_boxes: np.ndarray, trk_idx: List[int],
                   det_idx: List[int], gate: float) -> Tuple[list, list, list]:
        if not trk_idx or not det_idx or linear_sum_assignment is None:
            return [], trk_idx, det_idx
        tb = np.stack([self.tracks[i].box() for i in trk_idx]).astype(np.float32)
        db = det_boxes[det_idx].astype(np.float32)
        giou = boxes_giou3d(to_device(tb, self.device), to_device(db, self.device)).cpu().numpy()
        rows, cols = linear_sum_assignment(-giou)
        matches, um_t, um_d = [], set(range(len(trk_idx))), set(range(len(det_idx)))
        for r, c in zip(rows, cols):
            if giou[r, c] >= gate:
                matches.append((trk_idx[r], det_idx[c]))
                um_t.discard(r)
                um_d.discard(c)
        return (matches, [trk_idx[r] for r in sorted(um_t)],
                [det_idx[c] for c in sorted(um_d)])

    # ------------------------------------------------------------------
    def update(self, boxes: np.ndarray, scores: np.ndarray, labels: np.ndarray,
               dt: float = 0.1, motion: Optional[np.ndarray] = None) -> Dict:
        """Feed one frame of detections; returns tracked objects dict."""
        cfg = self.cfg
        boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
        scores = np.asarray(scores, np.float64).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        self._predict(dt, motion)

        high = [i for i in range(len(boxes)) if scores[i] >= cfg.score_high]
        low = [i for i in range(len(boxes)) if scores[i] < cfg.score_high]
        alive = list(range(len(self.tracks)))

        m1, um_t, um_d_high = self._associate(boxes, alive, high, cfg.giou_thresh_high)
        m2, um_t2, _ = self._associate(boxes, um_t, low, cfg.giou_thresh_low)

        for ti, di in m1 + m2:
            self._correct(self.tracks[ti], boxes[di], scores[di])
        for ti in um_t2:
            self.tracks[ti].misses += 1
        for di in um_d_high:
            if len(self.tracks) < cfg.max_tracks:
                self.tracks.append(_Track(self.ids.acquire(), boxes[di],
                                          labels[di], scores[di], cfg))

        # lifecycle
        dead = [t for t in self.tracks if t.misses > cfg.max_misses]
        for t in dead:
            self.ids.release(t.id)
        self.tracks = [t for t in self.tracks if t.misses <= cfg.max_misses]
        return self.output()

    def _correct(self, t: _Track, box, score) -> None:
        cfg = self.cfg
        z = np.asarray([box[0], box[1], box[2], box[6], box[3], box[4], box[5]])
        H = np.zeros((7, 10))
        H[:7, :7] = np.eye(7)
        # wrap yaw innovation
        pred = H @ t.x
        innov = z - pred
        innov[3] = (innov[3] + np.pi) % (2 * np.pi) - np.pi
        R = np.eye(7) * cfg.r_meas
        S = H @ t.P @ H.T + R
        K = t.P @ H.T @ np.linalg.inv(S)
        t.x = t.x + K @ innov
        t.P = (np.eye(10) - K @ H) @ t.P
        t.hits += 1
        t.misses = 0
        t.score = 0.7 * t.score + 0.3 * float(score)

    # ------------------------------------------------------------------
    def output(self) -> Dict:
        cfg = self.cfg
        objs = []
        for t in self.tracks:
            if t.hits < cfg.min_hits and t.misses > 0:
                continue
            traj = self.predict_trajectory(t)
            objs.append(dict(id=t.id, box=t.box(), label=t.label, score=t.score,
                             velocity=t.x[7:10].copy(), age=t.hits,
                             valid=t.misses == 0, trajectory=traj))
        return dict(objects=objs, num_tracks=len(self.tracks))

    def predict_trajectory(self, t: _Track) -> np.ndarray:
        """Constant-velocity rollout (ref: motion_prediction -> 20x7)."""
        cfg = self.cfg
        steps = np.arange(1, cfg.traj_len + 1) * cfg.traj_dt
        out = np.zeros((cfg.traj_len, 7))
        out[:, 0] = t.x[0] + t.x[7] * steps
        out[:, 1] = t.x[1] + t.x[8] * steps
        out[:, 2] = t.x[2] + t.x[9] * steps
        out[:, 3:6] = t.x[4:7]
        out[:, 6] = t.x[3]
        return out


class PassThroughTracker:
    """No-op tracker (ref: MOT3D/model.py:85-99 PassThrough)."""

    def update(self, boxes, scores, labels, dt=0.1, motion=None):
        objs = [dict(id=i, box=np.asarray(b), label=int(l), score=float(s),
                     velocity=np.zeros(3), age=1, valid=True,
                     trajectory=np.zeros((20, 7)))
                for i, (b, s, l) in enumerate(zip(boxes, scores, labels))]
        return dict(objects=objs, num_tracks=len(objs))
