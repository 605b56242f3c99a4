"""Port parity: the 3D multi-object tracker (``lsd_tpu_torch.detection.tracker``)
against ``lsd_tpu`` on the CPU.

A 30-frame sequence with births, misses, deaths, a low-score second
stage, false positives and ego motion goes to both trackers.  Both keep
their filter bank in float64 numpy and differ only in where the GIoU cost
matrix comes from (float32 on either side), so the association must be the
same: the same objects and IDs on every frame, and states within 1e-9
(measured: equal).
"""
import numpy as np
import pytest

from lsd_tpu.detection import tracker as J
from lsd_tpu_torch.detection import tracker as T


def _sequence(seed, n_frames=30):
    """Frames of (boxes, scores, labels, motion) seen from a vehicle moving
    1 m per frame and turning slowly.  Objects move at constant velocity in
    the world; some appear late, vanish for a while or for good."""
    rng = np.random.default_rng(seed)
    n_obj = 8
    start = np.c_[rng.uniform(-30, 30, (n_obj, 2)), np.full(n_obj, 0.8)]
    vel = np.c_[rng.uniform(-1.5, 1.5, (n_obj, 2)), np.zeros(n_obj)]
    dims = rng.uniform([3.5, 1.6, 1.4], [5.0, 2.1, 1.8], (n_obj, 3))
    yaw = rng.uniform(-np.pi, np.pi, n_obj)
    born = rng.integers(0, 8, n_obj)
    gone = np.where(rng.uniform(size=n_obj) < 0.3, rng.integers(12, 25, n_obj), n_frames)
    ego = np.eye(4)
    frames = []
    for k in range(n_frames):
        step = np.eye(4)                                   # prev ego -> current ego
        a = 0.02
        step[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        step[:3, 3] = [1.0, 0.0, 0.0]
        ego = ego @ step
        inv = np.linalg.inv(ego)
        boxes, scores, labels = [], [], []
        for i in range(n_obj):
            if not born[i] <= k < gone[i] or (k % 7 == 3 and i % 3 == 0):   # misses
                continue
            p = start[i] + vel[i] * 0.1 * k
            q = inv[:3, :3] @ p + inv[:3, 3] + rng.normal(0, 0.05, 3)
            boxes.append([*q, *dims[i], yaw[i] - np.arctan2(ego[1, 0], ego[0, 0])])
            scores.append(rng.uniform(0.2, 0.95))
            labels.append(i % 3)
        if k % 5 == 0:                                     # a false positive
            boxes.append([*rng.uniform(-40, 40, 2), 0.8, 1.0, 1.0, 1.7, 0.0])
            scores.append(0.45)
            labels.append(1)
        frames.append((np.asarray(boxes, np.float32).reshape(-1, 7), np.asarray(scores),
                       np.asarray(labels), np.linalg.inv(step)))
    return frames


def _strip(out):
    return [(o["id"], o["label"], o["age"], o["valid"]) for o in out["objects"]], out["num_tracks"]


@pytest.mark.parametrize("seed", [0, 1])
def test_tracker_sequence_matches(seed):
    jt, tt = J.Tracker3D(J.TrackerConfig()), T.Tracker3D(T.TrackerConfig(), device="cpu")
    births = deaths = 0
    prev = set()
    for k, (boxes, scores, labels, motion) in enumerate(_sequence(seed)):
        m = motion if k else None
        jo = jt.update(boxes, scores, labels, dt=0.1, motion=m)
        to = tt.update(boxes, scores, labels, dt=0.1, motion=m)
        assert _strip(to) == _strip(jo), k
        for a, b in zip(to["objects"], jo["objects"]):
            for key in ("box", "velocity", "trajectory"):
                np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-9)
            assert a["score"] == pytest.approx(b["score"], abs=1e-12)
        ids = {t.id for t in tt.tracks}
        births, deaths, prev = births + len(ids - prev), deaths + len(prev - ids), ids
        for a, b in zip(tt.tracks, jt.tracks):
            assert a.id == b.id and a.hits == b.hits and a.misses == b.misses
            np.testing.assert_allclose(a.x, b.x, rtol=0, atol=1e-9)
            np.testing.assert_allclose(a.P, b.P, rtol=0, atol=1e-9)
    assert births > 8 and deaths > 2


def test_passthrough_tracker_matches():
    boxes = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)
    scores, labels = np.linspace(0.9, 0.5, 5), np.arange(5) % 3
    jo = J.PassThroughTracker().update(boxes, scores, labels)
    to = T.PassThroughTracker().update(boxes, scores, labels)
    assert _strip(to) == _strip(jo)
