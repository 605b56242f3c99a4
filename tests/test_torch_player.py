"""Port parity for the recording format: ``io/recorder.py`` (``FrameRecorder``)
and ``io/player.py`` (``FramePlayer``, ``normalize_frame_dict``).

A recording written by either package replays in the other: the same
``%06d.pkl`` names and ``cfg.yaml``, equal pickled bytes, and equal dicts
after ``normalize_frame_dict``, also on the reference test's legacy dicts
(no ``points_attr``, no ``imu_data``, no ``motion_valid``, an old Ouster
name).  Rotation with ``frames_per_log`` and ``max_logs`` leaves the same
directories and files in both; as in the reference, eviction runs after the
new directory is made and keeps ``max_logs - 1`` directories, so
``max_logs=1`` deletes the directory it is about to write to and the write
raises (ROADMAP queue C).  No tolerance: every comparison is exact.
"""
import dataclasses
import datetime
import os
import pickle

import numpy as np
import pytest

from lsd_tpu.io import player as jplayer
from lsd_tpu.io import recorder as jrecorder
from lsd_tpu.io.frame import frame_from_dict as jframe
from lsd_tpu_torch.io import player as tplayer
from lsd_tpu_torch.io import recorder as trecorder
from lsd_tpu_torch.io.frame import frame_from_dict as tframe
from tests.test_io import make_frame_dict


def _equal(a, b):
    """Deep equality of frame dicts (numpy arrays by dtype and value)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_equal, a, b))
    return type(a) is type(b) and a == b


def _legacy(k):
    d = make_frame_dict(ts=1_000_000 + k * 100_000, n=50 + k)
    if k % 2:
        del d["points_attr"], d["imu_data"], d["motion_valid"], d["frame_timestamp_monotonic"]
        d["points"] = {"0Ouster-OS1": d["points"].pop("0-Ouster-OS1")}
        d["image_param"] = {"cam0": dict(width=4)}
        d["pose"] = dict(x=1.0)
    return d


class _Clock:
    """A datetime stand-in whose now() steps one second per call, so that
    every rotated log directory gets its own name."""

    def __init__(self):
        self.t = datetime.datetime(2024, 5, 6, 7, 8, 9)

    def now(self):
        self.t += datetime.timedelta(seconds=1)
        return self.t


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_recording_cross_reads(tmp_path, writer):
    rec_mod = jrecorder if writer == "jax" else trecorder
    rec = rec_mod.FrameRecorder(str(tmp_path), cfg_yaml="pipeline:\n- [Source, Sink]\n")
    frames = [_legacy(k) for k in range(6)]
    for d in frames:
        rec.write(d)
    log = rec.log_dir
    assert sorted(os.listdir(log)) == ["%06d.pkl" % k for k in range(6)] + ["cfg.yaml"]
    jp, tp = jplayer.FramePlayer(log, point_capacity=128), tplayer.FramePlayer(log, point_capacity=128)
    assert len(jp) == len(tp) == 6 and jp.files == tp.files
    for k in range(6):
        a, b = jp.read_dict(k), tp.read_dict(k)
        assert _equal(a, b)
        assert "0-Ouster-OS1" in b["points"] and b["motion_valid"] is True
    for fa, fb in zip(jp, tp):
        assert fa.timestamp_monotonic == fb.timestamp_monotonic
        assert np.array_equal(fa.scan.points, fb.scan.points)
        assert np.array_equal(fa.imu.data, fb.imu.data)
        assert dataclasses.asdict(fa.ins) == dataclasses.asdict(fb.ins)
    for da, db in zip(jp.iter_dicts(), tp.iter_dicts()):
        assert _equal(da, db)
    # the typed frames of both packages agree too
    d = tp.read_dict(1)
    assert np.array_equal(tframe(d, 64).scan.points, jframe(d, 64).scan.points)


def test_written_bytes_equal(tmp_path):
    j = jrecorder.FrameRecorder(str(tmp_path / "j"))
    t = trecorder.FrameRecorder(str(tmp_path / "t"))
    for k in range(3):
        pj, pt = j.write(_legacy(k)), t.write(_legacy(k))
        assert os.path.basename(pj) == os.path.basename(pt)
        assert open(pj, "rb").read() == open(pt, "rb").read()


@pytest.mark.parametrize("k", range(4))
def test_normalize_legacy_dicts(k):
    d = _legacy(k)
    a = jplayer.normalize_frame_dict(pickle.loads(pickle.dumps(d)))
    b = tplayer.normalize_frame_dict(pickle.loads(pickle.dumps(d)))
    assert _equal(a, b)
    if k % 2:
        assert b["imu_data"].shape == (1, 7)
        assert b["frame_timestamp_monotonic"] == d["frame_start_timestamp"]
        assert b["pose"]["area"] is None
        assert b["image_param"]["cam0"]["timestamp"] == d["frame_start_timestamp"] + 100000


@pytest.mark.parametrize("frames_per_log,max_logs,n", [(3, 3, 10), (4, None, 9), (2, 2, 5)])
def test_rotation(tmp_path, monkeypatch, frames_per_log, max_logs, n):
    listings = []
    for name, mod in (("j", jrecorder), ("t", trecorder)):
        monkeypatch.setattr(mod.datetime, "datetime", _Clock())
        root = tmp_path / name
        rec = mod.FrameRecorder(str(root), frames_per_log=frames_per_log, max_logs=max_logs)
        for k in range(n):
            rec.write(make_frame_dict(ts=1_000_000 + k, n=8))
        listings.append({d: sorted(os.listdir(root / d)) for d in sorted(os.listdir(root))})
        monkeypatch.undo()
    assert listings[0] == listings[1]
    dirs = listings[1]
    # the newest directory holds the tail; older ones are full or evicted
    made = -(-n // frames_per_log)
    assert len(dirs) == (min(max_logs - 1, made) if max_logs else made)
    assert list(dirs.values())[-1] == ["%06d.pkl" % k for k in range((n - 1) % frames_per_log + 1)]


def test_rotation_keeping_one_log_raises_in_both(tmp_path, monkeypatch):
    for name, mod in (("j", jrecorder), ("t", trecorder)):
        monkeypatch.setattr(mod.datetime, "datetime", _Clock())
        rec = mod.FrameRecorder(str(tmp_path / name), frames_per_log=2, max_logs=1)
        with pytest.raises(FileNotFoundError):
            rec.write(make_frame_dict(n=8))
        monkeypatch.undo()
