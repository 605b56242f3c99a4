"""Port parity for the dataset converters and file tools:
``lsd_tpu_torch/tools/{kitti,nclt,postprocessing,eval_formats}.py`` against
their ``lsd_tpu`` counterparts, on the inputs of ``tests/test_tools.py`` and
``tests/test_postprocessing.py`` made in ``tmp_path``.

- KITTI odometry, KITTI raw OXTS and NCLT (``velodyne_hits.bin`` with a
  corrupt byte to resync over, ``ms25.csv``, ``gps.csv``): byte-equal
  ``.pkl`` recordings.
- ``convert_map_pose``: byte-equal TUM files; ``accumulate_cloud``:
  byte-equal PCD files, with and without the voxel downsample.
- ``eval_formats.export_rosbag`` / ``export_nclt`` at a small ``CircleSim``:
  byte-equal files; ``replay_and_score`` through the port's ``Perception``
  on the CPU: every scan replayed, a finite ATE, the report's keys.
"""
import os

import numpy as np
import pytest

from lsd_tpu import sim as jsim
from lsd_tpu.io.recorder import FrameRecorder as JRecorder
from lsd_tpu.slam.map_io import save_map as jsave_map
from lsd_tpu.tools import eval_formats as jfmt
from lsd_tpu.tools import kitti as jkitti
from lsd_tpu.tools import nclt as jnclt
from lsd_tpu.tools import postprocessing as jpost
from lsd_tpu_torch import sim as tsim
from lsd_tpu_torch.io.pcd import read_pcd
from lsd_tpu_torch.tools import eval_formats as tfmt
from lsd_tpu_torch.tools import kitti as tkitti
from lsd_tpu_torch.tools import nclt as tnclt
from lsd_tpu_torch.tools import postprocessing as tpost
from tests import test_tools as ref_tools


def _files(d):
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


def _same_recordings(a, b, n_frames):
    fa, fb = _files(a), _files(b)
    assert len([n for n in fa if n.endswith(".pkl")]) == n_frames
    assert fa == fb


def test_kitti_odometry_byte_equal(tmp_path):
    seq = ref_tools.make_kitti_odometry(tmp_path)
    _same_recordings(jkitti.convert_kitti_odometry(seq, str(tmp_path / "j")),
                     tkitti.convert_kitti_odometry(seq, str(tmp_path / "t")), 4)


def test_kitti_raw_oxts_byte_equal(tmp_path):
    drive = ref_tools.make_kitti_raw(tmp_path)
    _same_recordings(jkitti.convert_kitti_raw_oxts(drive, str(tmp_path / "j")),
                     tkitti.convert_kitti_raw_oxts(drive, str(tmp_path / "t")), 3)


def test_nclt_byte_equal_with_resync(tmp_path):
    vel = ref_tools.TestNcltConverter()._write_nclt(tmp_path)
    raw = open(vel, "rb").read()
    # a stray byte between two packets: both readers resync one byte at a time
    cut = 20 + 50 * 8
    with open(vel, "wb") as f:
        f.write(raw[:cut] + b"\x00" + raw[cut:])
    kw = dict(ms25_csv=str(tmp_path / "ms25.csv"), gps_csv=str(tmp_path / "gps.csv"))
    rj = jnclt.convert_nclt(vel, str(tmp_path / "j"), **kw)
    rt = tnclt.convert_nclt(vel, str(tmp_path / "t"), **kw)
    _same_recordings(rj, rt, len([n for n in os.listdir(rj) if n.endswith(".pkl")]))
    import pickle
    d = pickle.load(open(os.path.join(rt, "000000.pkl"), "rb"))
    (pts,) = d["points"].values()
    assert len(pts) == 200                                  # 4 packets x 50 hits
    np.testing.assert_allclose(d["imu_data"][0, 6], 1.0, atol=0.01)    # m/s^2 -> g
    assert abs(d["ins_data"]["latitude"] - 42.29) < 1e-6    # radians -> degrees


@pytest.fixture(scope="module")
def map_and_recording(tmp_path_factory):
    """``tests/test_postprocessing.py``'s recording and map, written by the
    reference."""
    root = tmp_path_factory.mktemp("pp")
    rng = np.random.default_rng(3)
    rec = JRecorder(str(root / "rec"))
    stamps, poses, clouds = [], [], []
    for k in range(8):
        ts = 1_000_000 + k * 100_000
        pts = rng.uniform(-5, 5, (500, 4)).astype(np.float32)
        pts[:, 2] = np.abs(pts[:, 2])
        rec.write(dict(
            frame_start_timestamp=ts, frame_timestamp_monotonic=ts,
            points={"0-Custom": pts},
            points_attr={"0-Custom": dict(timestamp=ts,
                                          points_attr=np.zeros((500, 2), np.float32))},
            image={}, image_param={}, lidar_valid=True, image_valid=False,
            radar_valid=False, ins_valid=False, ins_data={},
            imu_data=np.asarray([[ts, 0, 0, 0, 0, 0, 1.0]], np.float64),
            motion_valid=False, timestep=100000))
        T = np.eye(4)
        T[0, 3] = 2.0 * k
        c, s = np.cos(0.1 * k), np.sin(0.1 * k)      # a turn, so that nlerp has work
        T[:2, :2] = [[c, -s], [s, c]]
        stamps.append(ts)
        poses.append(T)
        clouds.append(pts)
    map_dir = str(root / "map")
    jsave_map(map_dir, np.zeros(3), stamps, poses, clouds, edges=[], fixed=[0])
    return rec.log_dir, map_dir, root


def test_convert_map_pose_byte_equal(map_and_recording):
    _rec, map_dir, root = map_and_recording
    a = jpost.convert_map_pose(map_dir, str(root / "j.txt"))
    b = tpost.convert_map_pose(map_dir, str(root / "t.txt"))
    assert open(a, "rb").read() == open(b, "rb").read()
    assert np.loadtxt(b).shape == (8, 8)


@pytest.mark.parametrize("resolution", [0.0, 1.0])
def test_accumulate_cloud_matches(map_and_recording, resolution):
    rec, map_dir, root = map_and_recording
    kw = dict(resolution=resolution, z_min=-10.0, z_max=10.0)
    a = jpost.accumulate_cloud(rec, map_dir, str(root / f"j{resolution}.pcd"), **kw)
    b = tpost.accumulate_cloud(rec, map_dir, str(root / f"t{resolution}.pcd"), device="cpu", **kw)
    assert open(a, "rb").read() == open(b, "rb").read()
    n = len(read_pcd(b))
    assert n == 7 * 500 if resolution == 0.0 else 0 < n < 7 * 500


def _small_sim(pkg, n_scans=6, points=2048):
    return pkg.CircleSim(pkg.SimConfig(radius=8.0, omega=0.8, n_scans=n_scans,
                                       points_per_scan=points, seed=33, point_noise=0.01,
                                       rest_time=1.5, ramp_time=1.0))


def test_eval_formats_exports_byte_equal(tmp_path):
    out = {}
    for name, pkg, fmt in (("j", jsim, jfmt), ("t", tsim, tfmt)):
        sim = _small_sim(pkg)
        data = sim.generate(capacity=2048, imu_capacity=16)
        bag = fmt.export_rosbag(sim, data, str(tmp_path / f"{name}.bag"))
        hits, ms25 = fmt.export_nclt(sim, data, str(tmp_path / f"nclt_{name}"))
        out[name] = [open(p, "rb").read() for p in (bag, hits, ms25)]
    assert out["t"] == out["j"]


def test_replay_and_score_runs(tmp_path):
    from lsd_tpu_torch.tools.rosbag import rosbag_to_pkl
    n = 30
    sim = _small_sim(tsim, n_scans=n)
    data = sim.generate(capacity=2048, imu_capacity=16)
    bag = tfmt.export_rosbag(sim, data, str(tmp_path / "seq.bag"))
    rec = rosbag_to_pkl(bag, str(tmp_path / "rec"))
    gt_ts = [1_700_000_000 * 1_000_000 + k * 100_000 for k in range(n)]
    r = tfmt.replay_and_score(rec, sim, [d[5] for d in data], warmup=5, gt_ts_us=gt_ts,
                              device="cpu")
    assert set(r) == {"ate", "frames", "keyframes", "wall", "integrated", "busy_s"}
    assert r["frames"] == r["integrated"] == n and np.isfinite(r["ate"]) and r["keyframes"] >= 1
    assert 0 < r["busy_s"] <= r["wall"]
