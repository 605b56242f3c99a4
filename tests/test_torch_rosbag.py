"""Port parity for the rosbag tool: ``lsd_tpu_torch/tools/rosbag.py``
against ``lsd_tpu/tools/rosbag.py`` on the cases of ``tests/test_rosbag.py``.

- The message codecs: equal bytes from both serializers, equal fields from
  both parsers (the PointCloud2 ``time`` field included).
- ``BagWriter``: byte-equal ``.bag`` files for the same messages; each
  package's ``BagReader`` reads the other's bag, with chunks stored
  uncompressed (``none``) or ``bz2``-compressed, to the same messages.
- ``rosbag_to_pkl`` (end- and start-stamped bags, the scan-start IMU
  window) and ``pkl_to_rosbag``: byte-equal ``.pkl`` and ``.bag`` files.
"""
import bz2
import os
import struct

import numpy as np
import pytest

from lsd_tpu.tools import rosbag as jbag
from lsd_tpu_torch.tools import rosbag as tbag

PACKAGES = pytest.mark.parametrize("mod", [jbag, tbag], ids=["jax", "torch"])


def _recording_files(log_dir):
    """{file name: bytes} of a recording directory."""
    return {name: open(os.path.join(log_dir, name), "rb").read()
            for name in sorted(os.listdir(log_dir))}


def _bz2_copy(src, dst):
    """``src`` rewritten with every chunk's payload bz2-compressed."""
    buf = open(src, "rb").read()
    off = len(jbag.MAGIC)
    out = [buf[:off]]
    while off < len(buf):
        header, data, nxt = jbag._read_record(buf, off)
        if header.get("op", b"\x00")[0] == jbag.OP_CHUNK:
            fields = dict(header, compression=b"bz2", size=struct.pack("<I", len(data)))
            out.append(jbag._emit_record(fields, bz2.compress(data)))
        else:
            out.append(buf[off:nxt])
        off = nxt
    with open(dst, "wb") as f:
        f.write(b"".join(out))
    return dst


def _write_mixed_bag(mod, path):
    pts = np.ones((10, 4), np.float32)
    with mod.BagWriter(path) as w:
        w.write("/velodyne_points", "sensor_msgs/PointCloud2",
                1_000_000_000, mod.serialize_pointcloud2(1_000_000_000, pts))
        w.write("/imu_raw", "sensor_msgs/Imu", 1_100_000_000,
                mod.serialize_imu(1_100_000_000, (0, 0, 0.1), (0, 0, 9.81)))
        w.write("/gps", "sensor_msgs/NavSatFix", 1_200_000_000,
                mod.serialize_navsatfix(1_200_000_000, 31.0, 121.0, 5.0))
        for k in range(3):
            w.write("/a", "sensor_msgs/Imu", k, mod.serialize_imu(k, (0, 0, 0), (0, 0, 9.81)))
            w.write("/b", "sensor_msgs/Imu", k, mod.serialize_imu(k, (0, 0, 0), (0, 0, 9.81)))
    return path


def _end_stamped_bag(mod, path, n_scans=3):
    """``tests/test_rosbag.py``'s end-stamped bag (IMU before each cloud)."""
    rng = np.random.default_rng(1)
    with mod.BagWriter(path) as w:
        t0 = 10_000_000_000
        for k in range(n_scans):
            t = t0 + k * 100_000_000
            for j in range(10):
                it = t - 100_000_000 + j * 10_000_000
                w.write("/imu_raw", "sensor_msgs/Imu", it,
                        mod.serialize_imu(it, (0, 0, 0.05), (0, 0, 9.81)))
            w.write("/gps", "sensor_msgs/NavSatFix", t,
                    mod.serialize_navsatfix(t, 31.0 + k * 1e-5, 121.0, 4.0, status=2))
            pts = rng.normal(size=(200, 4)).astype(np.float32) * 5
            w.write("/velodyne_points", "sensor_msgs/PointCloud2", t,
                    mod.serialize_pointcloud2(t, pts))
    return path


def _start_stamped_bag(mod, path, n_scans=3):
    """``tests/test_rosbag.py``'s start-stamped bag with per-point times."""
    rng = np.random.default_rng(2)
    with mod.BagWriter(path) as w:
        t0 = 10_000_000_000
        for k in range(n_scans):
            t = t0 + k * 100_000_000
            pts = rng.normal(size=(150, 4)).astype(np.float32) * 5
            trel = np.linspace(0, 0.099, 150).astype(np.float32)
            w.write("/velodyne_points", "sensor_msgs/PointCloud2", t,
                    mod.serialize_pointcloud2(t, pts, t_rel=trel))
            for j in range(10):
                it = t + j * 10_000_000
                w.write("/imu_raw", "sensor_msgs/Imu", it,
                        mod.serialize_imu(it, (0, 0, 0.05), (0, 0, 9.81)))
    return path


@pytest.mark.parametrize("t_rel", [None, np.arange(100, dtype=np.float32) * 1e-3],
                         ids=["xyzi", "xyzi_time"])
def test_pointcloud2_codec_matches(t_rel):
    pts = np.random.default_rng(0).normal(size=(100, 4)).astype(np.float32)
    pts[:, 3] = np.abs(pts[:, 3]) % 1.0
    raw = jbag.serialize_pointcloud2(123_456_789_000, pts, t_rel=t_rel)
    assert tbag.serialize_pointcloud2(123_456_789_000, pts, t_rel=t_rel) == raw
    for mod in (jbag, tbag):
        stamp, out, t = mod.parse_pointcloud2(raw)
        assert stamp == 123_456_789_000
        np.testing.assert_array_equal(out, jbag.parse_pointcloud2(raw)[1])
        if t_rel is None:
            assert t is None
        else:
            np.testing.assert_array_equal(t, t_rel)


def test_imu_and_navsatfix_codecs_match():
    raw = jbag.serialize_imu(42_000_000_000, (0.1, -0.2, 0.3), (0.0, 0.1, 9.8))
    assert tbag.serialize_imu(42_000_000_000, (0.1, -0.2, 0.3), (0.0, 0.1, 9.8)) == raw
    a, b = jbag.parse_imu(raw), tbag.parse_imu(raw)
    assert a["stamp_ns"] == b["stamp_ns"] == 42_000_000_000
    np.testing.assert_array_equal(a["gyro"], b["gyro"])
    np.testing.assert_array_equal(a["accel"], b["accel"])
    raw = jbag.serialize_navsatfix(7_000_000_000, 31.5, 121.25, 12.5, status=2)
    assert tbag.serialize_navsatfix(7_000_000_000, 31.5, 121.25, 12.5, status=2) == raw
    assert jbag.parse_navsatfix(raw) == tbag.parse_navsatfix(raw)


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_bags_byte_equal_and_read_across(tmp_path, compression):
    bj = _write_mixed_bag(jbag, str(tmp_path / "j.bag"))
    bt = _write_mixed_bag(tbag, str(tmp_path / "t.bag"))
    assert open(bj, "rb").read() == open(bt, "rb").read()
    if compression == "bz2":
        bj = _bz2_copy(bj, str(tmp_path / "j_bz2.bag"))
    want = list(jbag.BagReader(bj).read())
    assert [m[0] for m in want[:3]] == ["/velodyne_points", "/imu_raw", "/gps"]
    assert list(tbag.BagReader(bj).read()) == want
    assert list(tbag.BagReader(bj).read(["/b"])) == list(jbag.BagReader(bj).read(["/b"]))
    assert len(list(tbag.BagReader(bj).read(["/b"]))) == 3


@PACKAGES
def test_rejects_non_bag(tmp_path, mod):
    p = tmp_path / "x.bag"
    p.write_bytes(b"not a bag")
    with pytest.raises(ValueError, match="not a rosbag"):
        mod.BagReader(str(p))


@pytest.mark.parametrize("stamp_at,make", [("end", _end_stamped_bag),
                                           ("start", _start_stamped_bag)])
def test_rosbag_to_pkl_byte_equal(tmp_path, stamp_at, make):
    bag = make(jbag, str(tmp_path / "in.bag"))
    assert open(make(tbag, str(tmp_path / "in_t.bag")), "rb").read() == open(bag, "rb").read()
    rj = jbag.rosbag_to_pkl(bag, str(tmp_path / "rec_j"), stamp_at=stamp_at)
    rt = tbag.rosbag_to_pkl(bag, str(tmp_path / "rec_t"), stamp_at=stamp_at)
    fj, ft = _recording_files(rj), _recording_files(rt)
    assert len([n for n in fj if n.endswith(".pkl")]) == 3
    assert ft == fj
    if stamp_at == "start":
        # the scan-start window and the per-point times survive
        from lsd_tpu_torch.io.player import FramePlayer
        for f in FramePlayer(rt).iter_dicts():
            imu = f["imu_data"]
            assert imu.shape[0] == 10 and 0.0 <= imu[:, 0].min() and imu[:, 0].max() < 0.1
            (_, attr), = f["points_attr"].items()
            t = attr["points_attr"][:, 0]
            assert t.min() == 0.0 and abs(t.max() - 0.099) < 1e-5


def test_pkl_to_rosbag_byte_equal(tmp_path):
    bag = _end_stamped_bag(jbag, str(tmp_path / "in.bag"))
    rec = jbag.rosbag_to_pkl(bag, str(tmp_path / "rec"))
    nj = jbag.pkl_to_rosbag(rec, str(tmp_path / "out_j.bag"))
    nt = tbag.pkl_to_rosbag(rec, str(tmp_path / "out_t.bag"))
    assert nt == nj > 3
    assert open(tmp_path / "out_t.bag", "rb").read() == open(tmp_path / "out_j.bag", "rb").read()
    clouds = list(tbag.BagReader(str(tmp_path / "out_t.bag")).read(["/velodyne_points"]))
    assert len(clouds) == 3 and tbag.parse_pointcloud2(clouds[0][3])[1].shape == (200, 4)
