"""Port parity for the online sources: the INS, radar and CAN parsers,
``InsMotionTracker``, ``InsSource``, ``RadarSource``, ``LidarUnit`` and
``LidarSource`` on live UDP datagrams, ``SourceManager``'s online merge and
its camera gate, ``FrameFusion``, ``LocalizationOutput``, the GStreamer cap
strings and the serial port; and the slice as a whole: frames that the
port's online source captured from live traffic, fed to both packages'
``SlamModule``.

Every input is made from a seed or written out; sockets bind port 0 (a
port the system picks) or a port just found free that way, never a fixed
one.  The parsers, decoders and the frames built from the same datagrams
must be equal to the reference's (bit for bit, or as Python values; the
stamps that either package takes from the host clock are left out or the
clock is fixed).  The slice's poses agree within 2e-3 m, the parity bar of
``tests/test_torch_slam_module.py``.

Reference behaviours pinned here (ROADMAP queue C): a GPS-stamped INS
stream windows no IMU row for a frame stamped on the monotonic clock and
gives the oldest buffered fix as the frame's pose; online frames carry
zero per-point time; the timer framing merges two scans that arrive within
one frame period.

    python -m tests.test_torch_online_sources <dir>

replays a recording that ``chip_smoke.rehearse_online(<dir>)`` kept through
both packages' SLAM stage on the CPU and prints each one's RMSE against
the truth saved beside it.
"""
import os
import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

import lsd_tpu.runtime as jrt
import lsd_tpu_torch.runtime as trt
from lsd_tpu.detection import fusion as jfusion
from lsd_tpu.io import gpchc as jgpchc
from lsd_tpu.io import ins_binary as jbin
from lsd_tpu.io import rs_difop as jdifop
from lsd_tpu.runtime import aux_sources as jaux
from lsd_tpu.runtime import gst_caps as jgst
from lsd_tpu.runtime import lidar_source as jlidar
from lsd_tpu.runtime import source_manager as jsm
from lsd_tpu.sensors import can_bus as jcan
from lsd_tpu.sensors import can_sink as jcansink
from lsd_tpu.sensors import ins as jins
from lsd_tpu.sensors import radar as jradar
from lsd_tpu.sensors import serial_port as jserial
from lsd_tpu.slam import loc_output as jloc
from lsd_tpu_torch.detection import fusion as tfusion
from lsd_tpu_torch.io import gpchc as tgpchc
from lsd_tpu_torch.io import ins_binary as tbin
from lsd_tpu_torch.io import rs_difop as tdifop
from lsd_tpu_torch.runtime import aux_sources as taux
from lsd_tpu_torch.runtime import camera_source as tcam
from lsd_tpu_torch.runtime import gst_caps as tgst
from lsd_tpu_torch.runtime import lidar_source as tlidar
from lsd_tpu_torch.runtime import source_manager as tsm
from lsd_tpu_torch.sensors import can_bus as tcan
from lsd_tpu_torch.sensors import can_sink as tcansink
from lsd_tpu_torch.sensors import ins as tins
from lsd_tpu_torch.sensors import radar as tradar
from lsd_tpu_torch.sensors import serial_port as tserial
from lsd_tpu_torch.slam import loc_output as tloc
from tests.test_torch_slam_module import private_buses  # noqa: F401 (autouse)

PKG = {"jax": dict(rt=jrt, gpchc=jgpchc, bin=jbin, difop=jdifop, aux=jaux, gst=jgst,
                   lidar=jlidar, sm=jsm, can=jcan, cansink=jcansink, ins=jins, radar=jradar,
                   serial=jserial, loc=jloc, fusion=jfusion),
       "torch": dict(rt=trt, gpchc=tgpchc, bin=tbin, difop=tdifop, aux=taux, gst=tgst,
                     lidar=tlidar, sm=tsm, can=tcan, cansink=tcansink, ins=tins, radar=tradar,
                     serial=tserial, loc=tloc, fusion=tfusion)}
POSE_ATOL = 2e-3
UNIX_US0 = 1_700_000_000_000_000


@pytest.fixture(autouse=True)
def _clean_interfaces():
    jrt.clear_interfaces()
    trt.clear_interfaces()
    yield
    jrt.clear_interfaces()
    trt.clear_interfaces()


@pytest.fixture
def fixed_clock(monkeypatch):
    """``time.time`` fixed: the binary INS parsers, the radar parser and the
    CAN status frame stamp with it."""
    monkeypatch.setattr(time, "time", lambda: UNIX_US0 / 1e6)


def free_ports(n, pairs=False):
    """``n`` UDP port numbers found free by binding port 0 (with ``pairs``,
    ports p whose p + 1 is free too: the RoboSense units' DIFOP port)."""
    out = []
    while len(out) < n:
        held = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)]
        held[0].bind(("127.0.0.1", 0))
        port = held[0].getsockname()[1]
        ok = port not in out and port + 1 not in out
        if ok and pairs:
            held.append(socket.socket(socket.AF_INET, socket.SOCK_DGRAM))
            try:
                held[1].bind(("127.0.0.1", port + 1))
            except OSError:
                ok = False
        for s in held:
            s.close()
        if ok:
            out.append(port)
    return out


def _equal(a, b):
    """Deep equality of frame-dict values (arrays bit for bit)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (sorted(a), sorted(b))
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    else:
        assert a == b, (a, b)


# --- packets (made as tests/test_native.py makes them) ------------------------

def vlp16_packet(dist_m, azimuth_deg, intensity=100):
    pkt = bytearray(1206)
    for b in range(12):
        off = b * 100
        pkt[off:off + 2] = b"\xff\xee"
        pkt[off + 2:off + 4] = struct.pack("<H", int(azimuth_deg * 100 + b * 20) % 36000)
        for rec in range(32):
            r = off + 4 + rec * 3
            pkt[r:r + 2] = struct.pack("<H", int((dist_m + 0.01 * rec) / 0.002))
            pkt[r + 2] = (intensity + rec) % 256
    return bytes(pkt)


def helios_packet(dist_m, azimuth_deg, intensity=40):
    pkt = bytearray(1248)
    pkt[0:4] = (0x5A05AA55).to_bytes(4, "little")
    for b in range(12):
        off = 42 + b * 100
        pkt[off:off + 2] = b"\xff\xee"
        pkt[off + 2:off + 4] = (int(azimuth_deg * 100 + b * 20) % 36000).to_bytes(2, "big")
        for rec in range(32):
            r = off + 4 + rec * 3
            pkt[r:r + 2] = int((dist_m + 0.02 * rec) / 0.0025).to_bytes(2, "big")
            pkt[r + 2] = intensity
    return bytes(pkt)


def custom_packet(pts, stamp_us):
    pts = np.asarray(pts, np.float32).reshape(-1, 4)
    return struct.pack("<IIQ", 0x4C53444C, len(pts), stamp_us) + pts.tobytes()


def gpchc_fix(k, t_us):
    return dict(timestamp=t_us, heading=10.0 + k, pitch=0.25, roll=-0.5,
                gyro_x=0.1 * k, gyro_y=-0.2, gyro_z=0.3, acc_x=0.01, acc_y=-0.02, acc_z=1.0,
                latitude=42.0 + k * 6e-6, longitude=-83.0 + k * 1e-6, altitude=200.0 + k,
                Ve=0.5, Vn=6.6, Vu=0.0, Status=42)


def _send(port, payloads, host="127.0.0.1"):
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for p in payloads:
        tx.sendto(p, (host, port))
    tx.close()


def _wait_received(units, n, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(u.rx.stats()[0] >= n for u in units):
            return
        time.sleep(0.01)
    raise AssertionError([u.rx.stats() for u in units])


# --- parsers --------------------------------------------------------------------

def test_gpchc_format_and_parse_match():
    rng = np.random.default_rng(0)
    for k in range(20):
        fix = gpchc_fix(k, UNIX_US0 + int(rng.integers(0, 10 ** 9)))
        fix.update(latitude=float(rng.uniform(-80, 80)), longitude=float(rng.uniform(-179, 179)))
        line = tgpchc.format_gpchc(fix)
        assert line == jgpchc.format_gpchc(fix)
        assert tgpchc.parse_gpchc(line) == jgpchc.parse_gpchc(line)
    for bad in ("", "$GPGGA,1,2", "$GPCHC," + ",".join("x" * 23), "$GPCHC,1,2,3"):
        assert tgpchc.parse_gpchc(bad) is None and jgpchc.parse_gpchc(bad) is None


def test_binary_ins_parsers_match():
    rng = np.random.default_rng(1)
    stream = b"junk"
    for k in range(4):
        fix = gpchc_fix(k, 0)
        fix.update(heading=float(rng.uniform(0, 359)), Status=int(rng.integers(0, 60)))
        raw = tbin.format_bddb0b(fix)
        assert raw == jbin.format_bddb0b(fix)
        stream += raw + bytes(rng.integers(0, 256, int(rng.integers(0, 5)), dtype=np.uint8))
    corrupt = bytearray(tbin.format_bddb0b(gpchc_fix(9, 0)))
    corrupt[20] ^= 0xFF
    stream += bytes(corrupt)
    outs = {}
    for pkg in PKG:
        buf, ptype, got = stream, 0, []
        for _ in range(12):
            fix, buf, ptype = PKG[pkg]["bin"].parse_bddb0b(buf, ptype, timestamp_us=7)
            got.append((fix, buf, ptype))
        outs[pkg] = got
    assert outs["torch"] == outs["jax"] and sum(f is not None for f, _, _ in outs["jax"]) == 4
    pkt = bytearray(60)
    struct.pack_into("<6f", pkt, 36, 0.1, -0.2, 0.3, 0.01, 0.0, 1.0)
    for p in (bytes(pkt), bytes(pkt[:59]), bytes(pkt[:10]) + b"\x01" + bytes(pkt[11:])):
        assert tbin.parse_livox_imu(p, 5) == jbin.parse_livox_imu(p, 5)


def test_rs_difop_match():
    rng = np.random.default_rng(2)
    vert = rng.integers(-2500, 1500, 32)
    horiz = rng.integers(-300, 300, 32)
    pkt = tdifop.build_rs_difop(vert, horiz, rpm=1200, fov=(10.0, 350.0), return_mode=2)
    assert pkt == jdifop.build_rs_difop(vert, horiz, rpm=1200, fov=(10.0, 350.0), return_mode=2)
    for n in (16, 32):
        _equal(tdifop.parse_rs_difop(pkt, n), jdifop.parse_rs_difop(pkt, n))
    bad = bytearray(pkt)
    bad[468] = 0xFF
    for p in (bytes(bad), pkt[:100], b"\x00" + pkt[1:]):
        assert tdifop.parse_rs_difop(p) is None and jdifop.parse_rs_difop(p) is None


def test_radar_and_can_codecs_match(fixed_clock):
    rng = np.random.default_rng(3)
    objs = [dict(id=int(i), x=float(rng.uniform(-100, 200)), y=float(rng.uniform(-50, 50)),
                 vx=float(rng.uniform(-20, 20)), vy=float(rng.uniform(-10, 10)),
                 ax=float(rng.uniform(-5, 5)), ay=float(rng.uniform(-2, 2)), type=int(t),
                 yaw_deg=float(rng.uniform(-170, 170)), length=4.2, width=1.8)
            for i, t in zip(range(6), [0, 1, 2, 3, 1, 2])]
    script = [(0x60A, b"\x01")]
    for o in objs:
        frames = tradar.encode_ars408_object(tradar.RadarObject(**o))
        assert frames == jradar.encode_ars408_object(jradar.RadarObject(**o))
        script += frames
    script += [(0x60A, b"\x02"), (0x700, b"\x00" * 8)]
    T = np.eye(4)
    T[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    T[:3, 3] = [1.0, 2.0, 0.5]
    out = {}
    for pkg in PKG:
        parser = PKG[pkg]["radar"].Ars408Parser(T)
        out[pkg] = [r if r is None else (r[0], [vars(o) for o in r[1]])
                    for r in (parser.feed(c, d) for c, d in script)]
    assert out["torch"] == out["jax"] and out["jax"][-2] is not None
    result = dict(timestamp=123456789, objects=[
        dict(id=o["id"], box=[o["x"], o["y"], 0.5, 4.2, 1.8, 1.5, 0.3 * k],
             velocity=[o["vx"], o["vy"], 0.0], label=k % 4, score=0.5 + 0.05 * k, age=k)
        for k, o in enumerate(objs)])
    frames = tcansink.encode_can_frames(result)
    assert frames == jcansink.encode_can_frames(result)
    for _, payload in frames[1::3]:
        assert tcansink.decode_can_obstacle_a(payload) == jcansink.decode_can_obstacle_a(payload)
    for cid, payload in frames:
        packed = tcan.pack_frame(cid, payload)
        assert packed == jcan.pack_frame(cid, payload)
        assert tcan.unpack_frame(packed) == jcan.unpack_frame(packed)
    assert tcan.can_available() == jcan.can_available()


def test_gst_cap_strings_match():
    cases = [dict(name="0", input_width=1920, input_height=1080, output_width=640,
                  output_height=360, flip_method=2, crop=[10, 20, 30, 40]),
             dict(name="rtsp://10.0.0.2/stream", output_width=1280, output_height=720),
             dict(name="http://10.0.0.3:2", flip_method=4),
             dict(name="flir:0", input_width=640, input_height=512, format="GRAY16_LE"),
             dict(name="usb:0"), dict(name="bad-name")]
    for cfg in cases:
        for jet in (False, True):
            c = dict(cfg, jetson=jet)
            for mode in ("online", "offline"):
                assert tgst.build_cap_string(c, mode) == jgst.build_cap_string(c, mode)
    assert tgst.is_jetson() == jgst.is_jetson()
    assert tcam.HAS_CV2 == (__import__("importlib").util.find_spec("cv2") is not None)


def test_serial_port_over_a_pty():
    import pty
    got = {}
    for pkg in PKG:
        master, slave = pty.openpty()
        try:
            port = PKG[pkg]["serial"].SerialPort(os.ttyname(slave), baud=115200, timeout_s=0.5)
            with port:
                os.write(master, b"$GPCHC,test\r\n")
                data = b""
                for _ in range(10):
                    data += port.read()
                    if b"\n" in data:
                        break
                port.write(b"ack")
                got[pkg] = (data, os.read(master, 16))
            assert not port.is_open
            with pytest.raises(OSError):
                port.read()
        finally:
            os.close(master)
            os.close(slave)
    assert got["torch"] == got["jax"] == (b"$GPCHC,test\r\n", b"ack")


def test_frame_fusion_matches():
    out = {}
    for pkg in PKG:
        f = PKG[pkg]["fusion"].FrameFusion(max_age_us=200_000)
        res = [f.fuse(dict(timestamp=1_000_000, objects=[1]))]
        f.push_aux(dict(timestamp=1_100_000, lights=["red"], objects=[9]))
        res += [f.fuse(dict(timestamp=t, objects=[2])) for t in (1_250_000, 1_400_000, 900_000)]
        out[pkg] = res
    assert out["torch"] == out["jax"]
    assert out["jax"][1]["lights"] == ["red"] and "lights" not in out["jax"][2]


# --- INS ------------------------------------------------------------------------

def _gpchc_stream(n, t0_us, step_us=10_000):
    return [jgpchc.format_gpchc(gpchc_fix(k, t0_us + k * step_us)) for k in range(n)]


def test_ins_motion_tracker_matches():
    out = {}
    for pkg in PKG:
        tr = PKG[pkg]["ins"].InsMotionTracker(buffer_s=0.5)
        for k, line in enumerate(_gpchc_stream(80, UNIX_US0)):
            fix = PKG[pkg]["gpchc"].parse_gpchc(line)
            tr.feed_fix(fix)
            tr.feed_imu(fix["timestamp"], [fix["gyro_x"], 0, 0], [0, 0, fix["acc_z"]])
        out[pkg] = [tr.trigger(UNIX_US0 + t) for t in (100_000, 455_000, 455_000, 790_000,
                                                       5_000_000)]
        out[pkg].append(tr.pose_at(UNIX_US0 + 600_123))
    _equal(out["torch"], out["jax"])
    assert len(out["jax"][1]["imu"]) == 17 and out["jax"][1]["motion_valid"]


def test_ins_source_feeds_and_triggers_match(fixed_clock):
    """GPCHC lines, a BDDB0B stream cut across two chunks and a Livox IMU
    datagram through ``InsSource.feed_bytes``; then ``trigger`` at GPS-time
    stamps (IMU window and interpolated pose) and at a monotonic-clock stamp,
    the online frames' (no IMU row; the oldest buffered fix as the pose:
    a reference behaviour, ROADMAP queue C)."""
    cfg = trt.ConfigManager().config
    bddb = jbin.format_bddb0b(dict(gpchc_fix(3, 0), heading=45.0, Status=4))
    livox = bytearray(60)
    struct.pack_into("<6f", livox, 36, 0.1, -0.2, 0.3, 0.0, 0.0, 1.0)
    out = {}
    for pkg in PKG:
        src = PKG[pkg]["aux"].InsSource(PKG[pkg]["rt"].ConfigManager().config)
        lines = _gpchc_stream(40, UNIX_US0)
        src.feed_bytes(("\r\n".join(lines[:20]) + "\r\n").encode())
        for line in lines[20:]:
            src.feed_bytes(line.encode())
        trig = [src.trigger(UNIX_US0 + t) for t in (55_000, 201_000, 390_000)]
        mono = src.trigger(int(time.monotonic() * 1e6))
        before = dict(src.last_fix)
        src.feed_bytes(bddb[:20])
        mid = src.last_fix
        src.feed_bytes(bddb[20:])
        src.feed_bytes(bytes(livox))
        out[pkg] = dict(trig=trig, mono=mono, before=before, mid=mid, last=src.last_fix,
                        imu=list(src.tracker.imu), fixes=[(t, T) for t, T, _ in src.tracker.fixes],
                        status=PKG[pkg]["rt"].call_interface("ins.get_status"))
    _equal(out["torch"], out["jax"])
    j = out["jax"]
    assert j["mid"] == j["before"] and j["last"]["heading"] == pytest.approx(45.0, abs=0.02)
    assert len(j["trig"][1]["imu"]) == 15 and j["trig"][2]["motion_valid"]
    assert j["mono"]["ins_valid"] and len(j["mono"]["imu"]) == 0
    np.testing.assert_array_equal(j["mono"]["pose"], j["fixes"][0][1])
    assert cfg.ins.use is False


def test_ins_source_udp_and_serial():
    """``InsSource`` bound to a port found free, and on a pty's serial port."""
    import pty
    got = {}
    for pkg in PKG:
        rt = PKG[pkg]["rt"]
        cfg = rt.ConfigManager().config
        port = free_ports(1)[0]
        src = PKG[pkg]["aux"].InsSource(cfg, port=port)
        src.setup(cfg)
        master, slave = pty.openpty()
        ser = PKG[pkg]["aux"].InsSource(rt.config.AttrDict(
            dict(ins=dict(device=os.ttyname(slave), baud=115200))))
        ser.setup(None)
        try:
            assert src.port == port
            lines = _gpchc_stream(5, UNIX_US0)
            deadline = time.time() + 5
            while time.time() < deadline and (src.last_fix is None or ser.last_fix is None):
                _send(port, [ln.encode() for ln in lines])
                os.write(master, (lines[0] + "\r\n").encode())
                time.sleep(0.05)
            got[pkg] = (src.last_fix, ser.last_fix)
        finally:
            src.release()
            ser.release()
            os.close(master)
            os.close(slave)
    assert got["torch"] == got["jax"] and got["jax"][0] is not None


def test_radar_source_matches(fixed_clock):
    out = {}
    for pkg in PKG:
        o = PKG[pkg]["radar"].RadarObject(id=3, x=20.0, y=-1.5, vx=8.0, type=1, length=4.2,
                                          width=1.8)
        script = [(0x60A, b"\x01")] + PKG[pkg]["radar"].encode_ars408_object(o) + \
            [(0x60A, b"\x01")]
        src = PKG[pkg]["aux"].RadarSource(None, can_reader=lambda s=script: [s.pop(0)] if s
                                          else [])
        frames = [src.get_data() for _ in range(5)]
        out[pkg] = [f["radar"] for f in frames if f] + \
            [PKG[pkg]["rt"].call_interface("radar.get_status")]
    assert out["torch"] == out["jax"] and len(out["jax"]) == 2


# --- LiDAR --------------------------------------------------------------------------

def test_lidar_units_decode_the_same_datagrams():
    """``LidarUnit.poll``/``frame`` of both packages on the same datagrams:
    a VLP-16 unit with an extrinsic, range gate and exclusion box, and an
    RS-Helios unit that rebinds its decoder to the factory angles of a
    DIFOP packet arriving on its port + 1."""
    rng = np.random.default_rng(4)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.5, -0.2, 1.8]
    vlp = [vlp16_packet(float(rng.uniform(2, 30)), float(rng.uniform(0, 360))) for _ in range(6)]
    hel = [helios_packet(float(rng.uniform(2, 30)), float(rng.uniform(0, 360))) for _ in range(4)]
    difop = jdifop.build_rs_difop(rng.integers(-2500, 1500, 32), rng.integers(-300, 300, 32))
    ports = free_ports(4, pairs=True)
    out = {}
    for i, pkg in enumerate(PKG):
        L = PKG[pkg]["lidar"]
        units = [L.LidarUnit("v", ports[2 * i], "VLP-16", extrinsic=T, range_min=3.0,
                             range_max=25.0, exclude_box=np.asarray([-5, 5, -5, 5, -3, 3])),
                 L.LidarUnit("h", ports[2 * i + 1], "RS-Helios")]
        try:
            _send(ports[2 * i + 1] + 1, [difop])
            deadline = time.time() + 5
            while not units[1].difop_loaded and time.time() < deadline:
                units[1].poll()
                time.sleep(0.01)
            _send(ports[2 * i], vlp)
            _send(ports[2 * i + 1], hel)
            _wait_received(units, 4)
            for u in units:
                u.poll()
            out[pkg] = [units[1].difop_loaded] + [u.frame() for u in units] + \
                [u.rx.stats() for u in units]
        finally:
            for u in units:
                u.close()
    _equal(out["torch"], out["jax"])
    assert out["jax"][0] and len(out["jax"][1]) > 500 and len(out["jax"][2]) == 4 * 384


def test_lidar_source_frames_match():
    """``LidarSource.get_data`` of both packages over two units (Custom and
    VLP-16): the same frame dict but for the host-clock stamps; the points
    carry zero per-point time, and two scans sent within one frame period
    land in one frame (reference behaviours, ROADMAP queue C)."""
    rng = np.random.default_rng(5)
    scans = [(rng.normal(size=(300, 4)) * [10, 10, 2, 1]).astype(np.float32) for _ in range(2)]
    vlp = [vlp16_packet(8.0, 30.0 * k) for k in range(3)]
    ports = free_ports(4)
    out = {}
    for i, pkg in enumerate(PKG):
        cfg = PKG[pkg]["rt"].ConfigManager().config
        cfg.input.scan_hz = 10.0
        cfg.lidar = [dict(name="0-Custom", port=ports[2 * i], decoder="Custom", range_min=0.0),
                     dict(name="1-VLP-16", port=ports[2 * i + 1], type="VLP-16")]
        src = PKG[pkg]["lidar"].LidarSource(cfg)
        src.setup(cfg)
        try:
            assert PKG[pkg]["rt"].interface.has_interface("lidar.start_package_transfer")
            _send(ports[2 * i], [custom_packet(s, 1000 + k) for k, s in enumerate(scans)])
            _send(ports[2 * i + 1], vlp)
            _wait_received(src.units[:1], 2)
            _wait_received(src.units[1:], 3)
            frame = src.get_data()
        finally:
            src.release()
        ts = frame["frame_start_timestamp"]
        assert frame["frame_timestamp_monotonic"] == ts
        for name in frame["points_attr"]:
            assert frame["points_attr"][name].pop("timestamp") == ts
        for key in ("frame_start_timestamp", "frame_timestamp_monotonic"):
            frame.pop(key)
        out[pkg] = frame
    _equal(out["torch"], out["jax"])
    j = out["jax"]
    assert len(j["points"]["0-Custom"]) == 600 and len(j["points"]["1-VLP-16"]) == 3 * 384
    assert not j["points_attr"]["0-Custom"]["points_attr"].any()


def test_source_manager_online_merge_matches(fixed_clock):
    """``SourceManager`` in online mode builds the LiDAR, radar and INS
    sources (no camera configured) and merges one frame of each: the LiDAR
    paces, the radar list is drained, the INS is triggered at the frame's
    stamp."""
    ports = free_ports(2)
    line = jgpchc.format_gpchc(gpchc_fix(1, UNIX_US0))
    pts = (np.random.default_rng(6).normal(size=(500, 4)) * [10, 10, 2, 1]).astype(np.float32)
    out = {}
    for i, pkg in enumerate(PKG):
        cfg = PKG[pkg]["rt"].ConfigManager().config
        cfg["input"].update(mode="online", scan_hz=20.0)
        cfg["lidar"] = [dict(name="0-Custom", port=ports[i], decoder="Custom")]
        cfg["radar"] = [dict(use=True)]
        cfg["ins"].update(use=True, port=0)
        src = PKG[pkg]["sm"].SourceManager(cfg)
        src.setup(cfg)
        try:
            assert src.player is None and src.camera is None
            assert src.lidar is not None and src.radar is not None and src.ins is not None
            src.ins.feed_sentence(line)
            src.radar.latest = (5, [PKG[pkg]["radar"].RadarObject(id=1, x=10.0, vx=3.0)])
            _send(ports[i], [custom_packet(pts, 1)])
            _wait_received(src.lidar.units, 1)
            d = src.get_data()
        finally:
            src.release()
        for key in ("frame_start_timestamp", "frame_timestamp_monotonic"):
            d.pop(key)
        d["points_attr"]["0-Custom"].pop("timestamp")
        out[pkg] = d
    _equal(out["torch"], out["jax"])
    j = out["jax"]
    assert j["radar_valid"] and j["ins_valid"] and j["_source"] == "Source"
    assert j["imu_data"].shape == (0, 7) and not j["motion_valid"]


def test_camera_sources_gate_alike(monkeypatch):
    """A camera in the online config: both packages' ``SourceManager`` build
    a ``CameraSource``, which drops a unit whose capture does not open (a
    missing file here); without OpenCV a unit refuses to open in both."""
    from lsd_tpu.runtime import camera_source as jcam
    out = {}
    for pkg in PKG:
        cfg = PKG[pkg]["rt"].ConfigManager().config
        cfg["input"].update(mode="online", scan_hz=20.0)
        cfg["camera"] = [dict(name="cam0", source="/nonexistent/video.mp4",
                              intrinsic_parameters=[500, 500, 320, 240])]
        src = PKG[pkg]["sm"].SourceManager(cfg)
        src.setup(cfg)
        try:
            d = src.get_data()
            out[pkg] = (src.camera is not None, len(src.camera.units), d["image"],
                        d["image_valid"], src.lidar, src.radar, src.ins)
        finally:
            src.release()
    assert out["torch"] == out["jax"] == (True, 0, {}, False, None, None, None)
    for mod in (tcam, jcam):
        monkeypatch.setattr(mod, "HAS_CV2", False)
        with pytest.raises(RuntimeError, match="cv2 unavailable"):
            mod.CameraUnit("cam0", 0)


def test_localization_output_matches():
    """``LocalizationOutput.emit``: a pose unprojected through the map's
    origin, the RTK passthrough and the silent cases, sent to a socket found
    free; both packages send the same sentences."""
    from lsd_tpu_torch.comms import MessageBus
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(2.0)
    port = rx.getsockname()[1]
    pose = np.eye(4)
    pose[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    pose[:3, 3] = [12.5, -3.25, 0.5]
    fix = gpchc_fix(2, UNIX_US0)
    got = []
    sub = MessageBus.core().subscribe(lambda ch, p: got.append(ch))
    out = {}
    try:
        for pkg in PKG:
            lo = PKG[pkg]["loc"].LocalizationOutput("127.0.0.1", port,
                                                    origin_lla=np.asarray([42.0, -83.0, 100.0]))
            bare = PKG[pkg]["loc"].LocalizationOutput("127.0.0.1", port)
            res = [lo.emit(UNIX_US0, pose), lo.emit(UNIX_US0, None, fix), lo.emit(UNIX_US0, None),
                   bare.emit(UNIX_US0, pose)]
            out[pkg] = res + [rx.recv(4096).decode() for _ in range(2)]
    finally:
        sub.close()
        rx.close()
    assert out["torch"] == out["jax"]
    assert out["jax"][2] is None and out["jax"][3] is None
    assert tgpchc.parse_gpchc(out["jax"][0])["Status"] == 4


# --- the slice as a whole ------------------------------------------------------------

N_SLICE, SLICE_POINTS = 12, 2048


def _capture_online(n, points):
    """Stream ``n`` scans of the 8 m ring (seed 21, ``points`` a scan, in
    Custom datagrams at 10 Hz) and GPCHC at 100 Hz to the port's
    ``SourceManager`` in online mode; returns the simulator, its scans and
    every frame that ``get_data`` made."""
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.tools.recording import fix_projector, truth_fix
    sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=n, points_per_scan=points,
                              point_noise=0.01, seed=21))
    data = sim.generate(capacity=points, imu_capacity=16)
    proj, p0 = fix_projector(), sim.pose(0.0)[1]
    events = [(k / 10.0, "lidar", custom_packet(np.concatenate(
        [s[0], np.zeros((points, 1), np.float32)], axis=1), k)) for k, s in enumerate(data)]
    events += [(j / 100.0, "ins", tgpchc.format_gpchc(
        truth_fix(sim, j / 100.0, UNIX_US0 + j * 10_000, proj, p0)).encode())
        for j in range(n * 10)]
    events.sort(key=lambda e: e[0])
    ports = dict(zip(("lidar", "ins"), free_ports(2)))
    cfg = trt.ConfigManager().config
    cfg["input"].update(mode="online", scan_hz=10.0)
    cfg["lidar"] = [dict(name="0-Custom", port=ports["lidar"], decoder="Custom", range_min=0.0)]
    cfg["ins"].update(use=True, port=ports["ins"])
    src = tsm.SourceManager(cfg)
    src.setup(cfg)
    frames = []

    def send():
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        t0 = time.perf_counter() + 0.15
        for t, kind, payload in events:
            time.sleep(max(0.0, t0 + t - time.perf_counter()))
            tx.sendto(payload, ("127.0.0.1", ports[kind]))
        tx.close()
    sender = threading.Thread(target=send, daemon=True)
    try:
        sender.start()
        deadline = time.time() + n / 10.0 + 5
        while time.time() < deadline and (sender.is_alive() or
                                          sum(len(f["points"]["0-Custom"]) for f in frames)
                                          < n * points):
            d = src.get_data()
            if d is not None:
                frames.append(d)
        received = src.lidar.units[0].rx.stats()
    finally:
        sender.join(5)
        src.release()
    assert received == (n, 0)
    return sim, data, frames


def test_online_frames_through_both_slam_modules():
    """Frames the port's online source captured (12 scans of 2,048 points
    through ``SourceManager``), fed to both packages' ``SlamModule``
    (mapping, graph work and fetch synchronous, the LIO seeded at the
    simulator's start): every point arrives in order, every frame carries
    the INS fix and no IMU row, and the poses agree within 2e-3 m."""
    from tests.test_torch_e2e_replay import _seed_jax
    from lsd_tpu.runtime.modules import SlamModule as JSlam
    from lsd_tpu_torch.runtime.modules import SlamModule as TSlam
    from lsd_tpu_torch.slam.lio import lio_init
    from lsd_tpu_torch.tools.profile_lio import nav_at_start
    sim, data, frames = _capture_online(N_SLICE, SLICE_POINTS)
    got = np.concatenate([f["points"]["0-Custom"] for f in frames])
    want = np.concatenate([s[0] for s in data])
    np.testing.assert_array_equal(got[:, :3], want)
    assert all(f["ins_valid"] and len(f["imu_data"]) == 0 for f in frames[2:])
    poses = {}
    for pkg, cls, kw in (("jax", JSlam, {}), ("torch", TSlam, dict(device="cpu"))):
        cfg = PKG[pkg]["rt"].ConfigManager().config
        cfg.input.mode = "online"
        cfg.slam.update(mode="mapping", resolution=0.4, key_frames_interval=[1.5, 0.3],
                        async_graph=False, async_fetch=False)
        m = cls(cfg, **kw)
        m.setup(cfg)
        if pkg == "jax":
            _seed_jax(m.engine, sim)
        else:
            m.engine.lio_state = lio_init(m.engine.cfg.lio, nav_at_start(sim, "cpu"))
        poses[pkg] = np.stack([m.process(dict(f))["slam_pose"].copy() for f in frames])
        m.release()
    assert np.isfinite(poses["torch"]).all() and len(poses["torch"]) == len(frames)
    np.testing.assert_allclose(poses["torch"], poses["jax"], atol=POSE_ATOL)


# --- the rehearsal's recording through both packages ---------------------------------

def replay_rehearsal(keep_dir):
    """RMSE against the truth of both packages' SLAM stage (mapping at the
    online phase's config, sync graph and fetch) over the frames that
    ``chip_smoke.rehearse_online(keep_dir)`` recorded."""
    from tests.test_torch_e2e_replay import _seed_jax
    from lsd_tpu.io.player import FramePlayer as JPlayer
    from lsd_tpu.runtime.modules import SlamModule as JSlam
    from lsd_tpu_torch.geometry import so3
    from lsd_tpu_torch.runtime.modules import SlamModule as TSlam
    from lsd_tpu_torch.slam.lio import lio_init
    from lsd_tpu_torch.slam.state import init_state
    z = np.load(os.path.join(keep_dir, "truth.npz"))
    rec = os.path.join(keep_dir, "online_out")
    rec = os.path.join(rec, sorted(os.listdir(rec))[0])
    frames = list(JPlayer(rec).iter_dicts())

    class Sim:
        def pose(self, t):
            return z["R0"], z["p0"]

        def velocity(self, t):
            return z["v0"]
    out = {}
    for pkg, cls, kw in (("jax", JSlam, {}), ("torch", TSlam, dict(device="cpu"))):
        cfg = PKG[pkg]["rt"].ConfigManager().config
        cfg.slam.update(mode="mapping", resolution=0.4, key_frames_interval=[1.5, 0.3],
                        async_graph=False, async_fetch=False)
        m = cls(cfg, **kw)
        m.setup(cfg)
        if pkg == "jax":
            _seed_jax(m.engine, Sim())
        else:
            f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
            m.engine.lio_state = lio_init(m.engine.cfg.lio, init_state(device="cpu")._replace(
                pos=f(z["p0"]), quat=so3.matrix_to_quat(f(z["R0"])), vel=f(z["v0"])))
        for d in frames:
            m.process(dict(d))
        traj = {s: T for s, T in m.engine.odometry}
        m.release()
        err = [np.sum((traj[s][:3, 3] - T[:3, 3]) ** 2) for s, T in zip(z["stamps"], z["truth"])]
        out[pkg] = float(np.sqrt(np.mean(err)))
    out["frames"] = len(frames)
    out["online_run_lio_rmse_m"] = float(np.sqrt(np.mean(
        np.sum((z["odom"][:, :3, 3] - z["truth"][:, :3, 3]) ** 2, axis=1))))
    return out


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    print(replay_rehearsal(sys.argv[1]))
