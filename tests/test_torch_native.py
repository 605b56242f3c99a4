"""Port parity for the native sensor-ingest binding (``lsd_tpu_torch/native``
against ``lsd_tpu/native``): both load a build of the repo's
``native/src/lsd_native.cpp``, the port's its own under
``lsd_tpu_torch/_build/native/``.

- Every decoder of ``DECODERS`` (and the RoboSense ones with calibration
  tables, Ouster with beam tables) on the same seeded packets, and on
  random bytes: equal outputs bit for bit, and equal stamps.
- ``points_postprocess`` with an extrinsic, a range gate and an exclusion
  box: equal bit for bit.
- ``UdpReceiver`` on a port found free by binding port 0: capture, ring
  stats and the packet relay.
- The build: into the port's build directory, never ``native/``, once
  under concurrent callers, raising when the compiler fails.

The packet builders are copies of ``tests/test_native.py``'s.
"""
import os
import shutil
import socket
import struct
import threading
import time

import numpy as np
import pytest

from lsd_tpu import native as jnative
from lsd_tpu_torch import native as tnative
from tests.test_torch_online_sources import free_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_custom_packet(pts, stamp_us=123456789):
    pts = np.asarray(pts, np.float32).reshape(-1, 4)
    return struct.pack("<IIQ", 0x4C53444C, len(pts), stamp_us) + pts.tobytes()


def make_vlp16_packet(dist_m=10.0, azimuth_deg=90.0, intensity=100):
    pkt = bytearray(1206)
    for b in range(12):
        off = b * 100
        pkt[off:off + 2] = b"\xff\xee"
        az = int(azimuth_deg * 100) % 36000
        pkt[off + 2:off + 4] = struct.pack("<H", az)
        for rec in range(32):
            r = off + 4 + rec * 3
            pkt[r:r + 2] = struct.pack("<H", int(dist_m / 0.002))
            pkt[r + 2] = intensity
    return bytes(pkt)


def make_rs16_packet(dist_m=10.0, azimuth_deg=90.0, intensity=80):
    pkt = bytearray(1248)
    for b in range(12):
        off = 42 + b * 100
        pkt[off:off + 2] = b"\xff\xee"
        az = int(azimuth_deg * 100) % 36000
        pkt[off + 2:off + 4] = az.to_bytes(2, "big")
        for rec in range(32):
            r = off + 4 + rec * 3
            pkt[r:r + 2] = int(dist_m / 0.0025).to_bytes(2, "big")
            pkt[r + 2] = intensity
    return bytes(pkt)


def make_livox_packet(pts_mm, refl=120, stamp_ns=987654321):
    hdr = bytearray(18)
    hdr[9] = 2  # data type: cartesian
    hdr[10:18] = int(stamp_ns).to_bytes(8, "little")
    body = bytearray()
    for (x, y, z) in pts_mm:
        body += int(x).to_bytes(4, "little", signed=True)
        body += int(y).to_bytes(4, "little", signed=True)
        body += int(z).to_bytes(4, "little", signed=True)
        body += bytes([refl, 0])
    return bytes(hdr + body)


def make_ouster_packet(n_beams=64, range_m=15.0, encoder=22528, refl=200):
    block_size = 16 + n_beams * 12 + 4
    pkt = bytearray(16 * block_size)
    for b in range(16):
        off = b * block_size
        pkt[off:off + 8] = struct.pack("<Q", 1000 + b)
        pkt[off + 8:off + 10] = struct.pack("<H", b)
        pkt[off + 10:off + 12] = struct.pack("<H", 1)
        pkt[off + 12:off + 16] = struct.pack("<I", (encoder + b * 88) % 90112)
        for ch in range(n_beams):
            r = off + 16 + ch * 12
            pkt[r:r + 4] = struct.pack("<I", int(range_m * 1000) + ch)
            pkt[r + 4:r + 6] = struct.pack("<H", refl)
        pkt[off + block_size - 4:off + block_size] = struct.pack("<I", 0xFFFFFFFF)
    return bytes(pkt)


def make_lsc16_packet(dist_m=10.0, azimuth_deg=0.0, intensity=77):
    pkt = bytearray(1206)
    for b in range(12):
        off = b * 100
        pkt[off:off + 2] = b"\xff\xee"
        az = int(azimuth_deg * 100) % 36000
        pkt[off + 2:off + 4] = az.to_bytes(2, "little")
        for rec in range(32):
            r = off + 4 + rec * 3
            pkt[r:r + 2] = int(dist_m / 0.01).to_bytes(2, "little")
            pkt[r + 2] = intensity
    return bytes(pkt)


def make_rs32_packet(dist_m=20.0, azimuth_deg=0.0, intensity=60):
    pkt = bytearray(1248)
    pkt[0:8] = (0xA050A55A0A05AA55).to_bytes(8, "little")
    for b in range(12):
        off = 42 + b * 100
        pkt[off:off + 2] = b"\xff\xee"
        az = int(azimuth_deg * 100) % 36000
        pkt[off + 2:off + 4] = az.to_bytes(2, "big")
        for rec in range(32):
            r = off + 4 + rec * 3
            pkt[r:r + 2] = int(dist_m / 0.005).to_bytes(2, "big")
            pkt[r + 2] = intensity
    return bytes(pkt)


def make_rs_ruby_packet(dist_m=30.0, azimuth_deg=0.0, intensity=50):
    pkt = bytearray(1248)
    pkt[0:4] = (0x5A05AA55).to_bytes(4, "little")
    blk_size = 4 + 80 * 3
    for b in range(4):
        off = 80 + b * blk_size
        pkt[off] = 0xFE
        az = int(azimuth_deg * 100) % 36000
        pkt[off + 2:off + 4] = az.to_bytes(2, "big")
        for rec in range(80):
            r = off + 4 + rec * 3
            pkt[r:r + 2] = int(dist_m / 0.005).to_bytes(2, "big")
            pkt[r + 2] = intensity
    return bytes(pkt)


def make_rs_helios_packet(dist_m=25.0, azimuth_deg=0.0, intensity=40):
    pkt = bytearray(1248)
    pkt[0:4] = (0x5A05AA55).to_bytes(4, "little")
    for b in range(12):
        off = 42 + b * 100
        pkt[off:off + 2] = b"\xff\xee"
        az = int(azimuth_deg * 100) % 36000
        pkt[off + 2:off + 4] = az.to_bytes(2, "big")
        for rec in range(32):
            r = off + 4 + rec * 3
            pkt[r:r + 2] = int(dist_m / 0.0025).to_bytes(2, "big")
            pkt[r + 2] = intensity
    return bytes(pkt)


def make_rs_m1_packet(dist_m=40.0, pitch_deg=5.0, yaw_deg=10.0, intensity=90):
    pkt = bytearray(1210)
    pkt[0:4] = (0xA55AAA55).to_bytes(4, "little")
    blk_size = 2 + 5 * 9
    for b in range(25):
        off = 32 + b * blk_size
        for ch in range(5):
            r = off + 2 + ch * 9
            pkt[r:r + 2] = int(dist_m / 0.005).to_bytes(2, "big")
            pkt[r + 2:r + 4] = (int(pitch_deg * 100) + 32768).to_bytes(2, "big")
            pkt[r + 4:r + 6] = (int(yaw_deg * 100) + 32768).to_bytes(2, "big")
            pkt[r + 6] = intensity
    return bytes(pkt)


def make_ouster_v3_packet(rings=32, range_mm=15000, m_id0=0, signal=1024):
    col_bytes = 12 + rings * 12
    pkt = bytearray(32 + 16 * col_bytes)
    struct.pack_into("<H", pkt, 0, 1)     # packet_type
    struct.pack_into("<H", pkt, 2, 7)     # frame_id
    for c in range(16):
        off = 32 + c * col_bytes
        struct.pack_into("<Q", pkt, off, 5000 + c)
        struct.pack_into("<H", pkt, off + 8, (m_id0 + c) % 1024)
        struct.pack_into("<H", pkt, off + 10, 1)  # status: valid
        for ch in range(rings):
            r = off + 12 + ch * 12
            struct.pack_into("<I", pkt, r, range_mm + 7 * ch)
            struct.pack_into("<H", pkt, r + 6, signal)
    return bytes(pkt)


def _batch(pkts, stride=2048):
    """Packets in one (n, stride) uint8 buffer as the receiver pops them."""
    stride = max(stride, max(len(p) for p in pkts))
    buf = np.zeros((len(pkts), stride), np.uint8)
    for k, p in enumerate(pkts):
        buf[k, :len(p)] = np.frombuffer(p, np.uint8)
    return buf, np.asarray([len(p) for p in pkts], np.uint32)


def _packets(name, rng):
    """Three packets of decoder ``name`` at seeded ranges and angles."""
    u = lambda lo, hi: float(rng.uniform(lo, hi))
    if name in ("VLP-16",):
        return [make_vlp16_packet(u(2, 60), u(0, 360), int(rng.integers(0, 255))) for _ in range(3)]
    if name == "LS-C-16":
        return [make_lsc16_packet(u(2, 60), u(0, 360), int(rng.integers(0, 255))) for _ in range(3)]
    if name == "RS-16":
        return [make_rs16_packet(u(2, 60), u(0, 360)) for _ in range(3)]
    if name == "RS-32":
        return [make_rs32_packet(u(2, 60), u(0, 360)) for _ in range(3)]
    if name == "RS-Ruby-Lite":
        return [make_rs_ruby_packet(u(2, 60), u(0, 360)) for _ in range(3)]
    if name.startswith("RS-Helios"):
        return [make_rs_helios_packet(u(2, 60), u(0, 360)) for _ in range(3)]
    if name == "RS-M1":
        return [make_rs_m1_packet(u(2, 60), u(-10, 10), u(-50, 50)) for _ in range(3)]
    if name == "Livox-Mid-360":
        return [make_livox_packet(rng.integers(-20000, 20000, (40, 3)), stamp_ns=1000 + k)
                for k in range(3)]
    if name.endswith("-v3"):
        rings = int(name.split("-")[2])
        return [make_ouster_v3_packet(rings, int(rng.integers(1000, 60000)), 16 * k)
                for k in range(3)]
    if name.startswith("Ouster"):
        beams = 128 if "128" in name else 64
        return [make_ouster_packet(beams, u(2, 60), int(rng.integers(0, 90112))) for _ in range(3)]
    assert name == "Custom"
    return [make_custom_packet(rng.normal(size=(50, 4)), 77 + k) for k in range(3)]


def _equal_out(a, b):
    """Decoder outputs (points, or (points, stamp)) equal bit for bit."""
    if isinstance(a, tuple):
        assert a[1] == b[1]
        a, b = a[0], b[0]
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_registry_and_tables_match():
    assert list(tnative.DECODERS) == list(jnative.DECODERS) and len(tnative.DECODERS) == 16
    assert tnative.DECODER_MAX_PACKET == jnative.DECODER_MAX_PACKET
    assert tnative.OUSTER_PACKET_BYTES == jnative.OUSTER_PACKET_BYTES
    assert tnative.OUSTER_V3_PACKET_BYTES == jnative.OUSTER_V3_PACKET_BYTES
    for n, fov in ((32, 45.0), (64, 33.2), (128, 90.0)):
        for a, b in zip(tnative.ouster_beam_tables(n, fov), jnative.ouster_beam_tables(n, fov)):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", list(jnative.DECODERS))
def test_decoder_matches(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    pkts = _packets(name, rng)
    stride = jnative.DECODER_MAX_PACKET.get(name, 2048)
    buf, lens = _batch(pkts, min(stride, 16384))
    out = tnative.DECODERS[name](buf, lens)
    _equal_out(out, jnative.DECODERS[name](buf, lens))
    assert len(out[0]) > 0
    junk = rng.integers(0, 256, buf.shape, dtype=np.uint8)
    _equal_out(tnative.DECODERS[name](junk, lens), jnative.DECODERS[name](junk, lens))


def test_calibrated_decoders_match():
    rng = np.random.default_rng(9)
    v32, h32 = rng.integers(-2500, 1500, 32), rng.integers(-300, 300, 32)
    v80, h80 = rng.integers(-2500, 1500, 80), rng.integers(-300, 300, 80)
    rs32 = _batch([make_rs32_packet(12.0, 40.0)])
    ruby = _batch([make_rs_ruby_packet(22.0, 140.0)])
    hel = _batch([make_rs_helios_packet(17.0, 240.0)])
    for mod_a, mod_b in ((tnative, jnative),):
        _equal_out(mod_a.decode_rs32(*rs32, vert_cd=v32, horiz_cd=h32),
                   mod_b.decode_rs32(*rs32, vert_cd=v32, horiz_cd=h32))
        _equal_out(mod_a.decode_rs_ruby(*ruby, vert_cd=v80, horiz_cd=h80),
                   mod_b.decode_rs_ruby(*ruby, vert_cd=v80, horiz_cd=h80))
        for n in (16, 32):
            _equal_out(mod_a.decode_rs_helios(*hel, n_lasers=n, vert_cd=v32[:n], horiz_cd=h32[:n]),
                       mod_b.decode_rs_helios(*hel, n_lasers=n, vert_cd=v32[:n],
                                              horiz_cd=h32[:n]))
    alt = np.sort(rng.uniform(-22, 22, 64)).astype(np.float32)[::-1].copy()
    az = rng.uniform(-3, 3, 64).astype(np.float32)
    ost = _batch([make_ouster_packet(64, 9.0, 12345)], 16384)
    _equal_out(tnative.decode_ouster(*ost, beam_alt_deg=alt, beam_az_deg=az),
               jnative.decode_ouster(*ost, beam_alt_deg=alt, beam_az_deg=az))
    v3 = _batch([make_ouster_v3_packet(64, 23000, 5)], 16384)
    _equal_out(tnative.decode_ouster_v3(*v3, rings=64, beam_alt_deg=alt, beam_az_deg=az,
                                        beam_to_lidar_mm=12.1, z_offset=0.036),
               jnative.decode_ouster_v3(*v3, rings=64, beam_alt_deg=alt, beam_az_deg=az,
                                        beam_to_lidar_mm=12.1, z_offset=0.036))


def test_points_postprocess_matches():
    rng = np.random.default_rng(10)
    pts = (rng.normal(size=(5000, 4)) * [20, 20, 3, 1]).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = [1.5, -0.5, 1.9]
    box = np.asarray([-3, 3, -1.5, 1.5, -1, 3], np.float32)
    for kw in (dict(), dict(T=T), dict(range_min=2.0, range_max=30.0),
               dict(T=T, range_min=1.0, range_max=40.0, exclude_box=box)):
        a, b = tnative.points_postprocess(pts, **kw), jnative.points_postprocess(pts, **kw)
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    assert len(tnative.points_postprocess(pts, T=T, range_min=1.0, range_max=40.0,
                                          exclude_box=box)) < len(pts)


def test_udp_receiver_capture_stats_and_relay():
    pa, pb = free_ports(2)
    rx_a = tnative.UdpReceiver(pa)
    rx_b = tnative.UdpReceiver(pb, max_packet=4096)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        pkts = [make_custom_packet(np.full((k + 1, 4), k, np.float32), k) for k in range(5)]
        rx_a.start_relay("127.0.0.1", pb)
        for p in pkts:
            tx.sendto(p, ("127.0.0.1", pa))
        deadline = time.time() + 5
        while time.time() < deadline and (rx_a.stats()[0] < 5 or rx_b.stats()[0] < 5):
            time.sleep(0.01)
        got_a, got_b = rx_a.pop(), rx_b.pop()
        assert got_a[0].shape == (5, 2048) and got_b[0].shape == (5, 4096)
        for buf, lens in (got_a, got_b):
            assert [bytes(r[:n]) for r, n in zip(buf, lens)] == pkts
        assert rx_a.stats() == (5, 0) and rx_b.stats() == (5, 0)
        rx_a.stop_relay()
        tx.sendto(pkts[0], ("127.0.0.1", pa))
        time.sleep(0.2)
        assert len(rx_a.pop()[1]) == 1 and len(rx_b.pop()[1]) == 0
        with pytest.raises(OSError):
            rx_a.start_relay("not-an-ip", pb)
        holder = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        holder.bind(("0.0.0.0", 0))          # held without SO_REUSEADDR
        with pytest.raises(OSError):
            tnative.UdpReceiver(holder.getsockname()[1])
        holder.close()
    finally:
        tx.close()
        rx_a.close()
        rx_b.close()


def test_library_is_built_in_the_port_and_once(tmp_path, monkeypatch):
    """The loaded library lies under ``lsd_tpu_torch/_build/native/`` and
    carries the sources' fingerprint; ``native/`` gains nothing.  Into an
    empty build directory three threads build once, under the file lock,
    leaving no temporary file; a compiler failure raises."""
    before = sorted(os.listdir(os.path.join(REPO, "native")))
    tnative.get_lib()
    path = tnative.library_path()
    assert path.startswith(os.path.join(REPO, "lsd_tpu_torch", "_build", "native") + os.sep)
    assert os.path.exists(path)
    assert sorted(os.listdir(os.path.join(REPO, "native"))) == before
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    paths, errors = [], []

    def build():
        try:
            paths.append(tnative._build())
        except Exception as e:  # collected for the assertion below
            errors.append(e)
    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1 and os.path.exists(paths[0])
    assert sorted(os.listdir(os.path.dirname(paths[0]))) == ["liblsd_native.so"]
    # a source that does not compile
    bad = tmp_path / "native"
    shutil.copytree(os.path.join(REPO, "native"), bad,
                    ignore=shutil.ignore_patterns("*.so"))
    with open(bad / "src" / "lsd_native.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(tnative, "_NATIVE_DIR", str(bad))
    with pytest.raises(RuntimeError, match="failed"):
        tnative._build()
    assert [p for p in os.listdir(os.path.dirname(tnative.library_path()))
            if p.endswith(".so")] == []
