"""Pure-Python rosbag (v2.0) reader/writer + pkl converters (a copy of
``lsd_tpu/tools/rosbag.py`` for the port; numpy only, nothing runs on a device).

Re-derivation of the reference's dataset-conversion tools
(tools/rosbag_to_pkl — C++ with vendored rosbag readers and per-dataset
configs config_kitti/ulhk/utbm.yaml; tools/pkl_to_rosbag) without ROS:
the bag container and the handful of sensor_msgs types are parsed
directly from their wire formats.

Bag container (http://wiki.ros.org/Bags/Format/2.0):
  "#ROSBAG V2.0\\n" then records of
      u32 header_len | header fields (u32 len, b"name=" + value) |
      u32 data_len | data
  ops: 0x03 bag header, 0x05 chunk (may be bz2/lz4 compressed), 0x07
  connection, 0x02 message data, 0x04 index data, 0x06 chunk info.

Supported message types: sensor_msgs/{PointCloud2, Imu, NavSatFix,
CompressedImage}, nav_msgs/Odometry.
"""
from __future__ import annotations

import bz2
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


# ---------------------------------------------------------------------------
# container primitives


def _parse_header(buf: bytes) -> Dict[str, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        k, _, v = field.partition(b"=")
        fields[k.decode()] = v
    return fields


def _emit_header(fields: Dict[str, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        item = k.encode() + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


def _read_record(buf: bytes, off: int) -> Tuple[Dict[str, bytes], bytes, int]:
    (hlen,) = struct.unpack_from("<I", buf, off)
    header = _parse_header(buf[off + 4:off + 4 + hlen])
    off += 4 + hlen
    (dlen,) = struct.unpack_from("<I", buf, off)
    data = buf[off + 4:off + 4 + dlen]
    return header, data, off + 4 + dlen


def _emit_record(fields: Dict[str, bytes], data: bytes) -> bytes:
    h = _emit_header(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _time_to_ns(v: bytes) -> int:
    sec, nsec = struct.unpack("<II", v)
    return sec * 1_000_000_000 + nsec


def _ns_to_time(ns: int) -> bytes:
    return struct.pack("<II", ns // 1_000_000_000, ns % 1_000_000_000)


# ---------------------------------------------------------------------------
# message (de)serializers — ROS1 serialization is little-endian packed


def _read_string(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    return buf[off + 4:off + 4 + n].decode(errors="replace"), off + 4 + n


def _read_ros_header(buf: bytes, off: int) -> Tuple[int, str, int]:
    """std_msgs/Header: u32 seq, time stamp, string frame_id."""
    seq, sec, nsec = struct.unpack_from("<III", buf, off)
    frame_id, off = _read_string(buf, off + 12)
    return sec * 1_000_000_000 + nsec, frame_id, off


_PC2_DTYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
               5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


def parse_pointcloud2(buf: bytes) -> Tuple[int, np.ndarray, Optional[np.ndarray]]:
    """sensor_msgs/PointCloud2 -> (stamp_ns, xyzi (N, 4) f32, time (N,) or
    None per-point relative times if a time/t field exists)."""
    stamp_ns, _frame, off = _read_ros_header(buf, 0)
    height, width = struct.unpack_from("<II", buf, off)
    off += 8
    (n_fields,) = struct.unpack_from("<I", buf, off)
    off += 4
    fields = []
    for _ in range(n_fields):
        name, off = _read_string(buf, off)
        foff, dt, cnt = struct.unpack_from("<IBI", buf, off)
        off += 9
        fields.append((name, foff, dt, cnt))
    is_bigendian = buf[off]
    off += 1
    point_step, row_step = struct.unpack_from("<II", buf, off)
    off += 8
    (dlen,) = struct.unpack_from("<I", buf, off)
    off += 4
    data = np.frombuffer(buf, np.uint8, dlen, off)
    n = height * width
    if point_step == 0 or n == 0:
        return stamp_ns, np.zeros((0, 4), np.float32), None
    n = min(n, len(data) // point_step)
    raw = data[: n * point_step].reshape(n, point_step)

    def col(name_opts, default=None):
        for (name, foff, dt, cnt) in fields:
            if name in name_opts:
                npdt = _PC2_DTYPES.get(dt)
                if npdt is None:
                    break
                w = np.dtype(npdt).itemsize
                return raw[:, foff:foff + w].copy().view(npdt).reshape(n).astype(np.float32)
        return default

    x = col(("x",))
    y = col(("y",))
    z = col(("z",))
    if x is None or y is None or z is None:
        return stamp_ns, np.zeros((0, 4), np.float32), None
    inten = col(("intensity", "i"), np.zeros(n, np.float32))
    if inten.max() > 1.5:   # 0..255 convention -> 0..1
        inten = inten / 255.0
    pts = np.stack([x, y, z, inten], axis=1)
    t = col(("time", "t", "timestamp", "time_stamp"))
    if t is not None and len(t) and t.max() > 1e6:  # ns or us -> s
        t = t / (1e9 if t.max() > 1e8 else 1e6)
    good = np.isfinite(pts).all(axis=1)
    return stamp_ns, pts[good], (t[good] if t is not None else None)


def parse_imu(buf: bytes) -> Dict:
    """sensor_msgs/Imu -> dict with stamp_ns, quat wxyz, gyro rad/s,
    accel m/s^2."""
    stamp_ns, _frame, off = _read_ros_header(buf, 0)
    qx, qy, qz, qw = struct.unpack_from("<4d", buf, off)
    off += 32 + 72          # orientation + covariance
    wx, wy, wz = struct.unpack_from("<3d", buf, off)
    off += 24 + 72
    ax, ay, az = struct.unpack_from("<3d", buf, off)
    return dict(stamp_ns=stamp_ns, quat=(qw, qx, qy, qz),
                gyro=(wx, wy, wz), accel=(ax, ay, az))


def parse_navsatfix(buf: bytes) -> Dict:
    """sensor_msgs/NavSatFix -> dict with stamp_ns, lat/lon/alt, status."""
    stamp_ns, _frame, off = _read_ros_header(buf, 0)
    status, service = struct.unpack_from("<bH", buf, off)
    off += 3
    lat, lon, alt = struct.unpack_from("<3d", buf, off)
    return dict(stamp_ns=stamp_ns, latitude=lat, longitude=lon,
                altitude=alt, status=int(status))


def parse_odometry(buf: bytes) -> Dict:
    """nav_msgs/Odometry -> dict with stamp_ns, pos, quat wxyz."""
    stamp_ns, _frame, off = _read_ros_header(buf, 0)
    _child, off = _read_string(buf, off)
    px, py, pz, qx, qy, qz, qw = struct.unpack_from("<7d", buf, off)
    return dict(stamp_ns=stamp_ns, pos=(px, py, pz), quat=(qw, qx, qy, qz))


def serialize_pointcloud2(stamp_ns: int, pts: np.ndarray,
                          frame_id: str = "lidar",
                          t_rel: Optional[np.ndarray] = None) -> bytes:
    """xyzi (+ optional per-point `time` f32 seconds from scan start —
    the velodyne/ouster convention FAST-LIO undistorts from)."""
    pts = np.ascontiguousarray(pts, np.float32)
    if t_rel is not None:
        pts = np.concatenate(
            [pts[:, :4],
             np.asarray(t_rel, np.float32).reshape(-1, 1)], axis=1)
        pts = np.ascontiguousarray(pts)
    n = len(pts)
    ncol = pts.shape[1]
    fid = frame_id.encode()
    out = struct.pack("<III", 0, stamp_ns // 1_000_000_000,
                      stamp_ns % 1_000_000_000)
    out += struct.pack("<I", len(fid)) + fid
    out += struct.pack("<II", 1, n)                      # height, width
    names = [b"x", b"y", b"z", b"intensity", b"time"][:ncol]
    out += struct.pack("<I", len(names))
    for i, name in enumerate(names):
        out += struct.pack("<I", len(name)) + name
        out += struct.pack("<IBI", i * 4, 7, 1)          # offset, FLOAT32, count
    out += b"\x00"                                       # little endian
    out += struct.pack("<II", 4 * ncol, 4 * ncol * n)    # point/row step
    body = pts.tobytes()
    out += struct.pack("<I", len(body)) + body
    out += b"\x01"                                       # is_dense
    return out


def serialize_imu(stamp_ns: int, gyro, accel, quat=(1.0, 0, 0, 0),
                  frame_id: str = "imu") -> bytes:
    fid = frame_id.encode()
    out = struct.pack("<III", 0, stamp_ns // 1_000_000_000,
                      stamp_ns % 1_000_000_000)
    out += struct.pack("<I", len(fid)) + fid
    qw, qx, qy, qz = quat
    out += struct.pack("<4d", qx, qy, qz, qw)
    out += struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *gyro)
    out += struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *accel)
    out += struct.pack("<9d", *([0.0] * 9))
    return out


def serialize_navsatfix(stamp_ns: int, lat: float, lon: float, alt: float,
                        status: int = 0, frame_id: str = "gps") -> bytes:
    fid = frame_id.encode()
    out = struct.pack("<III", 0, stamp_ns // 1_000_000_000,
                      stamp_ns % 1_000_000_000)
    out += struct.pack("<I", len(fid)) + fid
    out += struct.pack("<bH", status, 1)
    out += struct.pack("<3d", lat, lon, alt)
    out += struct.pack("<9d", *([0.0] * 9))
    out += b"\x00"
    return out


MSG_TYPES = {
    "sensor_msgs/PointCloud2": parse_pointcloud2,
    "sensor_msgs/Imu": parse_imu,
    "sensor_msgs/NavSatFix": parse_navsatfix,
    "nav_msgs/Odometry": parse_odometry,
}


# ---------------------------------------------------------------------------
# bag reader / writer


class BagReader:
    """Sequential rosbag v2.0 reader: iterates (topic, type, t_ns, raw)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.buf = f.read()
        if not self.buf.startswith(MAGIC):
            raise ValueError(f"{path}: not a rosbag v2.0 file")
        self.connections: Dict[int, Tuple[str, str]] = {}  # conn -> (topic, type)

    def _register_connection(self, header: Dict[str, bytes],
                             data: bytes) -> None:
        (conn,) = struct.unpack("<I", header["conn"])
        chdr = _parse_header(data)
        topic = chdr.get("topic", header.get("topic", b"")).decode()
        mtype = chdr.get("type", b"").decode()
        self.connections[conn] = (topic, mtype)

    def _iter_records(self, buf: bytes, off: int, end: int):
        while off < end:
            header, data, off = _read_record(buf, off)
            yield header, data

    def messages(self, topics: Optional[List[str]] = None
                 ) -> Iterator[Tuple[str, str, int, bytes]]:
        off = len(MAGIC)
        buf = self.buf
        while off < len(buf):
            header, data, off = _read_record(buf, off)
            op = header.get("op", b"\x00")[0]
            if op == OP_CONNECTION:
                self._register_connection(header, data)
            elif op == OP_CHUNK:
                comp = header.get("compression", b"none").decode()
                if comp == "bz2":
                    data = bz2.decompress(data)
                elif comp == "lz4":
                    try:
                        import lz4.frame
                        data = lz4.frame.decompress(data)
                    except ImportError as e:
                        raise RuntimeError(
                            "bag uses lz4 chunks; lz4 is not installed") from e
                for h2, d2 in self._iter_records(data, 0, len(data)):
                    op2 = h2.get("op", b"\x00")[0]
                    if op2 == OP_CONNECTION:
                        self._register_connection(h2, d2)
                    elif op2 == OP_MSG:
                        yield self._emit(h2, d2, topics)
            elif op == OP_MSG:
                yield self._emit(header, data, topics)
            # index/chunk-info records are skipped (sequential scan)

    def _emit(self, header, data, topics):
        (conn,) = struct.unpack("<I", header["conn"])
        topic, mtype = self.connections.get(conn, ("?", "?"))
        t_ns = _time_to_ns(header["time"])
        return topic, mtype, t_ns, data

    def read(self, topics: Optional[List[str]] = None
             ) -> Iterator[Tuple[str, str, int, bytes]]:
        for topic, mtype, t_ns, data in self.messages(topics):
            if topics is None or topic in topics:
                yield topic, mtype, t_ns, data


class BagWriter:
    """Minimal rosbag v2.0 writer (uncompressed single-record chunks)."""

    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.f.write(MAGIC)
        # placeholder bag-header record (padded to 4096 like rosbag does)
        hdr = _emit_header({"op": bytes([OP_BAG_HEADER]),
                            "index_pos": struct.pack("<Q", 0),
                            "conn_count": struct.pack("<I", 0),
                            "chunk_count": struct.pack("<I", 0)})
        pad = 4096 - len(hdr)   # rosbag pads the first record to 4 KiB
        self.f.write(struct.pack("<I", len(hdr)))
        self.f.write(hdr)
        self.f.write(struct.pack("<I", pad))
        self.f.write(b" " * pad)
        self.conns: Dict[Tuple[str, str], int] = {}

    def _connection(self, topic: str, mtype: str) -> int:
        key = (topic, mtype)
        if key in self.conns:
            return self.conns[key]
        conn = len(self.conns)
        self.conns[key] = conn
        chdr = _emit_header({"topic": topic.encode(),
                             "type": mtype.encode(),
                             "md5sum": b"*",
                             "message_definition": b""})
        rec = _emit_record({"op": bytes([OP_CONNECTION]),
                            "conn": struct.pack("<I", conn),
                            "topic": topic.encode()}, chdr)
        self._chunk(rec)
        return conn

    def _chunk(self, payload: bytes) -> None:
        self.f.write(_emit_record({"op": bytes([OP_CHUNK]),
                                   "compression": b"none",
                                   "size": struct.pack("<I", len(payload))},
                                  payload))

    def write(self, topic: str, mtype: str, t_ns: int, raw: bytes) -> None:
        conn = self._connection(topic, mtype)
        rec = _emit_record({"op": bytes([OP_MSG]),
                            "conn": struct.pack("<I", conn),
                            "time": _ns_to_time(t_ns)}, raw)
        self._chunk(rec)

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# converters (ref tools/rosbag_to_pkl configs: pointcloud/imu/gps topics,
# acc unit + gravity handling, extrinsics)


def rosbag_to_pkl(bag_path: str, out_dir: str,
                  pointcloud_topic: str = "/velodyne_points",
                  imu_topic: str = "/imu_raw",
                  gps_topic: str = "/gps",
                  lidar_name: str = "0-Custom",
                  acc_in_g: bool = False,
                  extrinsic_lidar: Optional[np.ndarray] = None,
                  max_frames: Optional[int] = None,
                  stamp_at: str = "start") -> str:
    """Convert a rosbag into the pickle replay format (one frame dict per
    lidar scan; IMU rows [t_s_rel, gyro rad/s, acc g] with t_s_rel
    measured from SCAN START — the runtime's convention; latest GPS fix
    as ins_data).

    ``stamp_at`` names the cloud header-stamp convention:
      * ``"start"`` (FAST-LIO / velodyne driver: stamp = sweep begin) —
        each scan takes the IMU window [stamp_k, stamp_{k+1}), so clouds
        are emitted one frame behind arrival (flushed at EOF).
      * ``"end"`` (stamp = sweep end) — each scan takes the window
        (stamp_{k-1}, stamp_k] and the frame's start timestamp becomes
        stamp_k minus the inter-cloud period.
    """
    from ..io.recorder import FrameRecorder

    if stamp_at not in ("start", "end"):
        raise ValueError(f"stamp_at must be start|end, got {stamp_at!r}")
    reader = BagReader(bag_path)
    rec = FrameRecorder(out_dir, cfg_yaml="input:\n  mode: offline\n")
    imu_buf: List[Tuple[int, Tuple, Tuple]] = []
    fix_buf: List[Tuple[int, Dict]] = []
    last_imu: Optional[Dict] = None
    n_frames = 0
    a_scale = 1.0 if acc_in_g else 1.0 / 9.81
    prev_stamp: Optional[int] = None
    pending: Optional[Tuple[int, np.ndarray, Optional[np.ndarray]]] = None

    def emit(stamp_ns, pts, t_rel, start_ns, end_ns):
        """Write one frame whose scan spans [start_ns, end_ns)."""
        nonlocal imu_buf, fix_buf, n_frames
        ts_us = start_ns // 1000
        rows = [[(i_ns - start_ns) / 1e9, *gyro,
                 *(np.asarray(accel) * a_scale)]
                for (i_ns, gyro, accel) in imu_buf
                if start_ns <= i_ns < end_ns]
        imu_buf = [r for r in imu_buf if r[0] >= end_ns]
        ins = {}
        ins_valid = False
        fixes = [f for (f_ns, f) in fix_buf if f_ns <= end_ns]
        fix_buf = [(f_ns, f) for (f_ns, f) in fix_buf if f_ns > end_ns]
        if fixes:
            fix = fixes[-1]
            ins = dict(timestamp=ts_us,
                       latitude=fix["latitude"],
                       longitude=fix["longitude"],
                       altitude=fix["altitude"],
                       Status=max(fix["status"], 0),
                       heading=0.0, pitch=0.0, roll=0.0,
                       Ve=0.0, Vn=0.0, Vu=0.0)
            if last_imu is not None:
                ins.update(gyro_x=np.rad2deg(last_imu["gyro"][0]),
                           gyro_y=np.rad2deg(last_imu["gyro"][1]),
                           gyro_z=np.rad2deg(last_imu["gyro"][2]))
            ins_valid = True
        frame = dict(
            frame_start_timestamp=ts_us,
            frame_timestamp_monotonic=ts_us,
            points={lidar_name: pts.astype(np.float32)},
            points_attr={lidar_name: dict(
                timestamp=ts_us,
                points_attr=(np.stack([t_rel, np.zeros_like(t_rel)], 1)
                             if t_rel is not None else
                             np.zeros((len(pts), 2), np.float32)))},
            image={}, image_param={},
            lidar_valid=True, image_valid=False, radar_valid=False,
            ins_valid=ins_valid, ins_data=ins,
            imu_data=np.asarray(rows, np.float32).reshape(-1, 7),
            motion_valid=False, motion_t=np.eye(4, dtype=np.float32),
            timestep=max((end_ns - start_ns) // 1000, 1),
        )
        rec.write(frame)
        n_frames += 1

    last_period = 100_000_000

    def on_cloud(stamp_ns, pts, t_rel):
        nonlocal pending, prev_stamp, last_period
        if prev_stamp is not None and stamp_ns > prev_stamp:
            last_period = stamp_ns - prev_stamp
        if stamp_at == "end":
            emit(stamp_ns, pts, t_rel, stamp_ns - last_period, stamp_ns)
        else:
            if pending is not None:
                p_stamp, p_pts, p_rel = pending
                emit(p_stamp, p_pts, p_rel, p_stamp, stamp_ns)
            pending = (stamp_ns, pts, t_rel)
        prev_stamp = stamp_ns

    for topic, mtype, t_ns, raw in reader.read(
            [pointcloud_topic, imu_topic, gps_topic]):
        if max_frames is not None and n_frames >= max_frames:
            break
        if topic == imu_topic:
            m = parse_imu(raw)
            last_imu = m
            i_ns = m["stamp_ns"] or t_ns
            if not imu_buf or i_ns > imu_buf[-1][0]:   # drop dup stamps
                imu_buf.append((i_ns, m["gyro"], m["accel"]))
            if len(imu_buf) > 8192:
                imu_buf = imu_buf[-4096:]
        elif topic == gps_topic:
            if mtype == "sensor_msgs/NavSatFix":
                m = parse_navsatfix(raw)
                fix_buf.append((m["stamp_ns"] or t_ns, m))
        elif topic == pointcloud_topic:
            stamp_ns, pts, t_rel = parse_pointcloud2(raw)
            stamp_ns = stamp_ns or t_ns
            if extrinsic_lidar is not None:
                T = np.asarray(extrinsic_lidar, np.float32)
                pts = np.concatenate(
                    [pts[:, :3] @ T[:3, :3].T + T[:3, 3], pts[:, 3:]], axis=1)
            on_cloud(stamp_ns, pts, t_rel)
    if pending is not None and (max_frames is None
                                or n_frames < max_frames):
        p_stamp, p_pts, p_rel = pending
        emit(p_stamp, p_pts, p_rel, p_stamp, p_stamp + last_period)
    return rec.log_dir or out_dir


def pkl_to_rosbag(recording_dir: str, bag_path: str,
                  lidar_name: Optional[str] = None,
                  pointcloud_topic: str = "/velodyne_points",
                  imu_topic: str = "/imu_raw",
                  gps_topic: str = "/gps") -> int:
    """Convert a recording back to a rosbag; returns message count."""
    from ..io.player import FramePlayer

    count = 0
    with BagWriter(bag_path) as w:
        for frame in FramePlayer(recording_dir).iter_dicts():
            ts_us = int(frame.get("frame_start_timestamp", 0))
            t_ns = ts_us * 1000
            pts_map = frame.get("points", {})
            name = lidar_name or (next(iter(pts_map)) if pts_map else None)
            if name is not None and name in pts_map and len(pts_map[name]):
                w.write(pointcloud_topic, "sensor_msgs/PointCloud2", t_ns,
                        serialize_pointcloud2(t_ns, pts_map[name]))
                count += 1
            imu = np.asarray(frame.get("imu_data", np.zeros((0, 7))))
            for row in imu.reshape(-1, 7):
                # recordings carry either absolute us stamps or seconds
                # relative to scan start (runtime convention)
                i_ns = (int(row[0]) * 1000 if row[0] > 1e6
                        else t_ns + int(row[0] * 1e9))
                w.write(imu_topic, "sensor_msgs/Imu", max(i_ns, 0),
                        serialize_imu(max(i_ns, 0), row[1:4],
                                      np.asarray(row[4:7]) * 9.81))
                count += 1
            ins = frame.get("ins_data", {})
            if frame.get("ins_valid") and ins:
                w.write(gps_topic, "sensor_msgs/NavSatFix", t_ns,
                        serialize_navsatfix(t_ns, ins.get("latitude", 0.0),
                                            ins.get("longitude", 0.0),
                                            ins.get("altitude", 0.0),
                                            int(ins.get("Status", 0))))
                count += 1
    return count
