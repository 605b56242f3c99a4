"""A numpy copy of ``lsd_tpu/io/frame.py`` for the port.

Typed frame schema — the PyTree that flows through the whole framework.

The reference passes loose dicts between modules (``data_dict`` built in
module/source/source_manager.py:66-91, recorded/replayed as pickles by
module/sink/frame_sink.py and module/source/player_data_manager.py).  We keep
the *on-disk* dict format bit-compatible (so recordings interchange with the
reference) but convert to typed, statically-shaped PyTrees at the device
boundary: XLA requires static shapes, so point clouds and IMU batches are
padded to fixed capacities with validity masks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

# Default capacities. Bucketing avoids recompiles: pad_points rounds up to one
# of these sizes so at most len(BUCKETS) variants of each jitted fn compile.
POINT_BUCKETS = (2 ** 14, 2 ** 15, 2 ** 16, 2 ** 17, 2 ** 18)
IMU_CAPACITY = 64


@dataclasses.dataclass
class LidarScan:
    """One (merged) LiDAR sweep.

    points:  (N, 4) float32  x, y, z, intensity  (padded)
    stamps:  (N,)  float32  per-point time offset in seconds from scan start
             (reference keeps this in points_attr[:, 0]; used for motion
             undistortion)
    mask:    (N,)  bool     valid-point mask
    timestamp: int  scan start time, microseconds (host scalar)
    """
    points: np.ndarray
    stamps: np.ndarray
    mask: np.ndarray
    timestamp: int

    @property
    def num_valid(self) -> int:
        return int(self.mask.sum())


@dataclasses.dataclass
class ImuBatch:
    """IMU samples covering one frame interval.

    data: (M, 7) float64 [timestamp_us, gx, gy, gz, ax, ay, az]
          (gyro rad/s, accel in g like the reference's parseGPCHC output)
    mask: (M,) bool
    """
    data: np.ndarray
    mask: np.ndarray


@dataclasses.dataclass
class InsFix:
    """GNSS/INS solution for the frame (the reference's parseGPCHC output)."""
    timestamp: int = 0
    latitude: float = 0.0
    longitude: float = 0.0
    altitude: float = 0.0
    heading: float = 0.0   # degrees
    pitch: float = 0.0
    roll: float = 0.0
    ve: float = 0.0        # m/s east
    vn: float = 0.0        # m/s north
    vu: float = 0.0        # m/s up
    status: int = 0        # solution status (reference priority state machine)
    sensor: str = "GNSS"
    valid: bool = False


@dataclasses.dataclass
class Frame:
    """One pipeline frame: everything a module stage needs."""
    timestamp_monotonic: int                 # us
    timestep: int                            # us since previous frame
    scan: Optional[LidarScan] = None
    imu: Optional[ImuBatch] = None
    ins: Optional[InsFix] = None
    motion: Optional[np.ndarray] = None      # 4x4 relative motion over frame (ins-predicted)
    motion_valid: bool = False
    images: Dict[str, Any] = dataclasses.field(default_factory=dict)
    image_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _bucket_size(n: int, buckets=POINT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def pad_points(points: np.ndarray, attr: Optional[np.ndarray] = None,
               capacity: Optional[int] = None, buckets=POINT_BUCKETS):
    """Pad an (N, 4) cloud to a static capacity. Returns (points, stamps, mask).

    Overflow is truncated (reference behaviour: fixed max-points buffers in
    inference voxelization).
    """
    points = np.asarray(points, dtype=np.float32).reshape(-1, points.shape[-1])
    n = points.shape[0]
    cap = capacity if capacity is not None else _bucket_size(n, buckets)
    if n > cap:
        points = points[:cap]
        if attr is not None:
            attr = attr[:cap]
        n = cap
    out = np.zeros((cap, 4), dtype=np.float32)
    out[:n, :min(4, points.shape[1])] = points[:, :4]
    stamps = np.zeros((cap,), dtype=np.float32)
    if attr is not None and attr.size:
        stamps[:n] = np.asarray(attr, dtype=np.float32).reshape(len(attr), -1)[:n, 0]
    mask = np.zeros((cap,), dtype=bool)
    mask[:n] = True
    return out, stamps, mask


def pad_imu(imu_data: np.ndarray, capacity: int = IMU_CAPACITY) -> ImuBatch:
    imu_data = np.asarray(imu_data, dtype=np.float64).reshape(-1, 7)
    m = min(imu_data.shape[0], capacity)
    out = np.zeros((capacity, 7), dtype=np.float64)
    out[:m] = imu_data[:m]
    mask = np.zeros((capacity,), dtype=bool)
    mask[:m] = True
    return ImuBatch(data=out, mask=mask)


def frame_from_dict(d: Dict[str, Any], point_capacity: Optional[int] = None) -> Frame:
    """Convert a reference-format frame dict (see player.normalize_frame_dict)
    into a typed Frame.  Multiple lidars are concatenated (the reference does
    the same before inference/SLAM: sensor_inference/object_infer.py,
    slam/src/slam.cpp feedPointData on the merged cloud)."""
    scan = None
    if d.get("lidar_valid") and d.get("points"):
        clouds, attrs = [], []
        for name in sorted(d["points"].keys()):
            pts = d["points"][name]
            clouds.append(np.asarray(pts, dtype=np.float32).reshape(-1, pts.shape[-1]))
            pa = d.get("points_attr", {}).get(name, {})
            a = pa.get("points_attr")
            attrs.append(np.asarray(a, dtype=np.float32).reshape(len(clouds[-1]), -1)
                         if a is not None and np.size(a) else np.zeros((len(clouds[-1]), 2), np.float32))
        cloud = np.concatenate(clouds, axis=0) if clouds else np.zeros((0, 4), np.float32)
        attr = np.concatenate(attrs, axis=0) if attrs else None
        pts, stamps, mask = pad_points(cloud, attr, capacity=point_capacity)
        scan = LidarScan(points=pts, stamps=stamps, mask=mask,
                         timestamp=int(d.get("frame_start_timestamp", d["frame_timestamp_monotonic"])))

    imu = pad_imu(d["imu_data"]) if d.get("imu_data") is not None and np.size(d.get("imu_data")) else None

    ins = None
    if "ins_data" in d and d["ins_data"]:
        i = d["ins_data"]
        ins = InsFix(
            timestamp=int(i.get("timestamp", 0)),
            latitude=float(i.get("latitude", 0.0)), longitude=float(i.get("longitude", 0.0)),
            altitude=float(i.get("altitude", 0.0)),
            heading=float(i.get("heading", 0.0)), pitch=float(i.get("pitch", 0.0)),
            roll=float(i.get("roll", 0.0)),
            ve=float(i.get("Ve", 0.0)), vn=float(i.get("Vn", 0.0)), vu=float(i.get("Vu", 0.0)),
            status=int(i.get("Status", 0)), sensor=str(i.get("Sensor", "GNSS")),
            valid=bool(d.get("ins_valid", False)),
        )

    return Frame(
        timestamp_monotonic=int(d["frame_timestamp_monotonic"]),
        timestep=int(d.get("timestep", 100000)),
        scan=scan, imu=imu, ins=ins,
        motion=np.asarray(d["motion_t"], np.float32) if d.get("motion_t") is not None else None,
        motion_valid=bool(d.get("motion_valid", False)),
        images=d.get("image", {}), image_params=d.get("image_param", {}),
    )
