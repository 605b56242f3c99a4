"""internal.proto wire schema: LidarPointcloudMap
(a copy of ``lsd_tpu/proto/internal.py`` for the port).

Field numbers mirror the reference's wire contract (proto/internal.proto)
so its web UI parses our keyframe / raw-pointcloud payloads directly.
Used by the map editor (`slam.get_key_frame`, `slam.get_color_map` — ref
slam/map_manager.py:109-189) and the raw preview endpoint
(`/v1/lidar-pointcloud-map` -> sink.get_proto_http_raw, ref
web_backend/perception_server.py:58,119-122).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .wire import decode_message, encode_message

LIDAR_POINTCLOUD = {1: ("lidar_name", "string", False),
                    2: ("points", "bytes", False),
                    3: ("attr", "bytes", False),
                    4: ("type", "string", False)}
CAMERA_IMAGE_BYTES = {1: ("camera_name", "string", False),
                      2: ("image", "bytes", False)}
LIDAR_POINTCLOUD_MAP = {1: ("lp", LIDAR_POINTCLOUD, True),
                        2: ("image", CAMERA_IMAGE_BYTES, True)}


def serialize_pointcloud_map(clouds: Dict[str, np.ndarray],
                             images: Optional[Dict[str, bytes]] = None,
                             attr_type: str = "") -> bytes:
    """clouds: name -> (N, 3|4) float32; 4th column goes into `attr`."""
    lp = []
    for name, pts in clouds.items():
        pts = np.ascontiguousarray(pts, np.float32)
        entry = {"lidar_name": str(name)}
        if pts.ndim == 2 and pts.shape[1] >= 4:
            entry["points"] = np.ascontiguousarray(pts[:, :3]).tobytes()
            entry["attr"] = np.ascontiguousarray(pts[:, 3]).tobytes()
        else:
            entry["points"] = pts.reshape(-1, 3).tobytes() if pts.size else b""
        if attr_type:
            entry["type"] = attr_type
        lp.append(entry)
    msg = {"lp": lp}
    if images:
        msg["image"] = [{"camera_name": str(n),
                         "image": bytes(img)} for n, img in images.items()]
    return encode_message(LIDAR_POINTCLOUD_MAP, msg)


def serialize_keyframe(index: str, pointcloud: np.ndarray,
                       images: Optional[Dict[str, bytes]] = None,
                       item: str = "p") -> bytes:
    """Reference get_key_frame semantics (map_manager.py:173-188): the
    keyframe cloud is shipped as raw (N, 4) float32 bytes in `points`
    under the vertex index as lidar_name; images ship when 'i' in item."""
    msg: Dict = {"lp": [], "image": []}
    if "p" in item:
        pts = np.ascontiguousarray(pointcloud, np.float32)
        msg["lp"].append({"lidar_name": str(index), "points": pts.tobytes()})
    if "i" in item and images:
        msg["image"] = [{"camera_name": str(n), "image": bytes(img)}
                        for n, img in images.items()]
    return encode_message(LIDAR_POINTCLOUD_MAP, msg)


def parse_pointcloud_map(data: bytes) -> Dict:
    return decode_message(LIDAR_POINTCLOUD_MAP, data)
