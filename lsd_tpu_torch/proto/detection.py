"""Detection message schema + serialization
(a copy of ``lsd_tpu/proto/detection.py`` for the port).

Field numbers mirror the reference's wire contract
(proto/detection.proto:3-140) so the reference's receivers
(tools/recv_sample/recv_detection_udp.cpp, web UI protobuf parsing) decode
our output directly.  Serialization logic re-derives
proto/proto_serialize.py semantics (objects, pose, freespace, images,
points as float32 bytes).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .wire import decode_message, encode_message

POINT3D = {1: ("x", "double", False), 2: ("y", "double", False), 3: ("z", "double", False)}
BOX3D = {1: ("center", POINT3D, False), 2: ("length", "float", False),
         3: ("width", "float", False), 4: ("height", "float", False),
         5: ("heading", "float", False)}
TRAJECTORY = {1: ("x", "double", False), 2: ("y", "double", False), 3: ("z", "double", False),
              4: ("heading", "float", False), 5: ("velocity_x", "float", False),
              6: ("velocity_y", "float", False), 7: ("relative_timestamp", "uint64", False)}
HEADER = {1: ("version", "bytes", False), 2: ("timestamp", "uint64", False),
          3: ("relative_timestamp", "uint64", False), 4: ("fps", "float", False)}
AREA = {1: ("type", "string", False), 2: ("name", "string", False)}
POSE = {1: ("x", "float", False), 2: ("y", "float", False), 3: ("z", "float", False),
        4: ("heading", "float", False), 5: ("pitch", "float", False),
        6: ("roll", "float", False), 7: ("latitude", "double", False),
        8: ("longitude", "double", False), 9: ("altitude", "double", False),
        10: ("status", "int32", False), 11: ("state", "string", False),
        12: ("area", AREA, False)}
OBJECT = {1: ("id", "uint32", False), 2: ("type", "enum", False),
          3: ("confidence", "float", False), 4: ("box", BOX3D, False),
          5: ("velocity_x", "float", False), 6: ("velocity_y", "float", False),
          7: ("angle_rate", "float", False), 8: ("accel_x", "float", False),
          9: ("valid", "bool", False), 10: ("status", "enum", False),
          11: ("age", "uint32", False), 12: ("trajectory", TRAJECTORY, True)}
TRAFFICLIGHT = {1: ("id", "uint32", False), 2: ("pictogram", "enum", False),
                3: ("color", "enum", False), 4: ("confidence", "float", False),
                5: ("name", "string", False)}
FREESPACE_INFO = {1: ("x_min", "float", False), 2: ("x_max", "float", False),
                  3: ("y_min", "float", False), 4: ("y_max", "float", False),
                  5: ("z_min", "float", False), 6: ("z_max", "float", False),
                  7: ("resolution", "float", False), 8: ("x_num", "int64", False),
                  9: ("y_num", "int64", False)}
FREESPACE = {1: ("info", FREESPACE_INFO, False), 2: ("cells", "bytes", False)}
CAMERA_IMAGE = {1: ("camera_name", "string", False), 2: ("image", "bytes", False)}
RADAR = {1: ("radar_name", "string", False), 2: ("radar_object", OBJECT, True)}
DETECTION = {1: ("header", HEADER, False), 2: ("object", OBJECT, True),
             3: ("freespace", "bytes", False), 4: ("points", "bytes", False),
             5: ("image", CAMERA_IMAGE, True), 6: ("radar", RADAR, True),
             7: ("pose", POSE, False), 8: ("light", TRAFFICLIGHT, True)}

# class label -> Object.Type enum (reference: VEHICLE=1, PEDESTRIAN=2, CYCLIST=3)
LABEL_TO_TYPE = {0: 1, 1: 2, 2: 3}


def _object_msg(o: Dict, scan_start_us: int = 0) -> Dict:
    b = np.asarray(o["box"], float)
    traj = []
    tarr = o.get("trajectory")
    if tarr is not None:
        for k, row in enumerate(np.asarray(tarr, float)):
            traj.append(dict(x=row[0], y=row[1], z=row[2], heading=row[6],
                             velocity_x=float(o.get("velocity", [0, 0, 0])[0]),
                             velocity_y=float(o.get("velocity", [0, 0, 0])[1]),
                             relative_timestamp=int((k + 1) * 500000)))
    speed = float(np.linalg.norm(np.asarray(o.get("velocity", [0, 0, 0]))[:2]))
    return dict(
        id=int(o["id"]) & 0xFF,
        type=LABEL_TO_TYPE.get(int(o.get("label", 0)), 0),
        confidence=float(o.get("score", 0.0)),
        box=dict(center=dict(x=b[0], y=b[1], z=b[2]),
                 length=b[3], width=b[4], height=b[5], heading=b[6]),
        velocity_x=float(o.get("velocity", [0, 0, 0])[0]),
        velocity_y=float(o.get("velocity", [0, 0, 0])[1]),
        angle_rate=0.0, accel_x=0.0,
        valid=bool(o.get("valid", True)),
        status=3 if speed > 0.5 else 1,
        age=min(int(o.get("age", 1)), 255),
        trajectory=traj,
    )


def serialize_detection(result: Dict, include_points: bool = False,
                        include_images: bool = False) -> bytes:
    """result dict (tracker output + frame context) -> Detection bytes."""
    msg: Dict = dict(header=dict(version=b"V1.0",
                                 timestamp=int(result.get("timestamp", 0)),
                                 relative_timestamp=int(result.get("relative_timestamp", 0)),
                                 fps=float(result.get("fps", 10.0))))
    msg["object"] = [_object_msg(o) for o in result.get("objects", [])]
    if "pose" in result and result["pose"] is not None:
        msg["pose"] = result["pose"]
    if include_points and result.get("points") is not None:
        msg["points"] = np.asarray(result["points"], np.float32).tobytes()
    if include_images:
        msg["image"] = [dict(camera_name=k, image=v)
                        for k, v in result.get("images", {}).items()]
    if result.get("freespace") is not None:
        fs = result["freespace"]
        fs_bytes = encode_message(FREESPACE, dict(
            info=dict(x_min=fs["x_min"], x_max=fs["x_max"], y_min=fs["y_min"],
                      y_max=fs["y_max"], z_min=fs.get("z_min", -0.5),
                      z_max=fs.get("z_max", 2.0), resolution=fs["resolution"],
                      x_num=fs["x_num"], y_num=fs["y_num"]),
            cells=bytes(fs["cells"])))
        msg["freespace"] = fs_bytes
    if result.get("radar"):
        # radar: {radar_name: [RadarObject-style dicts]} (ref
        # proto_serialize radar path; aux_sources RadarSource frames)
        msg["radar"] = [dict(
            radar_name=str(name),
            radar_object=[dict(
                id=int(o.get("id", 0)), type=int(o.get("type", 0)),
                confidence=1.0, valid=True,
                box=dict(center=dict(x=float(o.get("x", 0.0)),
                                     y=float(o.get("y", 0.0)),
                                     z=float(o.get("z", 0.0))),
                         length=float(o.get("length", 0.0)) or 1.0,
                         width=float(o.get("width", 0.0)) or 1.0,
                         height=1.0,
                         heading=float(o.get("yaw_deg", 0.0)) * np.pi / 180.0),
                velocity_x=float(o.get("vx", 0.0)),
                velocity_y=float(o.get("vy", 0.0)),
                accel_x=float(o.get("ax", 0.0)))
                for o in objs])
            for name, objs in result["radar"].items()]
    if result.get("lights"):
        msg["light"] = [dict(id=int(l.get("id", 0)), pictogram=int(l.get("pictogram", 0)),
                             color=int(l.get("color", 0)), confidence=float(l.get("confidence", 0.0)),
                             name=str(l.get("name", ""))) for l in result["lights"]]
    return encode_message(DETECTION, msg)


def parse_detection(data: bytes) -> Dict:
    return decode_message(DETECTION, data)
