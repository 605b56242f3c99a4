"""Port parity for the wire formats: ``proto/wire.py``, ``proto/detection.py``,
``proto/internal.py`` and the bus's ``comms/messages.py:odometry_msg``.

The web UI and the UDP consumers parse these bytes, so the tolerance is
none: the same inputs, made from a seed, give equal bytes in both packages,
and each package parses the other's bytes to equal messages.
"""
import numpy as np
import pytest

from lsd_tpu.comms import messages as jmsg
from lsd_tpu.proto import detection as jdet
from lsd_tpu.proto import internal as jint
from lsd_tpu.proto import wire as jwire
from lsd_tpu_torch.comms import messages as tmsg
from lsd_tpu_torch.proto import detection as tdet
from lsd_tpu_torch.proto import internal as tint
from lsd_tpu_torch.proto import wire as twire


def _objects(rng, n=6):
    return [dict(id=int(rng.integers(0, 600)), label=int(rng.integers(0, 4)),
                 score=float(rng.random()),
                 box=rng.normal(size=7).astype(np.float32),
                 velocity=rng.normal(size=3), age=int(rng.integers(1, 400)),
                 valid=bool(rng.random() > 0.3),
                 trajectory=rng.normal(size=(int(rng.integers(0, 5)), 7)))
            for _ in range(n)]


def _detection_result(seed):
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 2, 64 * 64).astype(np.uint8)
    return dict(
        timestamp=int(rng.integers(0, 2 ** 50)), relative_timestamp=int(rng.integers(0, 1000)),
        fps=float(rng.random() * 20), objects=_objects(rng),
        pose=dict(x=1.5, y=-2.0, z=0.25, heading=0.3, latitude=42.0, longitude=-83.0,
                  status=-4, state="tracking", area=dict(type="a", name="b")),
        points=rng.normal(size=(50, 4)).astype(np.float32),
        images={"cam0": b"\xff\xd8jpeg", "cam1": bytes(rng.integers(0, 256, 20, np.uint8))},
        freespace=dict(x_min=-10.0, x_max=10.0, y_min=-5.0, y_max=5.0, resolution=0.2,
                       x_num=64, y_num=64, cells=cells),
        radar={"ARS408": [dict(id=3, type=1, x=10.0, y=-1.0, z=0.5, length=4.0,
                               width=0.0, yaw_deg=30.0, vx=1.0, vy=-0.5, ax=0.1)]},
        lights=[dict(id=1, pictogram=2, color=3, confidence=0.9, name="tl")])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("extras", [(False, False), (True, True)])
def test_detection_bytes_equal_and_cross_parse(seed, extras):
    result = _detection_result(seed)
    j = jdet.serialize_detection(result, include_points=extras[0], include_images=extras[1])
    t = tdet.serialize_detection(result, include_points=extras[0], include_images=extras[1])
    assert t == j and len(t) > 200
    assert tdet.parse_detection(j) == jdet.parse_detection(t) == jdet.parse_detection(j)


def test_wire_codec_equal_on_every_type():
    schema = {1: ("a", "uint32", False), 2: ("b", "double", False), 3: ("c", "string", False),
              4: ("d", "float", True), 5: ("e", "int32", False), 6: ("f", "bytes", False),
              7: ("g", "bool", False), 8: ("h", "int64", False),
              9: ("m", {1: ("x", "uint64", False)}, True)}
    msg = dict(a=300, b=-1.5, c="hï", d=[1.0, 2.5, -3.0], e=-7, f=b"\x00\x01", g=True,
               h=2 ** 40, m=[dict(x=1), dict(x=2 ** 63)])
    data = twire.encode_message(schema, msg)
    assert data == jwire.encode_message(schema, msg)
    assert twire.decode_message(schema, data) == jwire.decode_message(schema, data)


@pytest.mark.parametrize("attr_type", ["", "intensity"])
def test_pointcloud_map_bytes(attr_type):
    rng = np.random.default_rng(4)
    clouds = {"0-Ouster-OS1": rng.normal(size=(100, 4)).astype(np.float32),
              "1-Custom": rng.normal(size=(30, 3)).astype(np.float32),
              "empty": np.zeros((0, 3), np.float32)}
    images = {"cam0": b"img"}
    j = jint.serialize_pointcloud_map(clouds, images, attr_type=attr_type)
    t = tint.serialize_pointcloud_map(clouds, images, attr_type=attr_type)
    assert t == j
    assert tint.parse_pointcloud_map(j) == jint.parse_pointcloud_map(t)


@pytest.mark.parametrize("item", ["p", "pi", "i"])
def test_keyframe_bytes(item):
    cloud = np.random.default_rng(5).normal(size=(64, 4)).astype(np.float32)
    images = {"cam0": b"\xff\xd8", "cam1": b"abc"}
    j = jint.serialize_keyframe("7", cloud, images, item)
    t = tint.serialize_keyframe("7", cloud, images, item)
    assert t == j
    assert tint.parse_pointcloud_map(j) == jint.parse_pointcloud_map(t)


@pytest.mark.parametrize("seed", [0, 1])
def test_odometry_msg_bytes(seed):
    rng = np.random.default_rng(seed)
    from lsd_tpu_torch.geometry import np_so3
    T = np.eye(4)
    T[:3, :3] = np_so3.exp_so3(rng.normal(size=3))
    T[:3, 3] = rng.normal(size=3) * 10
    vel = rng.normal(size=3)
    stamp = int(rng.integers(0, 2 ** 50))
    for v in (None, vel):
        j, t = jmsg.odometry_msg(stamp, T, vel=v), tmsg.odometry_msg(stamp, T, vel=v)
        assert t == j
        assert tmsg.decode_typed(j) == jmsg.decode_typed(t)
    assert tmsg.decode_typed(t)[0] == "Odometry"
