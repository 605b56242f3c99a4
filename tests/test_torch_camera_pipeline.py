"""Port parity: the camera models served through the pipeline
(``lsd_tpu_torch/detection/mono3d_infer.py``, ``runtime/modules.py:DetectModule``,
``runtime/trafficlight_module.py``, ``utils/image.py``, the runtime core)
against ``lsd_tpu`` on the same inputs.

- ``resize_linear`` against ``cv2.resize(..., INTER_LINEAR)`` on uint8:
  equal on downscales (1920 x 1080 to both model sizes among them); on an
  upscale at most one level off, at under 0.5 % of values (measured 0.2 %).
- ``Mono3DInfer`` on a tiny flax checkpoint, fed the same JPEG bytes (made
  with ``cv2.imencode``), the same uint8 array and the same float image:
  the same objects (labels equal; rects within 1e-3 px + 1e-4 of their
  value, scores within 1e-5, boxes within 1e-4 m) and heat maps within
  1e-5.
- ``DetectModule`` camera-only and LiDAR-plus-camera over three frames,
  with one lidar predict function given to both: the same tracked objects
  (ids, labels, boxes within 1e-4).
- ``TrafficlightModule`` with the shipped 4-class checkpoint in both
  packages (the reference's served by hand with ``Yolo2DConfig(num_classes
  =4)``, since its ``build_yolo_predict_fn`` builds 8 classes): the same
  confident boxes (kept, score > 0.3; bf16: centres within 1 px of the
  1920 x 1080 frame, scores within 0.02) and the same ``lights``.
- The class-count fault: both packages refuse the shipped checkpoint with
  ``Yolo2DConfig()``, the reference at the first call, the port when the
  function is built; an enabled ``TrafficlightModule`` (and a
  ``Mono3DInfer`` given a checkpoint of another width) raises in the port.
- Without OpenCV, compressed bytes raise; they never give an empty result.
"""
import copy
import sys
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsd_tpu.detection as jdet
from lsd_tpu.detection import mono3d_infer as jinf
from lsd_tpu.models import mono3d as jm
from lsd_tpu.models import yolo2d as jy
from lsd_tpu.models.params_io import save_params as jsave
from lsd_tpu.runtime import clear_interfaces as jclear
from lsd_tpu.runtime import config as jconfig
from lsd_tpu.runtime import modules as jmod
from lsd_tpu.runtime import trafficlight_module as jtl
from lsd_tpu_torch.detection import mono3d_infer as tinf
from lsd_tpu_torch.detection.tracker import Tracker3D, TrackerConfig
from lsd_tpu_torch.models.yolo2d import Yolo2DConfig
from lsd_tpu_torch.runtime import config as tconfig
from lsd_tpu_torch.runtime import modules as tmod
from lsd_tpu_torch.runtime import trafficlight_module as ttl
from lsd_tpu_torch.runtime.interface import clear_interfaces as tclear
from lsd_tpu_torch.runtime.pipeline import DataBank, Module, ModuleManager
from lsd_tpu_torch.training.camera_data import SyntheticTrafficLightDataset, TrafficLightSceneConfig
from lsd_tpu_torch.utils.image import load_image, resize_linear

TL_WEIGHTS = "weights/yolo2d_trafficlight.msgpack"


@pytest.fixture(autouse=True)
def _clean():
    jclear()
    tclear()
    yield
    jclear()
    tclear()


@pytest.mark.parametrize("src,dst", [((1080, 1920), (384, 640)), ((1080, 1920), (256, 320)),
                                     ((480, 640), (256, 320)), ((192, 320), (96, 160)),
                                     ((1000, 1500), (257, 333)), ((96, 160), (384, 640))])
def test_resize_matches_cv2(src, dst):
    img = np.random.default_rng(sum(src)).integers(0, 256, (*src, 3), dtype=np.uint8)
    want = cv2.resize(img, dst[::-1]).astype(int)
    got = resize_linear(torch.as_tensor(img), dst).numpy().astype(int)
    diff = np.abs(got - want)
    if dst[0] <= src[0]:
        assert diff.max() == 0
    else:
        assert diff.max() <= 1 and (diff > 0).mean() < 5e-3


def test_cam_geometry_matches_jax():
    rng = np.random.default_rng(0)
    K = np.asarray([[500.0, 0, 320.0], [0, 500.0, 192.0], [0, 0, 1]])
    C2V = np.linalg.inv(_cam_extrinsic())
    for _ in range(50):
        box = np.r_[rng.uniform(-10, 10, 2), rng.uniform(-5, 40), rng.uniform(0.3, 5, 3),
                    rng.uniform(-np.pi, np.pi)]
        a, b = tinf.cam_rect(box, K, (384, 640)), jinf.cam_rect(box, K, (384, 640))
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tinf.cam_box_to_lidar(box, C2V),
                                      jinf.cam_box_to_lidar(box, C2V))
    bl = tinf.cam_box_to_lidar(np.asarray([1.0, 0.5, 10.0, 4.0, 1.8, 1.5, 0.0]), C2V)
    np.testing.assert_allclose(bl[:3], [10.0, -1.0, -0.5], atol=1e-6)


def _cam_extrinsic():
    """Camera looking along lidar +x (T_cam_from_lidar)."""
    V2C = np.eye(4)
    V2C[:3, :3] = np.asarray([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float)
    return V2C


@pytest.fixture(scope="module")
def tiny_weights(tmp_path_factory):
    mcfg = jm.Mono3DConfig(image_hw=(96, 160), base_ch=8)
    params = jm.Mono3D(mcfg).init(jax.random.PRNGKey(3), jnp.zeros((96, 160, 3), jnp.float32))
    path = str(tmp_path_factory.mktemp("m3") / "mono3d_tiny.msgpack")
    jsave(path, params)
    return path, mcfg


def _both_infer(tiny_weights, thresh=0.0):
    path, mcfg = tiny_weights
    return (jinf.Mono3DInfer(weights=path, score_thresh=thresh, mcfg=mcfg),
            tinf.Mono3DInfer(weights=path, score_thresh=thresh, device="cpu",
                             mcfg=tinf.Mono3DConfig(**mcfg._asdict())))


def _assert_same_objects(got, ref, box_atol=1e-4):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a["label"] == b["label"]
        assert a["score"] == pytest.approx(b["score"], abs=1e-5)
        np.testing.assert_allclose(a["box"], b["box"], atol=box_atol, rtol=0)
        for k in ("rect", "box_lidar"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4 if k == "rect" else 0,
                                           atol=1e-3 if k == "rect" else box_atol)


def test_mono3d_infer_matches_jax(tiny_weights):
    ref_inf, port_inf = _both_infer(tiny_weights)
    K = np.asarray([[280.0, 0, 160.0], [0, 280.0, 96.0], [0, 0, 1]])
    rng = np.random.default_rng(1)
    img = (rng.random((192, 320, 3)) * 255).astype(np.uint8)
    jpeg = cv2.imencode(".jpg", img)[1].tobytes()
    small = rng.random((96, 160, 3)).astype(np.float32)
    C2V = np.linalg.inv(_cam_extrinsic())
    for image, k in ((jpeg, K), (img, K), (small, K / 2)):
        ref = ref_inf.detect(image, k, C2V=C2V)
        got = port_inf.detect(image, k, C2V=C2V)
        np.testing.assert_allclose(got["K_scaled"], ref["K_scaled"])
        np.testing.assert_allclose(got["heat"], ref["heat"], atol=1e-5, rtol=0)
        _assert_same_objects(got["camera_objs"], ref["camera_objs"])
    assert port_inf.detect(b"not a jpeg", K) == dict(camera_objs=[], heat=None, K_scaled=None)
    _, Ks = port_inf._prep(img, K)
    np.testing.assert_allclose(Ks[0, 0], 140.0)
    np.testing.assert_allclose(Ks[1, 2], 48.0)


def test_mono3d_infer_refuses_without_weights(monkeypatch):
    monkeypatch.setattr(tinf, "shipped_mono3d_weights", lambda: None)
    with pytest.raises(ValueError, match="no weights"):
        tinf.Mono3DInfer(weights=None, device="cpu")


def _det_cfg(pkg, path, lidar):
    cfg = pkg.AttrDict(copy.deepcopy(pkg.DEFAULT_CONFIG))
    cfg["detection"]["enable"] = False
    cfg["detection"]["mono3d"] = dict(enable=True, weights=path, camera="cam0",
                                      score_threshold=0.0)
    cfg["camera"] = [dict(name="cam0", intrinsic_parameters=[140.0, 140.0, 80.0, 48.0, 0, 0, 0,
                                                             0, 0],
                          extrinsic_parameters=[0, 0, 0, 0, 0, 0])]
    return cfg


def _frames(with_lidar):
    rng = np.random.default_rng(1)
    img = (rng.random((96, 160, 3)) * 255).astype(np.uint8)
    jpeg = cv2.imencode(".jpg", img)[1].tobytes()
    out = []
    for k in range(3):
        t = 1_000_000 + k * 100000
        d = dict(frame_start_timestamp=t, frame_timestamp_monotonic=t, points={}, points_attr={},
                 image={"cam0": jpeg}, lidar_valid=False, image_valid=True, timestep=100000)
        if with_lidar:
            pts = np.c_[rng.uniform(-20, 20, (500, 3)), rng.uniform(0, 1, 500)].astype(np.float32)
            d.update(points={"top": pts}, lidar_valid=True)
        out.append(d)
    return out


def _lidar_predict(torch_out):
    """Fixed lidar detections in front of the camera (and one behind)."""
    boxes = np.asarray([[12.0, 0.5, -0.3, 4.0, 1.8, 1.5, 0.1], [25.0, -3.0, 0.0, 0.8, 0.8, 1.7, 0],
                        [-15.0, 2.0, 0.0, 4.0, 1.8, 1.5, 0.0], [0, 0, 0, 1, 1, 1, 0]], np.float32)
    scores = np.asarray([0.8, 0.6, 0.7, 0.1], np.float32)
    labels = np.asarray([0, 1, 0, 2], np.int32)
    mask = np.asarray([True, True, True, False])

    def predict(points, mask_in):
        out = (boxes, scores, labels, mask)
        return tuple(torch.as_tensor(a) for a in out) if torch_out else out
    return predict


@pytest.mark.parametrize("with_lidar", [False, True])
def test_detect_module_fusion_matches_jax(tiny_weights, with_lidar):
    path, mcfg = tiny_weights
    outs = []
    for pkg, modmod, kw in ((jconfig, jmod, {}), (tconfig, tmod, dict(device="cpu"))):
        port = modmod is tmod
        # the port's setup refuses a checkpoint that does not fit the
        # module's Mono3DConfig(), so it loads the shipped one; both
        # modules then get the tiny model
        cfg = _det_cfg(pkg, None if port else path, with_lidar)
        mod = modmod.DetectModule(cfg, **kw)
        mod.setup(cfg)
        mod.mono3d = (tinf.Mono3DInfer(weights=path, score_thresh=0.0, device="cpu",
                                       mcfg=tinf.Mono3DConfig(**mcfg._asdict())) if port
                      else jinf.Mono3DInfer(weights=path, score_thresh=0.0, mcfg=mcfg))
        trk_cfg = dict(score_high=0.01, min_hits=1)
        mod.tracker = (Tracker3D(TrackerConfig(**trk_cfg), device="cpu") if port else
                       jdet.Tracker3D(jdet.TrackerConfig(**trk_cfg)))
        if with_lidar:
            mod.set_model(_lidar_predict(torch_out=port))
        outs.append([mod.process(d)["objects"] for d in _frames(with_lidar)])
    ref, got = outs
    assert len(ref[-1]) > 0
    for r, g in zip(ref, got):
        assert [o["id"] for o in g] == [o["id"] for o in r]
        assert [o["label"] for o in g] == [o["label"] for o in r]
        for a, b in zip(g, r):
            np.testing.assert_allclose(a["box"], b["box"], atol=1e-4, rtol=0)


def _jax_yolo4_predict():
    """The reference's build_yolo_predict_fn with Yolo2DConfig(num_classes=4)."""
    from lsd_tpu.models.params_io import load_params
    cfg = jy.Yolo2DConfig(num_classes=4)
    model = jy.Yolo2D(cfg)
    params = load_params(TL_WEIGHTS, model.init(jax.random.PRNGKey(0), jnp.zeros((256, 320, 3))))

    @jax.jit
    def run(img):
        boxes, scores, labels, mask = jy.decode_yolo2d(model.apply(params, img), 16, 64)
        return boxes, scores, labels, jy.nms_2d(boxes, scores, mask)

    def predict(image_bgr):
        ih, iw = image_bgr.shape[:2]
        img = cv2.resize(image_bgr, (320, 256)).astype(np.float32) / 255.0
        boxes, scores, labels, keep = run(jnp.asarray(img))
        b = np.asarray(boxes) * np.asarray([iw / 320, ih / 256, iw / 320, ih / 256])
        return b, np.asarray(scores), np.asarray(labels), np.asarray(keep)
    return predict


def _tl_frame():
    """A 1920 x 1080 BGR frame: a traffic-light scene drawn at 256 x 320 and
    scaled up."""
    img, boxes, labels = SyntheticTrafficLightDataset(TrafficLightSceneConfig(), seed=2).scene()
    img = cv2.resize((img * 255).astype(np.uint8), (1920, 1080), interpolation=cv2.INTER_NEAREST)
    return img, boxes * 6.0


def test_trafficlight_module_matches_jax():
    img, _ = _tl_frame()
    ref_fn = _jax_yolo4_predict()
    port_fn = ttl.build_yolo_predict_fn(TL_WEIGHTS, cfg=Yolo2DConfig(num_classes=4), device="cpu")
    ref, got = ref_fn(img), port_fn(img)

    def confident(out):
        boxes, scores, labels, keep = out
        k = np.flatnonzero(keep & (scores > 0.3))
        k = k[np.argsort(-scores[k], kind="stable")]
        return boxes[k], scores[k], labels[k]
    (gb, gs, gl), (rb, rs, rl) = confident(got), confident(ref)
    assert len(gl) == len(rl) >= 1
    np.testing.assert_array_equal(gl, rl)
    centre = lambda b: (b[:, :2] + b[:, 2:]) / 2
    np.testing.assert_allclose(centre(gb), centre(rb), atol=1.0)
    np.testing.assert_allclose(gs, rs, atol=0.02)

    # a map light projected onto the first kept detection's centre
    u, v = centre(gb)[0]
    lights = []
    for pkg, tlmod, fn in ((jconfig, jtl, ref_fn), (tconfig, ttl, port_fn)):
        cfg = pkg.ConfigManager().config
        cfg.trafficlight = dict(enable=False, camera="front",
                                intrinsic=[[1000.0, 0, u], [0, 1000.0, v + 1000.0 * 5 / 30],
                                           [0, 0, 1]],
                                image_size=[1920, 1080],
                                lights=[dict(name="tl_a", position=[30.0, 0.0, 5.0])])
        mod = tlmod.TrafficlightModule(cfg)
        mod.setup(cfg)
        mod.predict_fn = fn
        d = dict(image={"front": cv2.imencode(".jpg", img)[1].tobytes()}, image_param={},
                 slam_pose=np.eye(4).tolist())
        lights.append(mod.process(d)["lights"])
    assert len(lights[0]) == 1 and lights[0][0]["name"] == "tl_a"
    assert [(l["name"], l["color"], l["pictogram"]) for l in lights[1]] == \
        [(l["name"], l["color"], l["pictogram"]) for l in lights[0]]
    assert lights[1][0]["confidence"] == pytest.approx(lights[0][0]["confidence"], abs=0.02)


def test_both_packages_refuse_the_8_class_config_with_the_shipped_checkpoint():
    img = np.zeros((480, 640, 3), np.uint8)
    fn = jtl.build_yolo_predict_fn(TL_WEIGHTS)
    with pytest.raises(Exception, match=r"1, 1, 128, 8"):
        fn(img)
    with pytest.raises(ValueError, match=r"Conv_1\.\w+ is \(4.*\) in the checkpoint and \(8"):
        ttl.build_yolo_predict_fn(TL_WEIGHTS, device="cpu")
    fn = ttl.build_yolo_predict_fn(device="cpu")          # random init, 8 classes
    boxes, scores, labels, keep = fn(img)
    assert boxes.shape == (64, 4) and np.isfinite(boxes).all() and labels.max() < 8


def test_enabled_modules_refuse_a_checkpoint_that_does_not_fit_their_config(tiny_weights):
    cfg = tconfig.ConfigManager().config
    cfg.trafficlight = dict(enable=True, weights=TL_WEIGHTS, camera="front",
                            lights=[dict(name="tl_a", position=[30.0, 0.0, 5.0])])
    mod = ttl.TrafficlightModule(cfg, device="cpu")
    with pytest.raises(ValueError, match=r"Conv_1\.\w+ is \(4.*\) in the checkpoint and \(8"):
        mod.setup(cfg)
    assert mod.predict_fn is None
    # the tiny Mono3D (base_ch 8) against the default Mono3DConfig (base_ch 32)
    with pytest.raises(ValueError, match=r"ConvBlock_0\.Conv_0\.\w+ is \(8.*\) in the checkpoint "
                                         r"and \(32"):
        tinf.Mono3DInfer(weights=tiny_weights[0], device="cpu")


def test_without_opencv_bytes_raise_and_arrays_still_reach_the_model(monkeypatch):
    img, _ = _tl_frame()
    jpeg = cv2.imencode(".jpg", img)[1].tobytes()
    calls = []
    cfg = tconfig.ConfigManager().config
    cfg.trafficlight = dict(enable=False, camera="front", image_size=[1920, 1080],
                            lights=[dict(name="tl_a", position=[30.0, 0.0, 1.0])])
    mod = ttl.TrafficlightModule(cfg)
    mod.setup(cfg)
    mod.set_model(lambda im: calls.append(im.shape) or (np.zeros((1, 4)), np.zeros(1),
                                                         np.zeros(1, int), np.zeros(1, bool)))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="OpenCV"):
        load_image(jpeg, rgb=True)
    with pytest.raises(RuntimeError, match="OpenCV"):
        mod.process(dict(image={"front": jpeg}, slam_pose=np.eye(4)))
    out = mod.process(dict(image={"front": img}, slam_pose=np.eye(4)))
    assert calls == [(1080, 1920, 3)] and out["lights"] == []
    assert mod.process(dict(image={}))["lights"] == []


def test_config_and_pipeline_core_match_the_reference(tmp_path):
    assert tconfig.DEFAULT_CONFIG == jconfig.DEFAULT_CONFIG
    mgr = tconfig.ConfigManager()
    mgr.config.detection.enable = True
    path = mgr.dump(str(tmp_path / "cfg.yaml"))
    assert jconfig.ConfigManager(path).config == tconfig.ConfigManager(path).config
    assert mgr.check_config(jconfig.ConfigManager(path).config) == tconfig.CheckResult.SUCCESS

    class Count(Module):
        def __init__(self):
            super().__init__("Count")
            self.n = 0

        def get_data(self):
            if self.n >= 5:
                return None
            self.n += 1
            return dict(k=self.n)

    bank = DataBank()
    bank.blocking = True                 # offline mode: no frame dropped
    reg = {"Count": lambda cfg: Count(), "DataBank": lambda cfg: bank}
    manager = ModuleManager(reg)
    manager.build([["Count", "DataBank"]], mgr.config)
    manager.start()
    try:
        for _ in range(100):
            if (bank.get_latest() or {}).get("k") == 5:
                break
            time.sleep(0.02)
        assert bank.get_latest() == dict(k=5)
    finally:
        manager.stop()
    assert manager.get_status()["status"] == "Stopped"


def test_camera_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.ConfigManager().config
    for call in (lambda: tinf.Mono3DInfer(), lambda: ttl.build_yolo_predict_fn(),
                 lambda: tmod.DetectModule(cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert tmod.DetectModule(cfg, device="cpu").device.type == "cpu"
