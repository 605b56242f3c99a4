"""Port parity: the shipped camera checkpoints at full width in both packages.

- The port's msgpack reader gives the tree flax gives for
  ``weights/mono3d.msgpack`` (1,866,348 float32 parameters) and
  ``weights/yolo2d_trafficlight.msgpack`` (293,289); ``convert`` carries
  both into the port's models and back unchanged.
- Mono3D (384 x 640, float32): the reference's ``Mono3DTrainer.evaluate``
  and the port's ``mono3d_frames`` + ``mono3d_ap`` on the 16 scenes of
  ``SyntheticMono3DDataset(Mono3DSceneConfig(hw=(384, 640)), batch_size=4,
  seed=999)``.  The scenes hold 16 vehicles, 7 pedestrians, 8 cyclists and
  12 cones; one box gained or lost moves a class's AP by up to 1 / its
  count, so the mean by up to 1/7/4 = 0.036: the bar is
  ``MONO3D_AP_BAR`` = 0.04.  (Both give 0.5667 on the CPU.)
- Yolo2D (256 x 320, bf16, the 4 classes it was trained with): the
  reference's ``YoloTrainer.evaluate`` and the port's ``yolo2d_frames`` +
  ``yolo2d_ap`` on the 16 scenes of ``SyntheticTrafficLightDataset(
  TrafficLightSceneConfig(), batch_size=4, seed=999)``: 11 red, 6 yellow,
  8 green and 2 off lights; one box in any class but "off" moves the mean
  by up to 1/6/4 = 0.042: the bar is ``YOLO_AP_BAR`` = 0.05 (a box of
  "off" alone would move it by 0.125).  (Both give 0.9356 on the CPU.)

``python -m tests.test_torch_camera_weights`` prints both packages'
figures (the JAX ones are ``chip_smoke.py``'s ``JAX_MONO3D_AP`` and
``JAX_YOLO_AP``).
"""
import jax
import numpy as np
import pytest
from flax import serialization

from lsd_tpu.models.mono3d import Mono3DConfig as JMono3DConfig
from lsd_tpu.models.yolo2d import Yolo2DConfig as JYolo2DConfig
from lsd_tpu.training import mono3d as jm3
from lsd_tpu.training import yolo as jyolo
from lsd_tpu_torch import convert
from lsd_tpu_torch.models import params_io
from lsd_tpu_torch.models.mono3d import Mono3D, Mono3DConfig
from lsd_tpu_torch.models.yolo2d import Yolo2D, Yolo2DConfig
from lsd_tpu_torch.training import camera_data as tdata

MONO3D, YOLO = "weights/mono3d.msgpack", "weights/yolo2d_trafficlight.msgpack"
MONO3D_AP_BAR, YOLO_AP_BAR = 0.04, 0.05
N_BATCHES, BATCH, SEED = 4, 4, 999


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("path,n_params,model", [
    (MONO3D, 1_866_348, lambda: Mono3D(Mono3DConfig())),
    (YOLO, 293_289, lambda: Yolo2D(Yolo2DConfig(num_classes=4)))])
def test_reader_and_converter_on_shipped_files(path, n_params, model):
    blob = open(path, "rb").read()
    want = serialization.msgpack_restore(blob)
    got = params_io.load_params(path)
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype == np.float32
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert params_io.count_params(got)[1] == n_params
    m = model()
    convert.load_camera_params(m, got)
    back = dict(_leaves(convert.camera_params_to_flax(m)))
    assert back.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(back[k], w[k], err_msg=k)


def mono3d_aps():
    """(JAX's evaluate, the port's) on the 16 scenes, both on the CPU."""
    trainer = jm3.Mono3DTrainer(JMono3DConfig())
    trainer.load(MONO3D)
    scenes = lambda mod: mod.SyntheticMono3DDataset(
        mod.Mono3DSceneConfig(hw=(384, 640)), batch_size=BATCH, seed=SEED).batches(N_BATCHES)
    ref = trainer.evaluate(scenes(jm3))
    model = Mono3D(Mono3DConfig())
    convert.load_camera_params(model, params_io.load_params(MONO3D))
    frames = tdata.mono3d_frames(model.eval(), scenes(tdata),
                                 tdata.default_intrinsic((384, 640)), "cpu")
    return ref, tdata.mono3d_ap(frames)


def yolo_aps():
    trainer = jyolo.YoloTrainer(JYolo2DConfig(num_classes=4))
    trainer.load(YOLO)
    scenes = lambda mod: mod.SyntheticTrafficLightDataset(
        mod.TrafficLightSceneConfig(), batch_size=BATCH, seed=SEED).batches(N_BATCHES)
    ref = trainer.evaluate(scenes(jyolo))
    model = Yolo2D(Yolo2DConfig(num_classes=4))
    convert.load_camera_params(model, params_io.load_params(YOLO))
    return ref, tdata.yolo2d_ap(tdata.yolo2d_frames(model.eval(), scenes(tdata), "cpu"), 4)


def test_mono3d_mean_ap_matches_jax():
    ref, got = mono3d_aps()
    assert ref["mean_ap"] == pytest.approx(0.5667, abs=1e-4) and ref["n_matched"] == 28
    assert abs(got["mean_ap"] - ref["mean_ap"]) <= MONO3D_AP_BAR, (got, ref)
    assert set(got["per_class"]) == set(ref["per_class"])


def test_yolo2d_mean_ap_matches_jax():
    ref, got = yolo_aps()
    assert ref["mean_ap"] == pytest.approx(0.9356, abs=1e-4)
    assert abs(got["mean_ap"] - ref["mean_ap"]) <= YOLO_AP_BAR, (got, ref)
    assert set(got["per_class"]) == set(ref["per_class"])


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for name, fn in (("mono3d", mono3d_aps), ("yolo2d", yolo_aps)):
        ref, got = fn()
        print(f"{name}: JAX {ref}; port {got}")
