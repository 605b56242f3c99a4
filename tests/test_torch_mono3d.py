"""Port parity: the monocular 3D detector and the camera-lidar late fusion
(``lsd_tpu_torch/models/mono3d.py``, ``detection/camera_fusion.py``,
``training/camera_data.py``) against ``lsd_tpu`` on the same numpy inputs.

Tolerances:
- A tiny ``Mono3D`` (``base_ch=8``) initialised by flax and carried across
  by ``convert.load_camera_params``, at 96 x 160 and at 72 x 120, where the
  two upsamplings are not integer ratios (stride 16 gives 5 x 8, stride 8
  gives 9 x 15): every map within 1e-4 of its largest magnitude (float32 in
  both; measured ~2e-6).
- ``_nms_heat``: the same peaks.  ``decode_mono3d``: the same valid slots,
  labels and cells; boxes within 1e-4 m (relative to 1 m) and scores
  within 1e-6.
- The fusion and the synthetic scenes are numpy copies: equal results,
  the training target maps (``t_*``) of a batch included.
- The evaluation over a tiny model's frames: the same AP dict as the
  reference's ``Mono3DTrainer.evaluate``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.detection import camera_fusion as jfuse
from lsd_tpu.models import mono3d as jm
from lsd_tpu.training import mono3d as jtrain
from lsd_tpu_torch import convert
from lsd_tpu_torch.detection import camera_fusion as tfuse
from lsd_tpu_torch.models import mono3d as tm
from lsd_tpu_torch.training import camera_data as tdata

MAP_RTOL, BOX_ATOL, SCORE_ATOL = 1e-4, 1e-4, 1e-6
HWS = [(96, 160), (72, 120)]


def _pair(hw, seed=3):
    """(flax model, params, port model) of a tiny Mono3D at ``hw``."""
    cfg = jm.Mono3DConfig(image_hw=hw, base_ch=8)
    model = jm.Mono3D(cfg)
    params = jax.device_get(model.init(jax.random.PRNGKey(seed), jnp.zeros((*hw, 3))))
    port = tm.Mono3D(tm.Mono3DConfig(**cfg._asdict()))
    convert.load_camera_params(port, params)
    return model, params, port.eval()


def _image(hw, seed=0):
    return np.random.default_rng(seed).random((*hw, 3)).astype(np.float32)


def _port_maps(port, img):
    with torch.no_grad():
        return {k: v.numpy() for k, v in
                tm.maps_hwc(port(torch.as_tensor(img).permute(2, 0, 1)[None])).items()}


@pytest.mark.parametrize("hw", HWS)
def test_maps_match_jax(hw):
    model, params, port = _pair(hw)
    img = _image(hw)
    ref = jax.device_get(model.apply(params, jnp.asarray(img)))
    got = _port_maps(port, img)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].shape == v.shape == (-(-hw[0] // 4), -(-hw[1] // 4), got[k].shape[-1])
        err = float(np.abs(got[k] - v).max() / np.abs(v).max())
        assert err <= MAP_RTOL, (k, err)


def test_upsampling_is_jax_nearest_at_non_integer_ratios():
    x = np.random.default_rng(1).normal(size=(1, 5, 8, 3)).astype(np.float32)
    for size in ((9, 15), (18, 30), (7, 11)):
        ref = np.asarray(jax.image.resize(x, (1, *size, 3), "nearest"))
        got = torch.nn.functional.interpolate(torch.as_tensor(x).permute(0, 3, 1, 2), size=size,
                                              mode="nearest-exact").permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw", HWS)
def test_nms_heat_and_decode_match_jax(hw):
    model, params, _ = _pair(hw)
    maps = jax.device_get(model.apply(params, jnp.asarray(_image(hw, 2))))
    heat = jax.nn.sigmoid(jnp.asarray(maps["heat"]))
    ref_peaks = np.asarray(jm._nms_heat(heat))
    got_peaks = tm._nms_heat(torch.as_tensor(np.array(heat))).numpy()
    np.testing.assert_array_equal(np.isfinite(got_peaks), np.isfinite(ref_peaks))
    K = np.asarray([[0.875 * hw[1], 0, hw[1] / 2], [0, 0.875 * hw[1], hw[0] / 2], [0, 0, 1]],
                   np.float32)
    for k in (64, 8):
        ref = jax.device_get(jm.decode_mono3d(maps, jnp.asarray(K), max_objects=k))
        got = [a.numpy() for a in tm.decode_mono3d(
            {n: torch.tensor(v) for n, v in maps.items()}, torch.as_tensor(K), k)]
        np.testing.assert_array_equal(got[3], ref[3])
        v = ref[3]
        assert v.sum() >= min(k, 5)
        np.testing.assert_array_equal(got[2][v], ref[2][v])
        np.testing.assert_allclose(got[0][v], ref[0][v], rtol=BOX_ATOL, atol=BOX_ATOL)
        np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=SCORE_ATOL)


def test_decode_of_target_maps_recovers_the_boxes():
    """The reference's own round trip: ideal maps built from its training
    targets decode to the same boxes in both packages."""
    K = np.asarray([[500.0, 0, 320.0], [0, 500.0, 192.0], [0, 0, 1.0]])
    gt = np.asarray([[2.0, 0.5, 20.0, 4.0, 1.8, 1.5, 0.3],
                     [-3.0, 0.8, 35.0, 0.6, 0.6, 1.7, -0.5]])
    t = jm.make_mono3d_targets(jm.Mono3DConfig(), gt, np.asarray([0, 1]), K)
    eps = 1e-6
    logit = lambda p: np.log(np.clip(p, eps, 1 - eps) / np.clip(1 - p, eps, 1 - eps))
    z = np.maximum(t["depth"], eps)
    preds = dict(heat=logit(t["heat"]), offset=logit(t["offset"]),
                 depth=np.log((1.0 / (z + 1.0)) / (1 - 1.0 / (z + 1.0) + eps)),
                 dims=t["dims"], rot=t["rot"])
    preds = {k: np.asarray(v, np.float32) for k, v in preds.items()}
    ref = jax.device_get(jm.decode_mono3d(preds, jnp.asarray(K, jnp.float32), max_objects=8))
    got = [a.numpy() for a in tm.decode_mono3d({k: torch.as_tensor(v) for k, v in preds.items()},
                                               torch.as_tensor(K, dtype=torch.float32), 8)]
    np.testing.assert_array_equal(got[3], ref[3])
    v = got[3]
    np.testing.assert_array_equal(got[2][v], ref[2][v])
    np.testing.assert_allclose(got[0][v], ref[0][v], rtol=BOX_ATOL, atol=BOX_ATOL)
    for g in gt:
        assert np.linalg.norm(got[0][v][:, :3] - g[:3], axis=1).min() < 0.5


def test_converter_round_trip_and_random_init():
    _, params, port = _pair((96, 160))
    back = convert.camera_params_to_flax(port)
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    fresh = tm.Mono3D(tm.Mono3DConfig(image_hw=(96, 160), base_ch=8))
    tm.init_camera_params(fresh, torch.Generator().manual_seed(0))
    assert float(fresh.Conv_0.bias.detach()[0]) == pytest.approx(tm.HEAT_BIAS)
    assert jax.tree.map(np.shape, convert.camera_params_to_flax(fresh)) == \
        jax.tree.map(np.shape, params)


def test_checkpoint_of_another_width_is_refused():
    _, params, _ = _pair((96, 160))
    with pytest.raises(ValueError, match="ConvBlock_0.Conv_0.weight"):
        convert.load_camera_params(tm.Mono3D(tm.Mono3DConfig(base_ch=16)), params)


def _v2c():
    V2C = np.zeros((4, 4))
    V2C[0, 1], V2C[1, 2], V2C[2, 0], V2C[3, 3] = -1.0, -1.0, 1.0, 1.0
    return V2C


def test_fusion_matches_jax():
    K = np.asarray([[500.0, 0, 320.0], [0, 500.0, 192.0], [0, 0, 1.0]])
    rng = np.random.default_rng(4)
    lidar = [dict(box=np.asarray([rng.uniform(8, 40), rng.uniform(-8, 8), -0.5, 4.0, 1.8, 1.5,
                                  rng.uniform(-3, 3)]), score=float(rng.uniform(0.3, 0.9)),
                  label=0) for _ in range(6)]
    lidar.append(dict(box=np.asarray([-20.0, 0, 0, 4, 2, 1.5, 0]), score=0.5, label=0))
    cams = []
    for o in lidar[:3]:
        r = jfuse.project_box_to_image(o["box"], _v2c(), K, (384, 640))
        cams.append(dict(rect=r + rng.normal(0, 3, 4), score=0.7, label=0))
    cams.append(dict(rect=np.asarray([0.0, 0, 10, 10]), score=0.5, label=1))
    cams.append(dict(box=np.asarray([1.0, 0.5, 15.0, 4.0, 1.8, 1.5, 0.2]), score=0.6, label=0))
    heat = rng.random((96, 160, 4)).astype(np.float32)
    for h in (None, heat):
        ref = jfuse.fuse_camera_lidar(lidar, cams, _v2c(), K, heat=h)
        got = tfuse.fuse_camera_lidar(lidar, cams, _v2c(), K, heat=h)
        assert [o["fused"] for o in got] == [o["fused"] for o in ref]
        assert [o["score"] for o in got] == [o["score"] for o in ref]
        assert sorted(o["fused"] for o in got)[:3] == ["matched"] * 3
    a = np.asarray([0, 0, 10, 10.0])
    assert tfuse.iou_2d(a, a) == 1.0 and tfuse.iou_2d(a, np.asarray([10, 10, 20, 20.0])) == 0.0


def test_scenes_match_jax():
    hw = (96, 160)
    ref = jtrain.SyntheticMono3DDataset(jtrain.Mono3DSceneConfig(hw=hw, max_objects=3),
                                        batch_size=2, seed=5).batch()
    got = tdata.SyntheticMono3DDataset(tdata.Mono3DSceneConfig(hw=hw, max_objects=3),
                                       batch_size=2, seed=5).batch()
    assert set(got) == set(ref) and "t_heat" in got
    for k, v in got.items():
        assert v.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    np.testing.assert_array_equal(tdata.default_intrinsic(hw), jtrain.default_intrinsic(hw))


def test_evaluation_matches_the_reference_trainer():
    hw = (96, 160)
    trainer = jtrain.Mono3DTrainer(jm.Mono3DConfig(image_hw=hw, base_ch=8))
    _, params, port = _pair(hw)
    trainer.params = params
    scene = lambda: jtrain.SyntheticMono3DDataset(
        jtrain.Mono3DSceneConfig(hw=hw, max_objects=3), batch_size=2, seed=9).batches(2)
    ref = trainer.evaluate(scene(), score_thresh=0.05)
    frames = tdata.mono3d_frames(port, [{k: v for k, v in b.items() if not k.startswith("t_")}
                                        for b in scene()],
                                 tdata.default_intrinsic(hw), "cpu", score_thresh=0.05)
    assert sum(len(f["boxes"]) for f in frames) > 0
    assert tdata.mono3d_ap(frames) == ref
