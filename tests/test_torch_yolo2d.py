"""Port parity: the traffic-light 2D detector (``lsd_tpu_torch/models/yolo2d.py``),
its decode and NMS, the 2D AP and the traffic-light scenes against
``lsd_tpu`` on the same numpy inputs.

Tolerances:
- ``Yolo2D`` (4 classes, flax's initialisation carried across) at
  128 x 160: bf16 in both, rounded at the same places, so the maps differ
  only where a float32 statistic or accumulation lands on the other side of
  a bf16 rounding (GroupNorm outputs differ at ~0.04 % of values, the
  convolutions at ~0.01 %) and that spreads through seven blocks: each
  float32 head map within ``BF16_RTOL`` = 3e-2 of its largest magnitude
  (measured 0.5-1 % at 256 x 320).
- ``decode_yolo2d`` on the same maps: the same indices and labels, boxes
  within 1e-4 (relative), scores within 1e-6.
- ``nms_2d``: equal keep masks on crafted overlaps (IoUs 0.16-0.86, none
  within 1e-2 of the threshold), exact score ties, masked candidates, and
  random boxes.
- ``ap_2d`` and the scenes are numpy copies: equal results; the shipped
  weights evaluated on small scenes: the same APs as the reference's
  ``YoloTrainer.evaluate``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.detection import eval as jeval
from lsd_tpu.models import yolo2d as jy
from lsd_tpu.training import yolo as jtrain
from lsd_tpu_torch import convert
from lsd_tpu_torch.detection import eval as teval
from lsd_tpu_torch.models import yolo2d as ty
from lsd_tpu_torch.models import params_io
from lsd_tpu_torch.models.mono3d import maps_hwc
from lsd_tpu_torch.training import camera_data as tdata

BF16_RTOL, BOX_RTOL, SCORE_ATOL = 3e-2, 1e-4, 1e-6


def _pair(hw=(128, 160), num_classes=4, seed=0):
    cfg = jy.Yolo2DConfig(num_classes=num_classes)
    model = jy.Yolo2D(cfg)
    params = jax.device_get(model.init(jax.random.PRNGKey(seed), jnp.zeros((*hw, 3))))
    port = ty.Yolo2D(ty.Yolo2DConfig(num_classes=num_classes))
    convert.load_camera_params(port, params)
    return model, params, port.eval()


def _port_maps(port, img):
    with torch.no_grad():
        return {k: v.numpy() for k, v in
                maps_hwc(port(torch.as_tensor(img).permute(2, 0, 1)[None])).items()}


@pytest.mark.parametrize("num_classes", [4, 8])
def test_maps_match_jax_within_bf16(num_classes):
    model, params, port = _pair(num_classes=num_classes)
    img = np.random.default_rng(1).random((128, 160, 3)).astype(np.float32)
    ref = jax.device_get(model.apply(params, jnp.asarray(img)))
    got = _port_maps(port, img)
    for k, v in ref.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape
        err = float(np.abs(got[k] - v).max() / np.abs(v).max())
        assert err <= BF16_RTOL, (k, err)


def test_decode_matches_jax():
    model, params, _ = _pair()
    img = np.random.default_rng(2).random((128, 160, 3)).astype(np.float32)
    maps = jax.device_get(model.apply(params, jnp.asarray(img)))
    ref = jax.device_get(jy.decode_yolo2d(maps, 16, 64))
    got = [a.numpy() for a in ty.decode_yolo2d({k: torch.tensor(v) for k, v in maps.items()},
                                               16, 64)]
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_allclose(got[0], ref[0], rtol=BOX_RTOL, atol=BOX_RTOL)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=SCORE_ATOL)


def _crafted():
    """Three clusters of five boxes whose pairwise IoUs lie at 0.16-0.86
    (the nearest to 0.5 is 0.488), exact score ties, masked candidates."""
    boxes, scores = [], []
    for c, base in enumerate(([10, 10, 50, 50], [100, 20, 140, 100], [200, 200, 230, 260])):
        b = np.asarray(base, float)
        w, h = b[2] - b[0], b[3] - b[1]
        for shift, sc in ((0.0, 0.9), (0.1, 0.9), (0.3, 0.8), (0.6, 0.8), (0.05, 0.7)):
            boxes.append(b + np.asarray([shift * w, shift * h / 2, shift * w, shift * h / 2]))
            scores.append(sc - 0.01 * c)
    boxes, scores = np.asarray(boxes, np.float32), np.asarray(scores, np.float32)
    mask = np.ones(len(boxes), bool)
    mask[[1, 7]] = False
    return boxes, scores, mask


def _nms_both(boxes, scores, mask, thresh=0.5):
    ref = np.asarray(jy.nms_2d(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(mask), thresh))
    got = ty.nms_2d(torch.as_tensor(boxes), torch.as_tensor(scores), torch.as_tensor(mask),
                    thresh).numpy()
    return got, ref


def test_nms_2d_matches_jax_on_crafted_overlaps_and_ties():
    boxes, scores, mask = _crafted()
    got, ref = _nms_both(boxes, scores, mask)
    np.testing.assert_array_equal(got, ref)
    assert 3 <= got.sum() < mask.sum() and not got[~mask].any()
    # all scores tied: the order is the index order in both
    got, ref = _nms_both(boxes, np.full_like(scores, 0.5), mask)
    np.testing.assert_array_equal(got, ref)
    got, ref = _nms_both(boxes, scores, np.zeros_like(mask))
    assert not got.any() and not ref.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_2d_matches_jax_on_random_boxes(seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 200, (64, 2))
    wh = rng.uniform(5, 60, (64, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, 64), 2).astype(np.float32)      # ties
    mask = rng.uniform(size=64) > 0.2
    for thresh in (0.3, 0.5):
        got, ref = _nms_both(boxes, scores, mask, thresh)
        np.testing.assert_array_equal(got, ref)


def test_ap_2d_matches_jax():
    rng = np.random.default_rng(3)
    pb, ps, gb = [], [], []
    for _ in range(6):
        g = np.concatenate([rng.uniform(0, 200, (4, 2)), rng.uniform(0, 200, (4, 2)) + 220], 1)
        p = np.concatenate([g[:3] + rng.normal(0, 8, (3, 4)), rng.uniform(0, 400, (2, 4))])
        pb.append(p.astype(np.float32))
        ps.append(rng.uniform(0, 1, len(p)).astype(np.float32))
        gb.append(g.astype(np.float32))
    for thresh in (0.5, 0.7):
        assert teval.ap_2d(pb, ps, gb, thresh) == jeval.ap_2d(pb, ps, gb, thresh)
    assert teval.ap_2d([], [], []) == jeval.ap_2d([], [], [])


def test_scenes_match_jax():
    ref = jtrain.SyntheticTrafficLightDataset(jtrain.TrafficLightSceneConfig(hw=(128, 160)),
                                              batch_size=3, seed=4).batch()
    got = tdata.SyntheticTrafficLightDataset(tdata.TrafficLightSceneConfig(hw=(128, 160)),
                                             batch_size=3, seed=4).batch()
    assert set(got) == set(ref)
    for k, v in got.items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_evaluation_matches_the_reference_trainer():
    """The shipped 4-class weights on 8 scenes at 128 x 160 through the
    reference's ``YoloTrainer.evaluate`` and through the port's
    ``yolo2d_frames`` + ``yolo2d_ap``: the same per-class APs."""
    hw = (128, 160)
    tree = params_io.load_params("weights/yolo2d_trafficlight.msgpack")
    port = ty.Yolo2D(ty.Yolo2DConfig(num_classes=4))
    convert.load_camera_params(port, tree)
    trainer = jtrain.YoloTrainer(jy.Yolo2DConfig(num_classes=4), hw=hw)
    trainer.params = tree
    scenes = lambda: jtrain.SyntheticTrafficLightDataset(
        jtrain.TrafficLightSceneConfig(hw=hw), batch_size=4, seed=9).batches(2)
    ref = trainer.evaluate(scenes())
    frames = tdata.yolo2d_frames(port.eval(), list(scenes()), "cpu")
    assert sum(len(f["boxes"]) for f in frames) >= 8
    got = tdata.yolo2d_ap(frames, 4)
    assert got["per_class"] == ref["per_class"] and got["mean_ap"] == ref["mean_ap"] > 0.5
