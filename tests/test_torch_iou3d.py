"""Port parity: rotated 3D IoU / GIoU and NMS (``lsd_tpu_torch.ops.iou3d``)
and postprocessing against ``lsd_tpu`` on the CPU.

Tolerances, as measured: overlap areas (m^2), IoU and GIoU of identical,
disjoint, touching, nested, rotated and random pairs within 1e-5 + 1e-5 of
the value (measured: at most 1.13e-5, on an area of 0.87 m^2; float32
trigonometry and divisions in another library); keep masks and kept
indices of NMS and postprocessing equal (the port's top-k breaks ties by
index, as the reference's does).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.detection import post as jpost
from lsd_tpu.ops import iou3d as J
from lsd_tpu_torch.detection import post as tpost
from lsd_tpu_torch.ops import iou3d as T

TOL = 1e-5


def box(x=0, y=0, z=0, dx=4, dy=2, dz=1.6, yaw=0.0):
    return [x, y, z, dx, dy, dz, yaw]


PAIRS = {
    "identical": ([box()], [box()]),
    "disjoint": ([box(0, 0)], [box(100, 0)]),
    "touching_edge": ([box(0, 0)], [box(4, 0)]),
    "touching_corner": ([box(0, 0)], [box(4, 2)]),
    "nested": ([box(0, 0, dx=6, dy=4, dz=3)], [box(0.5, 0.3, dx=2, dy=1, dz=1, yaw=0.3)]),
    "rotated_45": ([box(0, 0, dx=1, dy=1, dz=1)], [box(0, 0, dx=1, dy=1, dz=1, yaw=np.pi / 4)]),
    "rotated_offset": ([box(0, 0, yaw=0.2)], [box(1.5, 0.7, 0.4, 3.5, 1.8, 1.2, -1.1)]),
    "negative_size_order": ([box(0, 0, yaw=np.pi)], [box(0.2, 0, yaw=-np.pi / 2)]),
}


def _random_boxes(seed, n, spread=10.0):
    rng = np.random.default_rng(seed)
    return np.c_[rng.uniform(-spread, spread, (n, 2)), rng.uniform(-0.5, 1.5, n),
                 rng.uniform(0.5, 5.0, (n, 3)), rng.uniform(-np.pi, np.pi, n)].astype(np.float32)


def _both(fn, a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    want = np.asarray(getattr(J, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(T, fn)(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    return got, want


@pytest.mark.parametrize("name", sorted(PAIRS))
@pytest.mark.parametrize("fn", ["boxes_overlap_bev", "boxes_iou3d", "boxes_giou3d"])
def test_pairs_match(name, fn):
    a, b = PAIRS[name]
    got, want = _both(fn, a, b)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    got_t, want_t = _both(fn, b, a)
    np.testing.assert_allclose(got_t, want_t, rtol=TOL, atol=TOL)


def test_known_values():
    got, _ = _both("boxes_iou3d", *PAIRS["identical"])
    np.testing.assert_allclose(got, [[1.0]], atol=1e-5)
    got, _ = _both("boxes_overlap_bev", *PAIRS["rotated_45"])
    np.testing.assert_allclose(got, [[2 * (np.sqrt(2) - 1)]], atol=1e-5)
    got, _ = _both("boxes_overlap_bev", *PAIRS["nested"])
    np.testing.assert_allclose(got, [[2.0]], atol=1e-5)
    assert _both("boxes_iou3d", *PAIRS["disjoint"])[0][0, 0] == 0.0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fn", ["boxes_overlap_bev", "boxes_iou3d", "boxes_giou3d"])
def test_random_matrices_match(seed, fn):
    a, b = _random_boxes(seed, 40, 6.0), _random_boxes(seed + 10, 33, 6.0)
    got, want = _both(fn, a, b)
    assert (_both("boxes_overlap_bev", a, b)[1] > 0.01).sum() > 50
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_keep,thresh,spread", [(128, 0.1, 15.0), (16, 0.1, 3.0)])
def test_nms_keep_masks_equal(seed, max_keep, thresh, spread):
    rng = np.random.default_rng(seed)
    boxes = _random_boxes(seed, 200, spread)
    scores = rng.uniform(0, 1, 200).astype(np.float32)
    scores[:3] = scores[3]                                 # ties
    mask = rng.uniform(size=200) > 0.3
    ji, jk = J.nms_bev(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(mask), thresh,
                       max_keep)
    ti, tk = T.nms_bev(torch.as_tensor(boxes), torch.as_tensor(scores), torch.as_tensor(mask),
                       thresh, max_keep)
    jk = np.asarray(jk)
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_array_equal(ti.numpy()[jk], np.asarray(ji)[jk])
    assert 3 < jk.sum() < min(max_keep, mask.sum())        # some kept, some suppressed


def test_nms_all_masked_and_few_boxes():
    boxes = _random_boxes(3, 5)
    scores = np.linspace(0.9, 0.5, 5).astype(np.float32)
    for mask in (np.zeros(5, bool), np.ones(5, bool)):
        ji, jk = J.nms_bev(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(mask), 0.1, 128)
        ti, tk = T.nms_bev(torch.as_tensor(boxes), torch.as_tensor(scores),
                           torch.as_tensor(mask), 0.1, 128)
        assert tk.shape == (5,)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_postprocess_thresholds_and_budget():
    cfg_j = jpost.PostProcessConfig(score_thresh=(0.5, 0.6, 0.7), max_objects=8)
    cfg_t = tpost.PostProcessConfig(score_thresh=(0.5, 0.6, 0.7), max_objects=8)
    boxes = np.asarray([box(i * 10, 0) for i in range(16)], np.float32)
    scores = np.asarray([0.9, 0.65, 0.65, 0.55] * 2 + [0.1] * 8, np.float32)
    labels = np.asarray([0, 1, 2, 2] * 4, np.int32)
    mask = np.ones(16, bool)
    jo = jpost.postprocess(cfg_j, *(jnp.asarray(a) for a in (boxes, scores, labels, mask)))
    to = tpost.postprocess(cfg_t, *(torch.as_tensor(a) for a in (boxes, scores, labels, mask)))
    keep = np.asarray(jo[3])
    assert keep.sum() == 4
    np.testing.assert_array_equal(to[3].numpy(), keep)
    for a, b in zip(to[:3], jo[:3]):
        np.testing.assert_array_equal(a.numpy()[keep], np.asarray(b)[keep])
