"""Port parity: the detection path's modules against ``lsd_tpu`` on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
networks of both are built in float32 from one random initialisation
(flax's, moved over by ``convert.detector_params_from_flax``) at a small
grid.  Tolerances, each as measured:
- ``voxelize_dynamic``: equal (voxels, coords, counts, mask), overflowing
  pillars and an overflowing voxel budget included;
- the scatters: equal (each cell receives one pillar);
- ``PillarVFE``, ``BEVBackbone``, ``CenterHead`` and the assembled network
  in float32: within 1e-4 of the largest magnitude of each output
  (measured: at most 6.0e-6 of it; convolutions sum in another order);
- ``decode_boxes`` + ``postprocess`` fed the same maps: the same kept
  boxes, scores and labels within 1e-5 (the top-K slots of exact ties may
  be ordered otherwise, so only kept boxes are compared);
- the numpy copies (scenes, accumulator, object filter, freespace) and
  ``ap_3d``: equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.detection import accumulate as jacc
from lsd_tpu.detection import eval as jeval
from lsd_tpu.detection import freespace as jfree
from lsd_tpu.detection import object_filter as jfilt
from lsd_tpu.detection import post as jpost
from lsd_tpu.models import bev_backbone as jbb
from lsd_tpu.models import center_head as jhead
from lsd_tpu.models import detector as jdet
from lsd_tpu.models import vfe as jvfe
from lsd_tpu.ops import voxelize as jvox
from lsd_tpu.training import data as jdata
from lsd_tpu_torch import convert
from lsd_tpu_torch.detection import accumulate as tacc
from lsd_tpu_torch.detection import eval as teval
from lsd_tpu_torch.detection import freespace as tfree
from lsd_tpu_torch.detection import object_filter as tfilt
from lsd_tpu_torch.detection import post as tpost
from lsd_tpu_torch.models import bev_backbone as tbb
from lsd_tpu_torch.models import center_head as thead
from lsd_tpu_torch.models import detector as tdet
from lsd_tpu_torch.models import vfe as tvfe
from lsd_tpu_torch.ops import voxelize as tvox
from lsd_tpu_torch.training import data as tdata

REL = 1e-4
SMALL = jdet.DetectorConfig(pc_range=(-12.8, -12.8, -3.0, 12.8, 12.8, 3.0),
                            voxel_size=(0.2, 0.2, 6.0), max_voxels=4096,
                            max_points_per_voxel=8, bev_stride=2)
SMALL_S2D = SMALL._replace(pc_range=(-6.4, -6.4, -2.0, 6.4, 6.4, 4.0), voxel_size=(0.1, 0.1, 6.0),
                           max_voxels=8192, max_points_per_voxel=5, s2d_factor=2)
SMALL_VOXEL = SMALL._replace(voxel_size=(0.4, 0.4, 1.0), encoder="voxel", bev_stride=1,
                             max_voxels=8192)


def _t(cfg):
    return tdet.DetectorConfig(**cfg._asdict())


def _points(seed, n=6000, rng_xy=12.0, dense=True):
    """Scene-like points: a cluttered ground and a few tight clusters that
    overflow their pillars; a tail of masked and out-of-range points."""
    rng = np.random.default_rng(seed)
    ground = np.c_[rng.uniform(-rng_xy, rng_xy, (n, 2)), rng.normal(0, 0.05, n),
                   rng.uniform(0, 1, n)]
    blobs = [np.c_[rng.normal(c, 0.05, (60, 2)), rng.uniform(0, 2, 60), rng.uniform(0, 1, 60)]
             for c in rng.uniform(-rng_xy * 0.8, rng_xy * 0.8, (6, 2))] if dense else []
    far = np.c_[rng.uniform(30, 40, (20, 2)), np.zeros(20), np.ones(20)]
    pts = np.concatenate([ground, *blobs, far]).astype(np.float32)
    mask = rng.uniform(size=len(pts)) > 0.05
    return pts, mask


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, f"relative error {err:.3e} > {rel}"
    return err


@pytest.mark.parametrize("cfg,max_voxels,ppv", [(SMALL, 4096, 8), (SMALL_S2D, 8192, 5),
                                                (SMALL, 700, 3), (SMALL_VOXEL, 8192, 4)])
def test_voxelize_dynamic_equal(cfg, max_voxels, ppv):
    pts, mask = _points(3)
    want = jvox.voxelize_dynamic(jnp.asarray(pts), jnp.asarray(mask), cfg.voxel_size,
                                 cfg.pc_range, max_voxels, ppv)
    got = tvox.voxelize_dynamic(torch.as_tensor(pts), torch.as_tensor(mask), cfg.voxel_size,
                                cfg.pc_range, max_voxels, ppv)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    counts = np.asarray(want[2])
    assert (counts == ppv).sum() >= 10                     # pillars that overflow P
    if max_voxels == 700:
        assert counts.min() > 0                            # the voxel budget overflows


def _flax_params(cfg, seed=0):
    model = jdet.CenterPointDetector(cfg)
    pts, mask = _points(seed)
    init = jax.jit(model.init)            # one compile: eager bf16 init takes ~20 s
    return init(jax.random.PRNGKey(seed), jnp.asarray(pts), jnp.asarray(mask))["params"]


def _torch_model(cfg, params):
    model = tdet.CenterPointDetector(_t(cfg), dtype=torch.float32)
    model.load_state_dict(convert.detector_params_from_flax({"params": params}))
    return model.eval()


def _jax_vfe_bev(cfg, params, pts, mask):
    """The reference network's float32 encoder: voxelize, VFE, scatter."""
    voxels, coords, num_pts, vmask = jvox.voxelize_dynamic(
        jnp.asarray(pts), jnp.asarray(mask), cfg.voxel_size, cfg.pc_range, cfg.max_voxels,
        cfg.max_points_per_voxel)
    if cfg.encoder == "voxel":
        feats = jvfe.MeanVFE().apply({}, voxels, num_pts) * vmask[:, None]
        vol = jvfe.scatter_to_voxel_bev(feats, coords, vmask, cfg.grid_hw, cfg.grid_z)
        enc = jvfe.VoxelHeightEncoder(cfg.pillar_filters, dtype=jnp.float32)
        return feats, enc.apply({"params": params["VoxelHeightEncoder_0"]}, vol)
    vfe = jvfe.PillarVFE(cfg.pillar_filters, tuple(cfg.voxel_size), tuple(cfg.pc_range),
                         dtype=jnp.float32)
    feats = vfe.apply({"params": params["PillarVFE_0"]}, voxels, coords, num_pts)
    feats = feats * vmask[:, None]
    if cfg.s2d_factor > 1:
        return feats, jvfe.scatter_to_bev_s2d(feats, coords, vmask, cfg.grid_hw, cfg.s2d_factor)
    return feats, jvfe.scatter_to_bev(feats, coords, vmask, cfg.grid_hw)


@functools.partial(jax.jit, static_argnums=0)
def _jax_net_jit(cfg, params, pts, mask):
    feats, bev = _jax_vfe_bev(cfg, params, pts, mask)
    x = jbb.BEVBackbone(strides=(cfg.bev_stride, 2, 2), dtype=jnp.float32).apply(
        {"params": params["BEVBackbone_0"]}, bev)
    maps = jhead.CenterHead(num_classes=cfg.num_classes, dtype=jnp.float32).apply(
        {"params": params["CenterHead_0"]}, x)
    return feats, bev, x, maps


def _jax_net(cfg, params, pts, mask):
    """The reference's float32 network, compiled once per configuration:
    (pillar features, BEV image, backbone output, head maps)."""
    return _jax_net_jit(cfg, params, jnp.asarray(pts), jnp.asarray(mask))


def _nchw(a):
    return torch.tensor(np.asarray(a, np.float32)).permute(2, 0, 1)[None]


@pytest.mark.parametrize("cfg", [SMALL, SMALL_S2D, SMALL_VOXEL], ids=["pillar", "s2d", "voxel"])
def test_network_float32_matches(cfg):
    params = _flax_params(cfg)
    model = _torch_model(cfg, params)
    pts, mask = _points(1)
    feats, bev, x, maps = _jax_net(cfg, params, pts, mask)
    tp, tm = torch.as_tensor(pts), torch.as_tensor(mask)
    with torch.no_grad():
        voxels, coords, num_pts, vmask = tvox.voxelize_dynamic(
            tp, tm, cfg.voxel_size, cfg.pc_range, cfg.max_voxels, cfg.max_points_per_voxel)
        if cfg.encoder == "voxel":
            tfeats = model.mean_vfe(voxels, num_pts) * vmask[:, None]
        else:
            tfeats = model.vfe(voxels, coords, num_pts) * vmask[:, None]
        _close(tfeats, feats)
        tbev = model.encode(tp, tm)
        if cfg.encoder == "voxel":
            tbev = model.encoder(tbev[None].permute(0, 3, 1, 2))[0].permute(1, 2, 0)
        _close(tbev, bev)
        # each stage from the reference's own input, then the whole network
        tx = model.backbone(_nchw(bev))
        _close(tx[0].permute(1, 2, 0), x)
        tmaps = model.head(_nchw(x))
        for k, v in maps.items():
            _close(tmaps[k][0].permute(1, 2, 0), v)
        whole = model(tp, tm)
    for k, v in maps.items():
        _close(whole[k], v)
    assert whole["heatmap"].shape == (*cfg.head_hw, cfg.num_classes)


def test_scatters_equal():
    rng = np.random.default_rng(5)
    H, W, V, C = 32, 48, 300, 6
    cells = rng.choice(H * W, V, replace=False)
    coords = np.c_[rng.integers(0, 3, V), cells // W, cells % W].astype(np.int32)
    vmask = rng.uniform(size=V) > 0.2
    feats = rng.normal(size=(V, C)).astype(np.float32)
    j = [jnp.asarray(a) for a in (feats, coords, vmask)]
    t = [torch.as_tensor(a) for a in (feats, coords, vmask)]
    np.testing.assert_array_equal(tvfe.scatter_to_bev(*t, (H, W)).numpy(),
                                  np.asarray(jvfe.scatter_to_bev(*j, (H, W))))
    np.testing.assert_array_equal(tvfe.scatter_to_bev_s2d(*t, (H, W), 2).numpy(),
                                  np.asarray(jvfe.scatter_to_bev_s2d(*j, (H, W), 2)))
    np.testing.assert_array_equal(tvfe.scatter_to_voxel_bev(*t, (H, W), 3).numpy(),
                                  np.asarray(jvfe.scatter_to_voxel_bev(*j, (H, W), 3)))


@pytest.mark.parametrize("hw", [(16, 16), (8, 24)])
def test_backbone_same_padding_and_transposed_conv(hw):
    """flax's "SAME" padding of the strided convs (0 before, 1 after on even
    sizes) and its unflipped transposed-conv kernels."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1, *hw, 16)).astype(np.float32)
    bb = jbb.BEVBackbone(layer_nums=(1, 1, 1), channels=(32, 32, 64), strides=(2, 2, 2),
                         up_channels=(8, 8, 8), dtype=jnp.float32)
    params = bb.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(bb.apply({"params": params}, jnp.asarray(x)))
    tb = tbb.BEVBackbone(16, (1, 1, 1), (32, 32, 64), (2, 2, 2), (8, 8, 8), dtype=torch.float32)
    sd = convert.detector_params_from_flax({"params": {"BEVBackbone_0": params}})
    tb.load_state_dict({k.removeprefix("backbone."): v for k, v in sd.items()})
    with torch.no_grad():
        got = tb(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want)


def _maps(cfg, seed):
    """Head maps with a few peaks above the thresholds, overlapping pairs
    among them, on a floor of tied logits."""
    rng = np.random.default_rng(seed)
    H, W = cfg.head_hw
    hm = np.full((H, W, 3), -4.6, np.float32)
    for _ in range(40):
        y, x, c = rng.integers(0, H), rng.integers(0, W), rng.integers(0, 3)
        hm[y, x, c] = rng.uniform(-2.0, 3.0)
        if rng.uniform() < 0.5:                            # a neighbour: NMS has work
            hm[min(y + 1, H - 1), x, rng.integers(0, 3)] = rng.uniform(-1.0, 2.0)
    return dict(heatmap=hm, offset=rng.uniform(0, 1, (H, W, 2)).astype(np.float32),
                z=rng.normal(0.8, 0.2, (H, W, 1)).astype(np.float32),
                dim=np.log(rng.uniform(0.6, 4.5, (H, W, 3))).astype(np.float32),
                rot=rng.normal(size=(H, W, 2)).astype(np.float32),
                seg=rng.normal(size=(H, W, 1)).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_and_postprocess_keep_the_same_boxes(seed):
    cfg = SMALL
    maps = _maps(cfg, seed)
    jm = jdet.CenterPointDetector(cfg)
    tm = tdet.CenterPointDetector(_t(cfg))
    jout = jpost.postprocess(jpost.PostProcessConfig(),
                             *jm.decode({k: jnp.asarray(v) for k, v in maps.items()}))
    tout = tpost.postprocess(tpost.PostProcessConfig(),
                             *tm.decode({k: torch.as_tensor(v) for k, v in maps.items()}))
    jb, js, jl, jk = (np.asarray(a) for a in jout)
    tb, ts, tl, tk = (a.numpy() for a in tout)
    assert jk.sum() >= 5 and tk.sum() == jk.sum()
    np.testing.assert_allclose(tb[tk], jb[jk], atol=1e-5)
    np.testing.assert_allclose(ts[tk], js[jk], atol=1e-5)
    np.testing.assert_array_equal(tl[tk], jl[jk])
    # and the raw decode agrees slot for slot above the tie floor
    jd = jhead.decode_boxes({k: jnp.asarray(v) for k, v in maps.items()}, cfg.voxel_size,
                            cfg.pc_range, cfg.head_stride, 256)
    td = thead.decode_boxes({k: torch.as_tensor(v) for k, v in maps.items()}, cfg.voxel_size,
                            cfg.pc_range, cfg.head_stride, 256)
    above = np.asarray(jd[1]) > 0.02
    np.testing.assert_allclose(td[0].numpy()[above], np.asarray(jd[0])[above], atol=1e-5)


@pytest.mark.parametrize("seed", [0, 999])
def test_synthetic_scenes_equal(seed):
    for realistic in (False, True):
        jcfg, tcfg = jdata.SyntheticSceneConfig(realistic=realistic), \
            tdata.SyntheticSceneConfig(realistic=realistic)
        jcfg.xy_range = tcfg.xy_range = 60.0
        jb = list(jdata.SyntheticDetectionDataset(jcfg, batch_size=2, seed=seed).batches(2))
        tb = list(tdata.SyntheticDetectionDataset(tcfg, batch_size=2, seed=seed).batches(2))
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_accumulator_filter_freespace_equal():
    rng = np.random.default_rng(11)
    ja, ta = jacc.FrameAccumulator(2, 512), tacc.FrameAccumulator(2, 512)
    for k in range(4):
        pts = rng.normal(size=(600, 4)).astype(np.float32)
        mask = rng.uniform(size=600) > 0.3
        motion = np.eye(4)
        motion[:3, 3] = [1.0, 0.1 * k, 0.0]
        c, s = np.cos(0.05 * k), np.sin(0.05 * k)
        motion[:2, :2] = [[c, -s], [s, c]]
        for a, b in zip(ja.push(pts, mask, motion if k else None),
                        ta.push(pts, mask, motion if k else None)):
            np.testing.assert_array_equal(a, b)
    objs = dict(objects=[dict(box=rng.uniform(-10, 10, 7), label=int(rng.integers(0, 3)))
                         for _ in range(40)], num_tracks=40)
    kw = dict(class_enabled=[True, False, True],
              include_polygons=[np.asarray([[-8, -8], [8, -8], [8, 8], [-8, 8]])],
              exclude_polygons=[np.asarray([[0, 0], [5, 0], [0, 5]])])
    assert jfilt.ObjectFilter(**kw).filter(objs) == tfilt.ObjectFilter(**kw).filter(objs)
    seg = rng.normal(size=(64, 48, 1)).astype(np.float32)
    assert jfree.seg_to_freespace(seg, SMALL.pc_range, 0.4) == \
        tfree.seg_to_freespace(seg, SMALL.pc_range, 0.4)


def test_ap_equal():
    rng = np.random.default_rng(4)
    frames = []
    for _ in range(5):
        gt = np.c_[rng.uniform(-20, 20, (6, 2)), np.full(6, 0.8), np.tile([4.5, 1.9, 1.6], (6, 1)),
                   rng.uniform(-3, 3, 6)].astype(np.float32)
        pred = gt + rng.normal(0, 0.3, gt.shape).astype(np.float32) * [1, 1, 0.2, 0.2, 0.1, 0.1, 0.1]
        pred = np.concatenate([pred, pred[:2] + [5, 5, 0, 0, 0, 0, 0]]).astype(np.float32)
        frames.append(dict(boxes=pred, scores=rng.uniform(0.3, 1, 8), labels=rng.integers(0, 3, 8),
                           gt_boxes=gt, gt_labels=rng.integers(0, 3, 6)))
    for thr in (0.5, {0: 0.7, 1: 0.5, 2: 0.5}):
        assert teval.evaluate_frames(frames, thr) == jeval.evaluate_frames(frames, thr)
    args = ([f["boxes"] for f in frames], [f["scores"] for f in frames],
            [f["gt_boxes"] for f in frames])
    assert teval.ap_3d(*args, iou_thresh=0.5) == jeval.ap_3d(*args, iou_thresh=0.5)
