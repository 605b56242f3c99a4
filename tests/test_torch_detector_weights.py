"""Port parity: the shipped detector checkpoints in both packages.

- The port's own msgpack reader (``models/params_io.py``) gives the tree
  ``flax.serialization`` gives, leaf for leaf and dtype for dtype, for both
  shipped files and for an ``LSDQ8001`` int8 file that the reference's
  ``save_quantized`` writes (read back as ``q * scale`` by both).
- ``convert.detector_params_*`` both ways: flax -> port -> flax is the
  identity, and a port initialisation moved to flax gives the reference's
  float32 network the port's outputs within 1e-4 of their largest magnitude.
- Both shipped checkpoints served as ``build_detector_predict_fn`` serves
  them (bf16) in both packages, on realistic scenes, with ``pc_range`` cut
  to +-25.6 m (convolutions do not depend on the grid's size; the weight
  lookup matches the range exactly, so the path is passed).  Kept boxes
  are matched one to one by label and centre: centre within 0.1 m,
  heading within 0.05 rad modulo pi, score within 0.03; a box whose score
  lies within 0.03 of its class threshold may go unmatched (bf16 rounds at
  other places in the two frameworks).  Mean AP at the WOD IoUs over 4
  scenes within 0.01.  Measured on the CPU: refcap centre 0.0029 m,
  heading 0.0042 rad, score 0.0151, no box unmatched, mean AP 0.1840 in
  both; true_refcap 0.0022 m, 0.0061 rad, 0.0063, none unmatched, 0.2283
  in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from lsd_tpu.detection import eval as jeval
from lsd_tpu.models import detector as jdet
from lsd_tpu.models import quantize as jq
from lsd_tpu.runtime import modules as jmod
from lsd_tpu.training import data as jdata
from lsd_tpu_torch import convert
from lsd_tpu_torch.detection import eval as teval
from lsd_tpu_torch.models import detector as tdet
from lsd_tpu_torch.models import params_io
from lsd_tpu_torch.detection.post import PostProcessConfig
from lsd_tpu_torch.runtime import modules as tmod
from tests.test_torch_detection import _close, _jax_net, _points

CAPS = {"refcap": ("reference_capacity", (-25.6, -25.6, -3.0, 25.6, 25.6, 3.0)),
        "true_refcap": ("true_reference_capacity", (-25.6, -25.6, -2.0, 25.6, 25.6, 4.0))}
WOD_IOUS = {0: 0.7, 1: 0.5, 2: 0.5}
CENTRE_M, HEADING_RAD, SCORE, NEAR_THRESH, AP_TOL = 0.1, 0.05, 0.03, 0.03, 0.01


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("name", ["detector_refcap", "detector_true_refcap"])
def test_reader_equals_flax_on_shipped_files(name):
    path = f"weights/{name}.msgpack"
    with open(path, "rb") as f:
        blob = f.read()
    want = serialization.msgpack_restore(blob)
    _assert_trees_equal(params_io.load_params(path), want)
    _assert_trees_equal(params_io.msgpack_restore(blob), want)
    n_arrays, n_numbers = params_io.count_params(want)
    assert n_arrays == 82 and n_numbers > 3_000_000


def test_reader_equals_flax_on_int8_file(tmp_path):
    params = serialization.msgpack_restore(open("weights/detector_refcap.msgpack", "rb").read())
    path = jq.save_quantized(str(tmp_path / "q.msgpack"), params)
    blob = open(path, "rb").read()
    assert blob[:8] == jq.MAGIC == params_io.MAGIC
    raw = serialization.msgpack_restore(blob[8:])
    _assert_trees_equal(params_io.msgpack_restore(blob[8:]), raw)
    _assert_trees_equal(params_io.load_params(path), jq.dequantize_params(raw))


def test_reader_takes_scalars_lists_and_chunked_arrays():
    arr = np.arange(12, dtype=np.int16).reshape(3, 4)
    tree = {"a": {"b": np.float32(2.5), "c": [1, -3, 2 ** 40, None, True, "x", 1.5]},
            "big": {"__msgpack_chunked_array__": True, "shape": {"0": 3, "1": 4},
                    "chunks": {"0": arr.reshape(-1)[:7], "1": arr.reshape(-1)[7:]}}}
    blob = serialization.msgpack_serialize(tree)
    got = params_io.msgpack_restore(blob)
    want = serialization.msgpack_restore(blob)
    assert got["a"] == want["a"]
    np.testing.assert_array_equal(got["big"], arr)
    np.testing.assert_array_equal(want["big"], arr)


@pytest.mark.parametrize("cap", sorted(CAPS))
def test_converter_both_ways(cap):
    factory, pc_range = CAPS[cap]
    cfg = getattr(jdet.DetectorConfig, factory)()._replace(
        pc_range=tuple(v / 4 if i % 3 < 2 else v for i, v in enumerate(pc_range)))
    tree = params_io.load_params(
        tmod.shipped_detector_weights(getattr(tdet.DetectorConfig, factory)()))
    model = tdet.CenterPointDetector(tdet.DetectorConfig(**cfg._asdict()))
    model.load_state_dict(convert.detector_params_from_flax(tree))
    _assert_trees_equal(convert.detector_params_to_flax(model), tree)

    # a port initialisation, moved to flax, in the reference's float32 network
    twin = tdet.CenterPointDetector(tdet.DetectorConfig(**cfg._asdict()), dtype=torch.float32)
    tdet.init_detector_params(twin, torch.Generator().manual_seed(3))
    flax_tree = convert.detector_params_to_flax(twin)
    ref_init = jax.eval_shape(jdet.CenterPointDetector(cfg).init, jax.random.PRNGKey(0),
                              jnp.zeros((64, 4)), jnp.zeros(64, bool))
    assert jax.tree.map(np.shape, flax_tree) == jax.tree.map(lambda a: a.shape, ref_init)
    pts, mask = _points(2, rng_xy=6.0)
    _, _, _, maps = _jax_net(cfg, flax_tree["params"], pts, mask)
    with torch.no_grad():
        got = twin(torch.as_tensor(pts), torch.as_tensor(mask))
    for k, v in maps.items():
        _close(got[k], v)


def _scenes(n=4):
    scfg = jdata.SyntheticSceneConfig(realistic=True)
    scfg.xy_range = 25.0
    ds = jdata.SyntheticDetectionDataset(scfg, batch_size=2, seed=999)
    return [{k: v[b] for k, v in batch.items()} for batch in ds.batches(n // 2) for b in range(2)]


def _match(jk, tk, thresh):
    """Greedy one-to-one match of kept detections (boxes, scores, labels);
    returns (worst centre, heading, score deviation, unmatched count) and
    raises if an unmatched box is not near its class threshold."""
    worst = [0.0, 0.0, 0.0]
    used = np.zeros(len(tk[0]), bool)
    unmatched = 0
    for b, s, l in zip(*jk):
        d = np.linalg.norm(tk[0][:, :2] - b[:2], axis=1)
        d[used | (tk[2] != l)] = np.inf
        i = int(np.argmin(d)) if len(d) else -1
        if i < 0 or d[i] > CENTRE_M:
            assert abs(s - thresh[l]) <= NEAR_THRESH, f"unmatched box {b} score {s}"
            unmatched += 1
            continue
        used[i] = True
        dh = abs((tk[0][i, 6] - b[6] + np.pi / 2) % np.pi - np.pi / 2)
        worst = [max(worst[0], d[i]), max(worst[1], dh), max(worst[2], abs(tk[1][i] - s))]
    for s, l in zip(tk[1][~used], tk[2][~used]):
        assert abs(s - thresh[l]) <= NEAR_THRESH, f"unmatched port box, score {s}"
        unmatched += 1
    return worst, unmatched


def _ap(evaluate_frames, frames):
    per_class = evaluate_frames(frames, iou_thresh=WOD_IOUS)
    return float(np.mean([m["ap"] for m in per_class.values()]))


@pytest.mark.parametrize("cap", sorted(CAPS))
def test_shipped_checkpoints_agree_at_a_cut_range(cap):
    factory, pc_range = CAPS[cap]
    full = getattr(jdet.DetectorConfig, factory)()
    path = jmod.shipped_detector_weights(full)
    assert path == tmod.shipped_detector_weights(tdet.DetectorConfig(**full._asdict()))
    cfg = full._replace(pc_range=pc_range)
    assert jmod.shipped_detector_weights(cfg) is None
    jfn = jmod.build_detector_predict_fn(weights=path, det_cfg=cfg)
    tfn = tmod.build_detector_predict_fn(weights=path, det_cfg=tdet.DetectorConfig(**cfg._asdict()),
                                         device="cpu")
    thresh = PostProcessConfig().score_thresh
    worst, unmatched, jframes, tframes = np.zeros(3), 0, [], []
    for sc in _scenes():
        jo = [np.asarray(a) for a in jfn(jnp.asarray(sc["points"]), jnp.asarray(sc["mask"]))]
        to = [a.numpy() for a in tfn(sc["points"], sc["mask"])]
        jk = [a[jo[3]] for a in jo[:3]]
        tk = [a[to[3]] for a in to[:3]]
        w, u = _match(jk, tk, thresh)
        worst, unmatched = np.maximum(worst, w), unmatched + u
        gt = dict(gt_boxes=sc["gt_boxes"][sc["gt_mask"]], gt_labels=sc["gt_labels"][sc["gt_mask"]])
        jframes.append(dict(boxes=jk[0], scores=jk[1], labels=jk[2], **gt))
        tframes.append(dict(boxes=tk[0], scores=tk[1], labels=tk[2], **gt))
    ap_j, ap_t = _ap(jeval.evaluate_frames, jframes), _ap(teval.evaluate_frames, tframes)
    assert sum(len(f["boxes"]) for f in jframes) >= 8
    print(f"{cap}: worst centre {worst[0]:.4f} m, heading {worst[1]:.4f} rad, score "
          f"{worst[2]:.4f}, unmatched {unmatched}, mean AP {ap_j:.4f} (JAX) {ap_t:.4f} (port)")
    assert worst[1] <= HEADING_RAD and worst[2] <= SCORE
    assert ap_j > 0.1
    assert abs(ap_t - ap_j) <= AP_TOL


def test_weights_lookup_and_refusal():
    small = tdet.DetectorConfig(pc_range=(-8, -8, -3, 8, 8, 3), voxel_size=(0.5, 0.5, 6.0),
                                max_voxels=64, max_points_per_voxel=2, max_boxes=8)
    assert tmod.shipped_detector_weights(small) is None
    with pytest.raises(ValueError, match="random-init"):
        tmod.build_detector_predict_fn(det_cfg=small, device="cpu")
    fn = tmod.build_detector_predict_fn(det_cfg=small, allow_random_init=True, device="cpu",
                                        with_seg=True)
    pts = np.random.default_rng(0).uniform(-7, 7, (256, 5)).astype(np.float32)
    boxes, scores, labels, keep, seg = fn(pts, np.ones(256, bool))
    assert boxes.shape == (8, 7) and keep.dtype == torch.bool and seg.shape == (*small.head_hw, 1)
    # the random init's heatmap starts near sigmoid(-4.6) ~ 0.01, as flax's
    assert 0.0 < float(scores.max()) < 0.2
    for full in (tdet.DetectorConfig.reference_capacity(),
                 tdet.DetectorConfig.true_reference_capacity()):
        assert tmod.shipped_detector_weights(full) == jmod.shipped_detector_weights(
            getattr(jdet.DetectorConfig, "reference_capacity" if full.s2d_factor == 1
                    else "true_reference_capacity")())


def full_width_mean_ap() -> dict:
    """Both shipped checkpoints at full width, served as each package
    serves them (bf16), on the 16 scenes of the reference's detection
    evaluation (``lsd_tpu/tools/eval_detection.py``: realistic, 60 m, seed
    999, 8 batches of 2), both on the CPU: mean AP at the WOD IoUs from the
    JAX package and from the port, and the kept boxes that both keep but
    that fall on either side of their class's IoU gate in the two (the
    knife edges that move the AP).  ``chip_smoke.py`` holds the port's
    figure on the card against the JAX one.  Too slow for the test run
    (minutes); run it from the repository's root as
    ``python -m tests.test_torch_detector_weights``."""
    import time
    from lsd_tpu.ops.iou3d import boxes_iou3d
    out = {}
    scfg = jdata.SyntheticSceneConfig(realistic=True)
    scfg.xy_range = 60.0
    scenes = [{k: v[b] for k, v in bt.items()}
              for bt in jdata.SyntheticDetectionDataset(scfg, batch_size=2, seed=999).batches(8)
              for b in range(2)]

    def best_iou(boxes, gt):
        if not len(boxes) or not len(gt):
            return np.zeros(len(boxes))
        return np.asarray(boxes_iou3d(jnp.asarray(boxes), jnp.asarray(gt))).max(1)

    for name, factory in (("reference", "reference_capacity"),
                          ("true_reference", "true_reference_capacity")):
        full = getattr(jdet.DetectorConfig, factory)()
        fns = dict(jax=jmod.build_detector_predict_fn(det_cfg=full),
                   port=tmod.build_detector_predict_fn(
                       det_cfg=tdet.DetectorConfig(**full._asdict()), device="cpu"))
        frames, secs, flips = dict(jax=[], port=[]), {}, []
        for pkg, fn in fns.items():
            t0 = time.perf_counter()
            for sc in scenes:
                b, s, l, k = (np.asarray(a) for a in fn(sc["points"], sc["mask"]))
                gm = sc["gt_mask"]
                frames[pkg].append(dict(boxes=b[k], scores=s[k], labels=l[k],
                                        gt_boxes=sc["gt_boxes"][gm],
                                        gt_labels=sc["gt_labels"][gm]))
            secs[pkg] = time.perf_counter() - t0
        for i, (fj, fp) in enumerate(zip(frames["jax"], frames["port"])):
            ij, ip = best_iou(fj["boxes"], fj["gt_boxes"]), best_iou(fp["boxes"], fp["gt_boxes"])
            for b, s, lb, iou in zip(fj["boxes"], fj["scores"], fj["labels"], ij):
                d = np.linalg.norm(fp["boxes"][:, :2] - b[:2], axis=1) if len(fp["boxes"]) \
                    else np.full(1, np.inf)
                j, gate = int(np.argmin(d)), WOD_IOUS[int(lb)]
                if d[j] < 0.5 and (iou >= gate) != (ip[j] >= gate):
                    flips.append(dict(scene=i, label=int(lb), jax_iou=float(iou),
                                      port_iou=float(ip[j]), jax_score=float(s),
                                      port_score=float(fp["scores"][j])))
        aps = {pkg: {k: v["ap"] for k, v in
                     (jeval if pkg == "jax" else teval).evaluate_frames(f, WOD_IOUS).items()}
               for pkg, f in frames.items()}
        out[name] = dict(jax_mean_ap=float(np.mean(list(aps["jax"].values()))),
                         port_cpu_mean_ap=float(np.mean(list(aps["port"].values()))),
                         per_class=aps, kept_boxes={k: sum(len(f["boxes"]) for f in v)
                                                    for k, v in frames.items()},
                         gate_flips=flips, cpu_s=secs)
    return out


if __name__ == "__main__":
    import json
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(full_width_mean_ap(), indent=1))
