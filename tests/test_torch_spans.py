"""The port's spans (``lsd_tpu_torch/utils/spans.py``) on the CPU, under a
CPU-only ``torch.profiler``: the LIO step's and the detection stage's span
names and nesting, the shared null context when no profiler records, and
results that do not depend on whether one does."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lsd_tpu_torch.models.detector import DetectorConfig
from lsd_tpu_torch.runtime.modules import build_detector_predict_fn
from lsd_tpu_torch.sim import CircleSim, SimConfig
from lsd_tpu_torch.slam.lio import LioConfig, lio_init, lio_step
from lsd_tpu_torch.tools.profile_detector import detect_module, frame_dict
from lsd_tpu_torch.tools.profile_lio import nav_at_start
from lsd_tpu_torch.utils.spans import NO_SPAN, span

CPU = torch.device("cpu")
LIO_CFG = LioConfig(ds_capacity=1024, map_capacity=2 ** 13, max_iters=3)
# each LIO span and the span it nests in directly (None: outermost)
LIO_SPANS = {
    "lio_step/front": None,
    "lio_step/front/propagate": "lio_step/front",
    "lio_step/front/undistort": "lio_step/front",
    "lio_step/front/downsample": "lio_step/front",
    "lio_step/front/match": "lio_step/front",
    "lio_step/iterate": None,
    "lio_step/iterate/research": "lio_step/iterate",
    "lio_step/iterate/gate": "lio_step/iterate",
    "lio_step/covariance": None,
    "lio_step/map_update": None,
}
DETECT_STAGE = ("detect/parse", "detect/accumulate", "detect/upload", "detect/fetch",
                "detect/freespace", "detect/tracker")
DETECT_MODEL = ("detect/voxelize", "detect/vfe", "detect/scatter", "detect/backbone",
                "detect/head", "detect/decode", "detect/nms")
SMALL_DET = DetectorConfig(pc_range=(-8, -8, -3, 8, 8, 3), voxel_size=(0.5, 0.5, 6.0),
                           max_voxels=256, max_points_per_voxel=4, max_boxes=16)


def spans_of(prof, prefix):
    """(name, name of the innermost enclosing span with ``prefix``) of each
    span with ``prefix`` in ``prof``'s events."""
    out = []
    for e in prof.events():
        if not e.name.startswith(prefix):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(prefix):
            p = p.cpu_parent
        out.append((e.name, None if p is None else p.name))
    return out


@pytest.fixture(scope="module")
def lio_run():
    sim = CircleSim(SimConfig(n_scans=2, points_per_scan=2048, point_noise=0.01, seed=5))
    scans = [[torch.as_tensor(a) for a in d[:5]] for d in sim.generate(capacity=2048)]
    st0 = lio_init(LIO_CFG, nav_at_start(sim, CPU))

    def steps():
        st, poses = st0, []
        for scan in scans:
            st, info = lio_step(LIO_CFG, st, *scan)
            poses.append(info["pose"])
        return torch.stack(poses), st.P
    return steps


def test_lio_step_spans_and_nesting(lio_run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lio_run()
    got = spans_of(prof, "lio_step/")
    names = [n for n, _ in got]
    assert set(names) == set(LIO_SPANS) - ({"lio_step/iterate/research"} - set(names))
    assert all(LIO_SPANS[n] == parent for n, parent in got), got
    for n in set(LIO_SPANS) - {"lio_step/iterate/research", "lio_step/iterate/gate"}:
        assert names.count(n) == 2, n
    assert names.count("lio_step/iterate/gate") == 2 * LIO_CFG.max_iters
    assert names.count("lio_step/iterate/research") <= 2 * (LIO_CFG.max_iters - 1)


@pytest.fixture(scope="module")
def detect_run():
    predict = build_detector_predict_fn(det_cfg=SMALL_DET, with_seg=True,
                                        allow_random_init=True, device=CPU)
    rng = np.random.default_rng(3)
    motion = np.eye(4)
    motion[0, 3] = 0.5
    dicts = []
    for k in range(2):
        pts = np.concatenate([rng.uniform(-7.5, 7.5, (2048, 2)), rng.uniform(-1.5, 1.5, (2048, 1)),
                              rng.uniform(0, 1, (2048, 1))], axis=1).astype(np.float32)
        dicts.append(frame_dict(pts, np.ones(len(pts), bool), motion if k else None, k))

    def frames():
        outputs = []

        def recorded(points, mask):
            out = predict(points, mask)
            outputs.append(out)
            return out
        module = detect_module(recorded, SMALL_DET, CPU)
        objects = [module.process(dict(d))["objects"] for d in dicts]
        return outputs, objects
    return frames


def test_detect_module_spans(detect_run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        detect_run()
    got = spans_of(prof, "detect/")
    assert {n for n, _ in got} == set(DETECT_STAGE + DETECT_MODEL)
    for n in DETECT_STAGE:
        assert [g for g in got if g[0] == n] == [(n, None)] * 2


# DSVT-Pillar's spans inside ``detect/dsvt`` and their count a frame
DSVT_SPANS = {"detect/dsvt": (None, 1), "detect/dsvt/partition": ("detect/dsvt", 1),
              "detect/dsvt/posembed": ("detect/dsvt", 4),
              "detect/dsvt/attention": ("detect/dsvt", 8), "detect/dsvt/ffn": ("detect/dsvt", 8)}


def test_dsvt_spans_and_nesting():
    cfg = DetectorConfig.dsvt_pillar()._replace(pc_range=(-5.12, -5.12, -2.0, 5.12, 5.12, 4.0),
                                                max_voxels=256)
    predict = build_detector_predict_fn(det_cfg=cfg, with_seg=True, allow_random_init=True,
                                        device=CPU)
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.uniform(-5, 5, (1024, 2)), rng.uniform(-1.5, 1.5, (1024, 1)),
                          rng.uniform(0, 1, (1024, 1))], axis=1).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        predict(pts, np.ones(len(pts), bool))
    got = spans_of(prof, "detect/dsvt")
    for name, (parent, count) in DSVT_SPANS.items():
        assert [g for g in got if g[0] == name] == [(name, parent)] * count, name
    names = {n for n, _ in spans_of(prof, "detect/")}
    assert names == set(DSVT_SPANS) | {"detect/upload", "detect/voxelize", "detect/vfe",
                                       "detect/scatter", "detect/backbone", "detect/head",
                                       "detect/decode", "detect/nms"}


def test_span_is_the_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert span("lio_step/front") is NO_SPAN and span("detect/parse") is NO_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("lio_step/front") is not NO_SPAN


def test_results_do_not_depend_on_the_profiler(lio_run, detect_run):
    poses, P = lio_run()
    outputs, objects = detect_run()
    with profile(activities=[ProfilerActivity.CPU]):
        poses_p, P_p = lio_run()
        outputs_p, objects_p = detect_run()
    assert torch.equal(poses, poses_p) and torch.equal(P, P_p)
    for a, b in zip(outputs, outputs_p, strict=True):
        assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True))
    for a, b in zip(objects, objects_p, strict=True):
        assert [o["id"] for o in a] == [o["id"] for o in b]
        assert all(np.array_equal(x["box"], y["box"]) for x, y in zip(a, b))
