"""Port parity for the scoring path: ``detection/eval.py:evaluate_mot``,
``tools/{campaign,export_replay,evaluate,eval_detection,loc_eval}.py`` and
``models/quantize.py``'s round trip, against ``lsd_tpu`` on the CPU.

- ``evaluate_mot``: the integer fields equal; ``amota``, ``amotp``,
  ``mota`` and ``motp`` within 1e-6 (one float32 IoU, host sums).
- ``make_recording`` and ``export_replay``: the files byte-equal.
- The int8 round trip (``dequantize_params(quantize_params(tree))``):
  equal.
- ``run_tpu_lio`` on ``tests/test_robustness.py``'s tunnel (with and
  without the wheelspeed observation) and corridor, at that test's size:
  ATE within 1e-4 m of JAX's, ``n_degenerate`` equal on every scan.  The
  reference's runner fixes its capacities (16,384 / 2**18); both runners
  here get ``tests/test_robustness.py``'s (2,048 / 2**15) through their
  package's ``LioConfig``.
- ``evaluate_frames`` with per-class IoU gates, as ``eval_detection``
  passes them through ``Trainer.evaluate``: APs within 1e-6 of the
  reference's; a dict gate is each class's scalar gate (also through
  ``Trainer.evaluate``).

``tests/test_torch_loc_eval.py`` runs ``tools/loc_eval.py`` itself.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import lsd_tpu.slam as jslam
import lsd_tpu_torch.slam as tslam
from lsd_tpu import sim as jsim
from lsd_tpu.detection import eval as jeval
from lsd_tpu.models import quantize as jquant
from lsd_tpu.tools import campaign as jcampaign
from lsd_tpu.tools import evaluate as jevaluate
from lsd_tpu.tools import export_replay as jexport
from lsd_tpu_torch import sim as tsim
from lsd_tpu_torch.detection import eval as teval
from lsd_tpu_torch.models import quantize as tquant
from lsd_tpu_torch.tools import campaign as tcampaign
from lsd_tpu_torch.tools import campaign_session as tsession
from lsd_tpu_torch.tools import evaluate as tevaluate
from lsd_tpu_torch.tools import export_replay as texport

MOT_ATOL, ATE_ATOL = 1e-6, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's processes share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _box(x, y, heading=0.0, size=(4.0, 2.0, 1.6)):
    return [x, y, 0.0, *size, heading]


def _mot_frames(case):
    """Tracked frames: the reference test's three cases, and a seeded drive
    of several objects with noisy boxes, misses, false positives, id
    switches and spread scores."""
    frames = []
    if case in ("perfect", "id_switch", "misses_fp"):
        for k in range(10):
            tid = 8 if case == "id_switch" and k >= 5 else 7
            frames.append(dict(gt_ids=np.asarray([1]), gt_boxes=np.asarray([_box(k, 0)]),
                               track_ids=np.asarray([tid]),
                               boxes=np.asarray([_box(k + 0.1, 0)]), scores=np.asarray([0.9])))
        if case == "misses_fp":
            frames[3].update(track_ids=np.zeros(0, np.int64), boxes=np.zeros((0, 7)),
                             scores=np.zeros(0))
            frames[4].update(track_ids=np.asarray([7, 99]),
                             boxes=np.asarray([_box(4.1, 0), _box(50, 50)]),
                             scores=np.asarray([0.9, 0.9]))
        return frames
    rng = np.random.default_rng(21)
    starts = rng.uniform(-30, 30, (6, 2))
    vel = rng.normal(0, 1.0, (6, 2))
    for k in range(25):
        gt = np.asarray([_box(*(s + v * 0.1 * k), heading=0.1 * i)
                         for i, (s, v) in enumerate(zip(starts, vel))])
        keep = rng.random(6) > 0.15                      # misses
        boxes = gt[keep].copy()
        boxes[:, :2] += rng.normal(0, 0.3, (len(boxes), 2))
        tids = np.flatnonzero(keep) + (100 if k >= 12 else 0) * (np.flatnonzero(keep) == 2)
        fp = rng.uniform(-40, 40, (int(rng.integers(0, 3)), 2))
        boxes = np.concatenate([boxes, [_box(*p) for p in fp]]) if len(fp) else boxes
        tids = np.concatenate([tids, 500 + k * 10 + np.arange(len(fp))])
        frames.append(dict(gt_ids=np.arange(6), gt_boxes=gt, track_ids=tids, boxes=boxes,
                           scores=rng.uniform(0.1, 1.0, len(tids))))
    return frames


@pytest.mark.parametrize("case", ["perfect", "id_switch", "misses_fp", "drive"])
def test_evaluate_mot_matches_reference(case):
    frames = _mot_frames(case)
    want, got = jeval.evaluate_mot(frames), teval.evaluate_mot(frames)
    assert got.keys() == want.keys()
    for k in ("ids", "misses", "false_pos", "n_gt", "tp"):
        assert got[k] == want[k], k
    for k in ("amota", "amotp", "mota", "motp", "recall"):
        assert abs(got[k] - want[k]) <= MOT_ATOL, (k, got[k], want[k])
    if case == "drive":
        assert got["ids"] >= 1 and got["misses"] > 0 and got["false_pos"] > 0


def test_evaluate_mot_without_frames():
    assert teval.evaluate_mot([]) == jeval.evaluate_mot([])


def _fig8(mod, n_scans=6):
    return mod.FigureEightSim(mod.SimConfig(radius=8.0, speed=5.0, n_scans=n_scans,
                                            points_per_scan=2048, point_noise=0.01, seed=7,
                                            rest_time=0.2, ramp_time=0.2),
                              laps=0.2, gps_noise=0.05, gps_outlier_rate=0.3, gps_hz=10.0)


def test_make_recording_is_byte_equal(tmp_path):
    want = jcampaign.make_recording(_fig8(jsim), str(tmp_path / "jax"), t_start=0.3,
                                    n_scans=6, capacity=2048)
    got = tcampaign.make_recording(_fig8(tsim), str(tmp_path / "port"), t_start=0.3,
                                   n_scans=6, capacity=2048)
    for k in ("gt", "ts_us"):
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
    names = sorted(os.listdir(want["log_dir"]))
    assert names == sorted(os.listdir(got["log_dir"])) and len(names) == 6
    for name in names:
        with open(os.path.join(want["log_dir"], name), "rb") as a, \
                open(os.path.join(got["log_dir"], name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(got["log_dir"], names[0]), "rb") as fh:
        assert pickle.load(fh)["ins_valid"]
    # an existing complete recording is reused, not written again
    again = tcampaign.make_recording(_fig8(tsim), str(tmp_path / "port"), t_start=0.3,
                                     n_scans=6, capacity=2048)
    assert again["log_dir"] == got["log_dir"]
    assert len(os.listdir(tmp_path / "port")) == 2       # the log dir and gt.npz


def test_export_replay_is_byte_equal(tmp_path):
    cfg = dict(n_scans=3, points_per_scan=512, point_noise=0.01, seed=7,
               rest_time=0.1, ramp_time=0.1)
    jexport.export_replay(str(tmp_path / "j.bin"), jsim.CircleSim(jsim.SimConfig(**cfg)),
                          capacity=512)
    texport.export_replay(str(tmp_path / "t.bin"), tsim.CircleSim(tsim.SimConfig(**cfg)),
                          capacity=512)
    for suffix in ("", ".gt.npy"):
        assert (tmp_path / f"j.bin{suffix}").read_bytes() == \
            (tmp_path / f"t.bin{suffix}").read_bytes()


def test_int8_round_trip_matches_reference():
    rng = np.random.default_rng(4)
    tree = {"params": {"conv": {"kernel": rng.normal(size=(3, 3, 8, 16)).astype(np.float32),
                                "bias": rng.normal(size=16).astype(np.float32)},
                       "dense": {"kernel": rng.normal(size=(16, 4)).astype(np.float32)}}}
    want = jquant.dequantize_params(jquant.quantize_params(tree))
    got = tquant.dequantize_params(tquant.quantize_params(tree))
    for path in (("conv", "kernel"), ("conv", "bias"), ("dense", "kernel")):
        a, b = want["params"][path[0]][path[1]], got["params"][path[0]][path[1]]
        assert a.dtype == b.dtype and np.array_equal(a, b), path


@pytest.fixture
def small_lio(monkeypatch):
    """Both runners at ``tests/test_robustness.py``'s capacities, and each
    lio_step's pose and degenerate-direction count kept, per package."""
    seen = {"jax": [], "port": []}
    for key, mod in (("jax", jslam), ("port", tslam)):
        cfg, step = mod.LioConfig, mod.lio_step

        def small(cfg=cfg, **kw):
            return cfg(**{**kw, "ds_capacity": 2048, "map_capacity": 2 ** 15})

        def kept(*args, step=step, key=key, **kw):
            st, info = step(*args, **kw)
            seen[key].append(int(info["n_degenerate"]))
            return st, info
        monkeypatch.setattr(mod, "LioConfig", small)
        monkeypatch.setattr(mod, "lio_step", kept)
    return seen


@pytest.mark.parametrize("scenario", ["tunnel", "tunnel_wheelspeed", "corridor"])
def test_run_tpu_lio_matches_reference(scenario, small_lio):
    density = 1.0 if scenario == "corridor" else 0.0
    seed = 5 if scenario == "corridor" else 6
    sim = jsim.CorridorSim(jsim.SimConfig(n_scans=18, points_per_scan=4096, point_noise=0.01,
                                          seed=seed, feature_density=density,
                                          rest_time=0.3, ramp_time=0.3))
    data = sim.generate(capacity=4096, imu_capacity=16)
    ws = scenario == "tunnel_wheelspeed"
    want = jevaluate.run_tpu_lio(sim, data, 6, wheelspeed=ws)
    got = tevaluate.run_tpu_lio(sim, data, 6, wheelspeed=ws, device="cpu")
    assert abs(got[0] - want[0]) <= ATE_ATOL, (got, want)
    assert got[2] == want[2]
    assert len(small_lio["port"]) == len(data) and small_lio["port"] == small_lio["jax"]
    if scenario == "tunnel":
        # x is unobservable: the gate fires in the smooth tunnel
        assert max(small_lio["port"]) >= 1, small_lio["port"]


def test_evaluate_cli_prints_the_table(small_lio, capsys):
    rows = tevaluate.main(["--cpu", "--skip-reference", "--scans", "29", "--points", "1024"])
    assert [r["scenario"] for r in rows] == ["circle", "high_yaw", "corridor", "tunnel",
                                             "tunnel_wheelspeed", "imu_bias"]
    assert all(np.isfinite(r["tpu_ate_m"]) and r["ref_ate_m"] is None for r in rows)
    assert "| tunnel_wheelspeed | 29 |" in capsys.readouterr().out


def test_evaluate_frames_takes_per_class_thresholds():
    """The per-class gates ``eval_detection`` passes (``WOD_IOUS``; a class
    the dict does not name is gated at 0.7): the same APs as the
    reference's, and each class's AP that of its own scalar gate."""
    from lsd_tpu_torch.tools.eval_detection import WOD_IOUS
    rng = np.random.default_rng(12)
    frames = []
    for _ in range(6):
        gt = np.asarray([_box(*rng.uniform(-30, 30, 2)) for _ in range(8)])
        labels = rng.integers(0, 4, 8)
        boxes = gt.copy()
        boxes[:, 0] += rng.uniform(0.0, 1.2, 8)            # IoUs from ~1 to ~0.4
        frames.append(dict(boxes=boxes, scores=rng.random(8), labels=labels,
                           gt_boxes=gt, gt_labels=labels))
    want = jeval.evaluate_frames(frames, iou_thresh=WOD_IOUS)
    got = teval.evaluate_frames(frames, iou_thresh=WOD_IOUS)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for lbl in got:
        assert abs(got[lbl]["ap"] - want[lbl]["ap"]) <= MOT_ATOL
        alone = teval.evaluate_frames(frames, iou_thresh=WOD_IOUS.get(lbl, 0.7))[lbl]
        assert alone["ap"] == got[lbl]["ap"]
    assert got[0]["ap"] != teval.evaluate_frames(frames, iou_thresh=0.5)[0]["ap"]


def test_trainer_evaluate_takes_per_class_thresholds():
    from lsd_tpu_torch.tools.eval_detection import WOD_IOUS
    from tests.test_torch_training import _batches, _f32_trainer, _start
    tr = _f32_trainer(_start())
    batches = _batches(2, seed=8)
    got = tr.evaluate(batches, score_thresh=0.05, iou_thresh=WOD_IOUS)
    assert got["per_class"]
    for lbl, ap in got["per_class"].items():
        alone = tr.evaluate(batches, score_thresh=0.05, iou_thresh=WOD_IOUS.get(lbl, 0.7))
        assert alone["per_class"][lbl] == ap


def test_campaign_merge_waits_for_a13():
    for main in (tcampaign.main, tsession.main):
        with pytest.raises(NotImplementedError, match="A13"):
            main([])
