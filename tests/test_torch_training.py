"""Port parity: detection training (``lsd_tpu_torch/training/{trainer,data}.py``,
the targets and loss of ``models/detector.py``, ``convert.optimizer_state_*``,
``tools/train.py``) against ``lsd_tpu`` on the same numpy inputs, at a small
grid (+-12.8 m, 0.2 m pillars, 64^2 head maps).

Tolerances:
- ``make_target_maps``, ``make_seg_target`` and ``detection_loss`` (fed the
  same maps): within 1e-6 (relative to each value's largest magnitude; the
  Gaussians' ``exp`` comes from two libraries), a frame without boxes and
  two boxes in one head cell among the inputs; the batched forms equal the
  per-frame ones.
- Gradients of the float32 network (the reference's built from float32
  submodules, as ``tests/test_torch_detection.py`` does) with the
  reference's loss: each leaf within 1e-4 of its largest magnitude
  (measured at most 2.9e-5).
- Five float32 ``Trainer`` steps against five steps of a JAX step built from
  the reference's loss and optax chain (the first update has lr 0, four
  with lr 1e-3 follow): every loss within 1e-4 (relative); each leaf's
  update (its change over the steps) within 2e-2 of the reference's in
  relative norm (measured at most 6.5e-3, cosine above 0.99997), and every
  parameter within 1.5 lr of the reference's (measured 1.04 lr, where the
  updates reach 4 lr).  Adam divides each gradient by its own running RMS,
  so an element whose gradient lies within rounding noise of 0 (the biases
  before a GroupNorm, small kernel entries) moves by up to lr either way.
- The port's bf16 ``Trainer`` against the unmodified JAX ``Trainer``, from the
  same weights on the same batches: each loss within 2e-2 (relative; bf16
  rounds at the same places, but a float32 statistic or sum landing on the
  other side of a rounding spreads through the network).
- Checkpoints: each package's ``load_params`` reads the other's file to the
  bit; ``optimizer_state_{from,to}_optax`` round-trips optax's state to the
  bit, and a run resumed in the port from the reference's mid-schedule
  state follows the reference within the five-step tolerance.
- ``LabeledFrameDataset``: the same batches, to the byte.
- ``Trainer.evaluate`` against the reference's on the same bf16 weights:
  mean AP within 0.05 and the freespace IoU within 5e-3 (measured 7e-4: a
  few logits near 0 round to the other side).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lsd_tpu.models import bev_backbone as jbb
from lsd_tpu.models import center_head as jhead
from lsd_tpu.models import detector as jdet
from lsd_tpu.models import params_io as jio
from lsd_tpu.training import data as jdata
from lsd_tpu.training import trainer as jtrainer
from lsd_tpu_torch import convert
from lsd_tpu_torch.models import detector as tdet
from lsd_tpu_torch.models import params_io as tio
from lsd_tpu_torch.training import data as tdata
from lsd_tpu_torch.training import trainer as ttrainer
from tests.test_torch_detection import _flax_params, _jax_vfe_bev

CFG = jdet.DetectorConfig(pc_range=(-12.8, -12.8, -3.0, 12.8, 12.8, 3.0),
                          voxel_size=(0.2, 0.2, 6.0), max_voxels=2048,
                          max_points_per_voxel=8, max_boxes=64, bev_stride=2)
TCFG = tdet.DetectorConfig(**CFG._asdict())
LR, WARMUP, STEPS = 1e-3, 1, 5
TARGET_REL, GRAD_REL, LOSS_REL, UPDATE_GAP, BF16_LOSS_REL = 1e-6, 1e-4, 1e-4, 2e-2, 2e-2
# a parameter's largest difference from the reference after the steps, in lr
PARAM_LR = 1.5


def _batches(n, seed=3, batch=2):
    """Scenes of the small grid, the second frame of the first batch without
    boxes and the first frame's box 1 moved into box 0's head cell."""
    ds = jdata.SyntheticDetectionDataset(
        jdata.SyntheticSceneConfig(n_boxes=5, points_per_box=96, clutter_points=1500,
                                   xy_range=10.0),
        point_capacity=2 ** 12, box_capacity=8, batch_size=batch, seed=seed)
    out = list(ds.batches(n))
    b = out[0]
    b["gt_mask"][1] = False
    b["gt_boxes"][0, 1, :2] = b["gt_boxes"][0, 0, :2] + 0.05
    return out


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)
    assert err <= rel, (what, err)
    return err


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jax_targets(pts, msk, gb, gl, gm):
    t = jdet.make_target_maps(CFG, gb, gl, gm)
    t["seg"], t["seg_mask"] = jdet.make_seg_target(CFG, pts, msk)
    return t


def test_targets_and_loss_match_jax():
    batch = _batches(1)[0]
    assert batch["gt_mask"][0].sum() >= 2 and not batch["gt_mask"][1].any()
    tb = _t(batch)
    got = tdet.make_target_maps(TCFG, tb["gt_boxes"], tb["gt_labels"], tb["gt_mask"])
    got["seg"], got["seg_mask"] = tdet.make_seg_target(TCFG, tb["points"], tb["mask"])
    rng = np.random.default_rng(0)
    H, W = CFG.head_hw
    preds = dict(heatmap=rng.normal(-3, 2, (H, W, 3)), offset=rng.uniform(0, 1, (H, W, 2)),
                 z=rng.normal(0.8, 0.3, (H, W, 1)), dim=rng.normal(0.5, 0.5, (H, W, 3)),
                 rot=rng.normal(size=(H, W, 2)), seg=rng.normal(size=(H, W, 1)))
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    for b in range(2):
        want = jax.device_get(_jax_targets(*(jnp.asarray(batch[k][b]) for k in (
            "points", "mask", "gt_boxes", "gt_labels", "gt_mask"))))
        one = tdet.make_target_maps(TCFG, tb["gt_boxes"][b], tb["gt_labels"][b],
                                    tb["gt_mask"][b])
        one["seg"], one["seg_mask"] = tdet.make_seg_target(TCFG, tb["points"][b], tb["mask"][b])
        for k, v in want.items():
            _close(got[k][b], v, TARGET_REL, k)
            assert torch.equal(one[k], got[k][b]), k
        wl, waux = jax.device_get(jdet.detection_loss(
            {k: jnp.asarray(v) for k, v in preds.items()}, want))
        gl, gaux = tdet.detection_loss({k: torch.as_tensor(v) for k, v in preds.items()},
                                       {k: v[b] for k, v in got.items()})
        _close(gl, wl, TARGET_REL, "loss")
        for k, v in waux.items():
            _close(gaux[k], v, TARGET_REL, k)
    # the shared cell holds the later box; the frame without boxes has no target
    assert float(got["reg_mask"][0].sum()) == batch["gt_mask"][0].sum() - 1
    assert float(got["reg_mask"][1].sum()) == 0.0 and float(got["heatmap"][1].max()) == 0.0
    # per-frame normalisation: the batched loss is each frame's own
    maps = {k: torch.as_tensor(np.stack([v, v[::-1]])) for k, v in preds.items()}
    losses, _ = tdet.detection_loss(maps, got)
    for b in range(2):
        lb, _ = tdet.detection_loss({k: v[b] for k, v in maps.items()},
                                    {k: v[b] for k, v in got.items()})
        assert torch.allclose(losses[b], lb, rtol=1e-6)


def _jax_apply_f32(params, pts, msk):
    """The reference network in float32: its own submodules with float32
    dtypes (its ``CenterPointDetector`` has no dtype field)."""
    _, bev = _jax_vfe_bev(CFG, params, pts, msk)
    x = jbb.BEVBackbone(strides=(CFG.bev_stride, 2, 2), dtype=jnp.float32).apply(
        {"params": params["BEVBackbone_0"]}, bev)
    return jhead.CenterHead(num_classes=CFG.num_classes, dtype=jnp.float32).apply(
        {"params": params["CenterHead_0"]}, x)


def _jax_loss(params, batch):
    """The reference trainer's ``loss_on_batch`` over the float32 network."""
    def one(pts, msk, gb, gl, gm):
        loss, _ = jdet.detection_loss(_jax_apply_f32(params, pts, msk),
                                      _jax_targets(pts, msk, gb, gl, gm))
        return loss
    return jnp.mean(jax.vmap(one)(batch["points"], batch["mask"], batch["gt_boxes"],
                                  batch["gt_labels"].astype(jnp.int32), batch["gt_mask"]))


TX = optax.chain(optax.clip_by_global_norm(10.0),
                 optax.adamw(optax.warmup_cosine_decay_schedule(0.0, LR, WARMUP, 100),
                             weight_decay=1e-4))


@jax.jit
def _jax_step(params, opt_state, batch):
    loss, grads = jax.value_and_grad(_jax_loss)(params, batch)
    updates, opt_state = TX.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss, grads


@functools.lru_cache(maxsize=1)
def _start():
    return jax.device_get(_flax_params(CFG))


def _f32_trainer(params):
    tr = ttrainer.Trainer(TCFG, ttrainer.TrainerConfig(lr=LR, warmup_steps=WARMUP,
                                                       total_steps=100),
                          device="cpu", dtype=torch.float32)
    tr.model.load_state_dict(convert.detector_params_from_flax({"params": params}))
    return tr


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def test_float32_gradients_match_jax():
    params = _start()
    batch = _batches(1)[0]
    *_, grads = jax.device_get(_jax_step(params, TX.init(params),
                                         {k: jnp.asarray(v) for k, v in batch.items()}))
    tr = _f32_trainer(params)
    loss, _ = tr.loss_on_batch(_t(batch))
    loss.backward()
    got = convert.detector_params_to_flax(
        tr.model, {n: p.grad for n, p in tr.model.named_parameters()})["params"]
    want, mine = _leaves(grads), _leaves(got)
    assert want.keys() == mine.keys() and len(want) > 40
    worst = max(_close(mine[k], v, GRAD_REL, jax.tree_util.keystr(k)) for k, v in want.items())
    assert worst < GRAD_REL


def _run_jax(params, state, batches):
    losses = []
    for b in batches:
        params, state, loss, _ = _jax_step(params, state, {k: jnp.asarray(v)
                                                           for k, v in b.items()})
        losses.append(float(loss))
    return jax.device_get(params), state, losses


def _check_params(tr, want, start):
    """Each leaf's update against the reference's: relative norm gap and the
    largest difference in units of lr."""
    mine, first = _leaves(convert.detector_params_to_flax(tr.model)["params"]), _leaves(start)
    for k, v in _leaves(want).items():
        ours, theirs = mine[k] - first[k], v - first[k]
        gap = float(np.linalg.norm(ours - theirs) / np.linalg.norm(theirs))
        assert gap <= UPDATE_GAP, (jax.tree_util.keystr(k), gap)
        assert float(np.abs(mine[k] - v).max()) <= PARAM_LR * LR, jax.tree_util.keystr(k)


def test_float32_trainer_steps_match_jax(default_torch_threads):
    params = _start()
    batches = _batches(STEPS)
    want, _, want_losses = _run_jax(params, TX.init(params), batches)
    tr = _f32_trainer(params)
    losses = [float(tr.train_step(_t(b))[0]) for b in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_REL)
    _check_params(tr, want, params)
    assert tr.step == STEPS and tr.opt.count == STEPS


def test_optimizer_state_round_trip_and_resume():
    params = _start()
    batches = _batches(STEPS)
    mid, state, _ = _run_jax(params, TX.init(params), batches[:3])
    tr = _f32_trainer(mid)
    ours = convert.optimizer_state_from_optax(jax.device_get(state), tr.model)
    assert ours["count"] == ours["schedule_count"] == 3
    back = convert.optimizer_state_to_optax(ours, tr.model)
    # the reference trainer's trees carry the {"params": ...} level; this
    # test's JAX step runs on the inner tree
    adam = dict(back[1][0], mu=back[1][0]["mu"]["params"], nu=back[1][0]["nu"]["params"])
    rebuilt = (optax.EmptyState(), (optax.ScaleByAdamState(**adam), optax.EmptyState(),
                                    optax.ScaleByScheduleState(**back[1][2])))
    a, b = jax.tree_util.tree_flatten(jax.device_get(state)), jax.tree_util.tree_flatten(rebuilt)
    assert a[1] == b[1]
    for x, y in zip(a[0], b[0]):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # resume in the port from the reference's mid-schedule state
    tr.opt.load_state_dict(ours)
    want, state, want_losses = _run_jax(mid, state, batches[3:])
    losses = [float(tr.train_step(_t(b))[0]) for b in batches[3:]]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_REL)
    _check_params(tr, want, mid)
    # and back: the port's state resumes the reference
    moved = convert.optimizer_state_to_optax(tr.opt.state_dict(), tr.model)
    assert int(moved[1][0]["count"]) == STEPS


def test_bf16_trainer_losses_match_the_reference_trainer():
    jtr = jtrainer.Trainer(det_cfg=CFG, cfg=jtrainer.TrainerConfig(
        lr=LR, warmup_steps=WARMUP, total_steps=100, log_every=1000))
    tr = ttrainer.Trainer(TCFG, ttrainer.TrainerConfig(lr=LR, warmup_steps=WARMUP,
                                                       total_steps=100), device="cpu")
    tr.model.load_state_dict(convert.detector_params_from_flax(jax.device_get(jtr.params)))
    want, got = [], []
    for b in _batches(3, seed=11):
        jtr.params, jtr.opt_state, loss, _ = jtr._train_step(
            jtr.params, jtr.opt_state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(loss))
        got.append(float(tr.train_step(_t(b))[0]))
    np.testing.assert_allclose(got, want, rtol=BF16_LOSS_REL)


def test_checkpoints_load_in_both_directions(tmp_path):
    params = {"params": _start()}
    ref_path = str(tmp_path / "ref.msgpack")
    jio.save_params(ref_path, params)
    tr = ttrainer.Trainer(TCFG, device="cpu")
    tr.load(ref_path)
    port_path = tr.save(str(tmp_path / "port.msgpack"))
    back = jio.load_params(port_path, jax.tree.map(np.zeros_like, params))
    for k, v in _leaves(params).items():
        np.testing.assert_array_equal(np.asarray(_leaves(back)[k]), v)
    assert open(port_path, "rb").read() == open(ref_path, "rb").read()
    ours = tio.load_params(ref_path)
    assert jax.tree.structure(ours) == jax.tree.structure(jax.device_get(params))


def test_labeled_frame_dataset_matches_jax(tmp_path):
    from lsd_tpu_torch.io.recorder import FrameRecorder
    from tests.test_io import make_frame_dict
    rec = FrameRecorder(str(tmp_path / "rec"))
    rng = np.random.default_rng(4)
    for k in range(7):
        d = make_frame_dict(ts=1000000 + k * 100000)
        if k != 2:                      # a frame without labels is skipped
            n = int(rng.integers(0, 4))
            d["gt_boxes"] = rng.normal(size=(n, 7)).astype(np.float32)
            d["gt_labels"] = rng.integers(0, 3, n).astype(np.int32)
        rec.write(d)
    kw = dict(point_capacity=2048, box_capacity=4, batch_size=2, seed=3)
    ref = jdata.LabeledFrameDataset(rec.log_dir, **kw)
    got = tdata.LabeledFrameDataset(rec.log_dir, **kw)
    assert len(got) == len(ref) == 6
    a, b = list(ref.batches(epochs=2)), list(got.batches(epochs=2))
    assert len(a) == len(b) == 6
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes(), k


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    from lsd_tpu_torch.tools import train
    out = str(tmp_path / "w.msgpack")
    assert train.main(["--steps", "2", "--batch", "1", "--eval-batches", "1",
                       "--device", "cpu", "--out", out]) == 0
    assert "trained 2 steps" in capsys.readouterr().out
    assert tio.load_params(out)["params"].keys() == {"PillarVFE_0", "BEVBackbone_0",
                                                     "CenterHead_0"}
    # data-parallel on two gloo ranks; a card per rank is asked for otherwise
    out2 = str(tmp_path / "w2.msgpack")
    assert train.main(["--steps", "2", "--batch", "2", "--eval-batches", "1", "--mesh-dp", "2",
                       "--device", "cpu", "--out", out2]) == 0
    assert tio.load_params(out2)["params"].keys() == tio.load_params(out)["params"].keys()
    with pytest.raises(RuntimeError, match="2 NCCL ranks need 2 cards, this host has 0"):
        train.main(["--mesh-dp", "2", "--batch", "2"])
    with pytest.raises(ValueError, match="--batch 3 does not split over --mesh-dp 2"):
        train.main(["--mesh-dp", "2", "--batch", "3", "--device", "cpu"])


def test_evaluate_matches_the_reference_trainer():
    jtr = jtrainer.Trainer(det_cfg=CFG, cfg=jtrainer.TrainerConfig(log_every=1000))
    jtr.params = {"params": _start()}
    tr = _f32_trainer(_start())
    tr.model = tdet.CenterPointDetector(TCFG)            # bf16, as the reference's
    tr.model.load_state_dict(convert.detector_params_from_flax(jtr.params))
    batches = _batches(2, seed=8)
    want = jtr.evaluate(batches, score_thresh=0.05)
    got = tr.evaluate(batches, score_thresh=0.05)
    # bf16 in both: a few freespace logits near 0 fall on the other side
    assert abs(got["seg_iou"] - want["seg_iou"]) <= 5e-3
    assert got["per_class"].keys() == want["per_class"].keys()
    assert abs(got["mean_ap"] - want["mean_ap"]) <= 0.05
