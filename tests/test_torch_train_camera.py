"""Port parity: training of the camera models (``lsd_tpu_torch/training/{mono3d,yolo}.py``,
``models/mono3d.py``'s targets and loss, ``tools/train_{mono3d,yolo}.py``)
against ``lsd_tpu`` on the same numpy inputs.

Tolerances:
- Mono3D's ``t_*`` maps: equal (the same numpy code on the same scenes).
- ``mono3d_loss`` and ``yolo_loss`` fed the same maps: within 1e-6
  (relative); ``make_yolo_targets``: equal, two boxes in one cell, a masked
  box and a frame without boxes among the inputs, one frame or a batch.
- Five steps of ``Mono3DTrainer`` against the reference's, both float32 at
  the ``--small`` config (96 x 160, ``base_ch=8``), from the same weights on
  the same batches: every loss within 1e-4 (relative); each leaf's update
  within 2e-2 of the reference's in relative norm, and every parameter
  within 1.5 times the sum of the steps' learning rates (Adam moves an
  element whose gradient lies within rounding noise of 0 by up to lr either
  way; ``tests/test_torch_training.py`` says more).
- ``YoloTrainer`` against the reference's, bf16 in both, 4 classes at
  128 x 160: each loss of three steps within 2e-2 (relative; bf16 rounds at
  the same places, but a float32 statistic landing on the other side of a
  rounding spreads through seven blocks); the first step's gradients, per
  leaf, with cosine similarity at least YOLO_GRAD_COS = 0.999 to the
  reference's and a relative norm gap at most YOLO_GRAD_GAP = 0.05
  (measured over two seeds: 0.99983 and 0.0189; ``chip_smoke.py`` holds the
  card to the CPU with the same bars).  Not held to them: the bias of each
  ConvBlock's convolution, which a GroupNorm follows.  The norm subtracts
  each group's mean, so the exact gradient of that bias is 0 where a group
  is one channel (ConvBlock_0) and nearly cancels elsewhere; what either
  package computes there is mostly bf16 rounding (measured cosines -0.12 to
  0.9995 between the packages).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.models import mono3d as jm
from lsd_tpu.models import yolo2d as jy
from lsd_tpu.training import mono3d as jtm
from lsd_tpu.training import yolo as jty
from lsd_tpu_torch import convert
from lsd_tpu_torch.models import mono3d as tm
from lsd_tpu_torch.models import yolo2d as ty
from lsd_tpu_torch.training import camera_data as tdata
from lsd_tpu_torch.training import mono3d as ttm
from lsd_tpu_torch.training import yolo as tty

SMALL_HW, YOLO_HW = (96, 160), (128, 160)
LOSS_REL, TARGET_REL, UPDATE_GAP, PARAM_LR, BF16_LOSS_REL = 1e-4, 1e-6, 2e-2, 1.5, 2e-2
YOLO_GRAD_COS, YOLO_GRAD_GAP = 0.999, 0.05


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)


def _mono3d_batches(n, seed=5):
    return list(jtm.SyntheticMono3DDataset(jtm.Mono3DSceneConfig(hw=SMALL_HW, max_objects=4),
                                           batch_size=2, seed=seed).batches(n))


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_mono3d_targets_equal_jax():
    cfg = jtm.Mono3DSceneConfig(hw=SMALL_HW, max_objects=4)
    ref = jtm.SyntheticMono3DDataset(cfg, batch_size=3, seed=2).batch()
    got = tdata.SyntheticMono3DDataset(tdata.Mono3DSceneConfig(hw=SMALL_HW, max_objects=4),
                                       batch_size=3, seed=2).batch()
    assert got.keys() == ref.keys() and {"t_heat", "t_mask"} <= set(got)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    K = tdata.default_intrinsic(SMALL_HW)
    boxes = np.asarray([[1.0, 1.2, 12.0, 4.0, 1.8, 1.5, 0.3], [-2.0, 1.0, 0.05, 1, 1, 1, 0],
                        [50.0, 1.0, 10.0, 1, 1, 1, 0]], np.float32)   # behind, off-image
    a = jm.make_mono3d_targets(jm.Mono3DConfig(image_hw=SMALL_HW), boxes, [0, 1, 2], K)
    b = tm.make_mono3d_targets(tm.Mono3DConfig(image_hw=SMALL_HW), boxes, [0, 1, 2], K)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert b["mask"].sum() == 1


def test_mono3d_loss_matches_jax():
    batch = _mono3d_batches(1)[0]
    rng = np.random.default_rng(0)
    H, W = SMALL_HW[0] // 4, SMALL_HW[1] // 4
    preds = {k: rng.normal(size=(2, H, W, ch or 4)).astype(np.float32) for k, ch in tm.HEADS}
    preds["heat"] -= 3.0
    t = {k: batch["t_" + k] for k in ttm.TARGETS}
    losses, aux = tm.mono3d_loss({k: torch.as_tensor(v) for k, v in preds.items()},
                                 {k: torch.as_tensor(v) for k, v in t.items()})
    for b in range(2):
        wl, waux = jax.device_get(jm.mono3d_loss({k: jnp.asarray(v[b]) for k, v in preds.items()},
                                                 {k: jnp.asarray(v[b]) for k, v in t.items()}))
        assert _rel(losses[b], wl) <= TARGET_REL
        for k, v in waux.items():
            assert _rel(aux[k][b], v) <= TARGET_REL, k


def _check_updates(model, to_flax, start, want, lr_sum):
    mine = _leaves(to_flax(model))
    first, theirs = _leaves(start), _leaves(want)
    assert mine.keys() == theirs.keys()
    for k, v in theirs.items():
        ours, ref = mine[k] - first[k], v - first[k]
        gap = float(np.linalg.norm(ours - ref) / max(np.linalg.norm(ref), 1e-30))
        assert gap <= UPDATE_GAP, (k, gap)
        assert float(np.abs(mine[k] - v).max()) <= PARAM_LR * lr_sum, k


def test_mono3d_trainer_steps_match_jax():
    cfg = jm.Mono3DConfig(image_hw=SMALL_HW, base_ch=8)
    jtr = jtm.Mono3DTrainer(cfg, lr=1e-2, total_steps=200)
    start = jax.device_get(jtr.params)
    tr = ttm.Mono3DTrainer(tm.Mono3DConfig(**cfg._asdict()), lr=1e-2, total_steps=200,
                           device="cpu")
    convert.load_camera_params(tr.model, start)
    want, got = [], []
    for b in _mono3d_batches(5, seed=7):
        jtr.params, jtr.opt_state, loss, _ = jtr._step(
            jtr.params, jtr.opt_state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(loss))
        got.append(float(tr.train_step(tr.upload(b))[0]))
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    lr_sum = sum(tr.opt.lr_at(k) for k in range(5))
    _check_updates(tr.model, convert.camera_params_to_flax, start, jax.device_get(jtr.params),
                   lr_sum)


def _yolo_boxes():
    """Two frames: three lights, the second in the first's cell, the third
    masked; then a frame without boxes."""
    gb = np.zeros((2, 4, 4), np.float32)
    gb[0, 0] = [20, 30, 38, 80]
    gb[0, 1] = [22, 28, 36, 85]                 # the same stride-16 cell as box 0
    gb[0, 2] = [100, 10, 120, 70]
    gb[0, 3] = [60, 40, 75, 100]                # masked
    gl = np.asarray([[1, 2, 0, 3], [0, 0, 0, 0]], np.int32)
    gm = np.asarray([[True, True, True, False], [False] * 4])
    return gb, gl, gm


def test_yolo_targets_and_loss_match_jax():
    cfg = jy.Yolo2DConfig(num_classes=4)
    tcfg = ty.Yolo2DConfig(num_classes=4)
    gb, gl, gm = _yolo_boxes()
    batched = tty.make_yolo_targets(tcfg, YOLO_HW, *(torch.as_tensor(a) for a in (gb, gl, gm)))
    rng = np.random.default_rng(1)
    h, w = YOLO_HW[0] // 16, YOLO_HW[1] // 16
    preds = dict(obj=rng.normal(-2, 2, (h, w, 1)), cls=rng.normal(size=(h, w, 4)),
                 box=rng.normal(size=(h, w, 4)) * 2)
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    for b in range(2):
        want = jax.device_get(jty.make_yolo_targets(cfg, YOLO_HW, jnp.asarray(gb[b]),
                                                    jnp.asarray(gl[b]), jnp.asarray(gm[b])))
        one = tty.make_yolo_targets(tcfg, YOLO_HW, *(torch.as_tensor(a[b]) for a in (gb, gl, gm)))
        for k, v in want.items():
            np.testing.assert_array_equal(one[k].numpy(), v, err_msg=k)
            assert torch.equal(batched[k][b], one[k]), k
        wl, waux = jax.device_get(jty.yolo_loss({k: jnp.asarray(v) for k, v in preds.items()},
                                                want))
        tl, taux = tty.yolo_loss({k: torch.as_tensor(v) for k, v in preds.items()}, one)
        assert _rel(tl, wl) <= TARGET_REL
        for k, v in waux.items():
            assert _rel(taux[k], v) <= TARGET_REL, k
    # the shared cell: objectness and both classes, the later box's geometry
    assert float(batched["obj"][0].sum()) == 2.0 and float(batched["cls"][0].sum()) == 3.0
    assert float(batched["obj"][1].sum()) == 0.0


def _yolo_batches(n, seed=3):
    return list(jty.SyntheticTrafficLightDataset(jty.TrafficLightSceneConfig(hw=YOLO_HW),
                                                 batch_size=4, seed=seed).batches(n))


def test_yolo_trainer_matches_jax_in_bf16():
    cfg = jy.Yolo2DConfig(num_classes=4)
    jtr = jty.YoloTrainer(cfg, hw=YOLO_HW, lr=1e-2, total_steps=200)
    tr = tty.YoloTrainer(ty.Yolo2DConfig(num_classes=4), hw=YOLO_HW, lr=1e-2, total_steps=200,
                         device="cpu")
    convert.load_camera_params(tr.model, jax.device_get(jtr.params))
    batches = _yolo_batches(3)

    def jloss(params, batch):
        def one(img, gb, gl, gm):
            return jty.yolo_loss(jtr.model.apply(params, img),
                                 jty.make_yolo_targets(cfg, YOLO_HW, gb, gl, gm))[0]
        return jnp.mean(jax.vmap(one)(batch["image"], batch["gt_boxes"], batch["gt_labels"],
                                      batch["gt_mask"]))
    first = {k: jnp.asarray(v) for k, v in batches[0].items()}
    want_grads = _leaves(jax.device_get(jax.jit(jax.grad(jloss))(jtr.params, first)))
    loss, _ = tr.loss_on_batch(tr.upload(batches[0]))
    loss.backward()
    got_grads = _leaves(convert.camera_params_to_flax(
        tr.model, {n: p.grad for n, p in tr.model.named_parameters()}))
    tr.opt.zero_grad()
    assert got_grads.keys() == want_grads.keys()
    for k, v in want_grads.items():
        if "ConvBlock" in k and "['Conv_0']['bias']" in k:
            continue                    # before a GroupNorm: rounding noise (see above)
        g = got_grads[k].astype(np.float64).ravel()
        r = v.astype(np.float64).ravel()
        cos = float(g @ r / (np.linalg.norm(g) * np.linalg.norm(r)))
        gap = float(np.linalg.norm(g - r) / np.linalg.norm(r))
        assert cos >= YOLO_GRAD_COS and gap <= YOLO_GRAD_GAP, (k, cos, gap)
    want, got = [], []
    for b in batches:
        jtr.params, jtr.opt_state, loss, _ = jtr._step(
            jtr.params, jtr.opt_state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(loss))
        got.append(float(tr.train_step(tr.upload(b))[0]))
    np.testing.assert_allclose(got, want, rtol=BF16_LOSS_REL)


def test_trainers_save_what_the_reference_loads(tmp_path):
    from lsd_tpu.models import params_io as jio
    tr = tty.YoloTrainer(device="cpu")
    path = tr.save(str(tmp_path / "y.msgpack"))
    ref = jio.load_params(path, jax.device_get(jty.YoloTrainer().params))
    for k, v in _leaves(convert.camera_params_to_flax(tr.model)).items():
        np.testing.assert_array_equal(_leaves(ref)[k], v)
    m = ttm.Mono3DTrainer(tm.Mono3DConfig(image_hw=SMALL_HW, base_ch=8), device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        m.load(path)


@pytest.mark.parametrize("tool,args", [
    ("train_mono3d", ["--small", "--steps", "2", "--batch", "2", "--eval-batches", "1"]),
    ("train_yolo", ["--steps", "2", "--batch", "2", "--eval-batches", "1"])])
def test_cli_trains_on_the_cpu(tool, args, tmp_path, capsys):
    import importlib
    from lsd_tpu_torch.models.params_io import load_params
    mod = importlib.import_module(f"lsd_tpu_torch.tools.{tool}")
    out = str(tmp_path / "w.msgpack")
    assert mod.main(args + ["--device", "cpu", "--out", out]) == 0
    printed = capsys.readouterr().out
    assert ("2 steps" in printed) or ('"steps": 2' in printed)
    assert "ConvBlock_0" in load_params(out)["params"]
