"""Port parity for data-parallel training: ``Trainer(mesh=...)`` on a gloo
group of 2 CPU ranks against the reference's ``Trainer(mesh=make_mesh(2))``
(2 of the 8 virtual CPU devices) and against the port's one-process
``Trainer``, on the same batches, at ``tests/test_torch_training.py``'s
small grid, from the same initial weights.

The reference's own check (``tests/test_training.py:81-100``) holds its
sharded step to its one-device step at rel 1e-4 on the loss and rtol 1e-4,
atol 1e-5 on the parameters.  Here the two ranks each take half of every
batch and average their gradients; the float32 network is run (bf16 would
round the two halves' sums otherwise than the whole batch's).  The
reference's sharded step is its own (``Trainer._build_train_step`` with the
mesh: the batch constrained to ``P("dp")``, the gradient mean left to the
partitioner), rebuilt over the float32 network of
``tests/test_torch_training.py`` (its ``CenterPointDetector`` has no dtype
field).  Three steps, the first at lr 0 (warmup), so the parameters move.
Tolerances:
- each step's loss within rel 1e-4 of the reference's and of the
  one-process loss;
- against the reference, each leaf's update within 2e-2 of the reference's
  in relative norm and every parameter within 1.5 lr of it:
  ``tests/test_torch_training.py``'s bars for the port's float32 ``Trainer``
  against the reference's step (measured: losses within 6.4e-6, update gaps
  at most 4.5e-3, parameters within 0.89 lr; Adam moves an element whose
  gradient is rounding noise by up to lr either way, so rtol 1e-4, atol
  1e-5 holds within a package, not across two: 27 of 82 leaves miss it);
- every parameter within rtol 1e-4, atol 1e-5 of the one-process one;
- the two ranks' parameters bitwise equal.
Also: a batch that does not split raises, and ``tools/train.py --mesh-dp``
asks for as many cards as ranks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.parallel import make_mesh as jmake_mesh
from lsd_tpu.training import trainer as jtrainer
from lsd_tpu_torch import convert
from lsd_tpu_torch.parallel import run_ranks
from lsd_tpu_torch.parallel.mesh import Mesh
from lsd_tpu_torch.training import data as tdata
from lsd_tpu_torch.training import trainer as ttrainer
from tests.test_torch_training import (CFG, LOSS_REL, PARAM_LR, TCFG, UPDATE_GAP,
                                       _jax_apply_f32, _leaves)

from tests import torch_ranks

LR = 1e-3
TR_CFG = ttrainer.TrainerConfig(lr=LR, warmup_steps=1, total_steps=100)


def _batches(n, seed=11, batch=2):
    ds = tdata.SyntheticDetectionDataset(
        tdata.SyntheticSceneConfig(n_boxes=5, points_per_box=96, clutter_points=1500,
                                   xy_range=10.0),
        point_capacity=2 ** 12, box_capacity=8, batch_size=batch, seed=seed)
    return list(ds.batches(n))


class _Float32Network:
    """The reference detector's ``apply`` over its float32 submodules."""

    @staticmethod
    def apply(variables, pts, msk):
        return _jax_apply_f32(variables["params"], pts, msk)


def _reference_sharded(start, batches):
    """The reference's ``Trainer(mesh=make_mesh(2))`` from ``start`` (the
    flax tree): each step's loss and the parameters after the last."""
    jtr = jtrainer.Trainer(det_cfg=CFG, cfg=jtrainer.TrainerConfig(
        lr=LR, warmup_steps=TR_CFG.warmup_steps, total_steps=TR_CFG.total_steps,
        log_every=1000), mesh=jmake_mesh(2))
    jtr.model = _Float32Network()
    jtr._train_step = jtr._build_train_step()
    params = jax.tree.map(jnp.asarray, start)
    state, losses = jtr.tx.init(params), []
    for b in batches:
        params, state, loss, _ = jtr._train_step(params, state,
                                                 {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
    return dict(losses=losses, params=jax.device_get(params))


@pytest.fixture(scope="module")
def runs(default_torch_threads):
    batches = _batches(3)
    ranks = run_ranks(torch_ranks.train_steps, 2, backend="gloo",
                      args=(TCFG, TR_CFG, batches, torch.float32))
    tr = ttrainer.Trainer(TCFG, TR_CFG, device="cpu", dtype=torch.float32)
    # a copy: the flax tree's arrays share the parameters' memory
    start = jax.tree.map(np.array, convert.detector_params_to_flax(tr.model))
    losses = [float(tr.train_step(tr.upload(b))[0]) for b in batches]
    one = dict(losses=losses, params={n: p.detach().numpy().copy()
                                      for n, p in tr.model.named_parameters()})
    ref = _reference_sharded(start, batches)
    return ranks, one, dict(ref, start=start, model=tr.model)


def test_ranks_stay_equal(runs):
    ranks, *_ = runs
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for name, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][name], v, err_msg=name)


def test_matches_the_reference_sharded_trainer(runs):
    ranks, _, ref = runs
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], ref["losses"], rtol=LOSS_REL)
        mine = _leaves(convert.detector_params_to_flax(
            ref["model"], {n: torch.as_tensor(v) for n, v in rank["params"].items()}))
        first, want = _leaves(ref["start"]), _leaves(ref["params"])
        assert mine.keys() == want.keys() and len(want) > 40
        for k, v in want.items():
            ours, theirs = mine[k] - first[k], v - first[k]
            gap = float(np.linalg.norm(ours - theirs) / np.linalg.norm(theirs))
            assert gap <= UPDATE_GAP, (jax.tree_util.keystr(k), gap)
            assert float(np.abs(mine[k] - v).max()) <= PARAM_LR * LR, jax.tree_util.keystr(k)


def test_matches_one_process_step(runs):
    ranks, one, _ = runs
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=1e-4)
    moved = 0
    for name, want in one["params"].items():
        np.testing.assert_allclose(ranks[0]["params"][name], want, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    start = ttrainer.Trainer(TCFG, TR_CFG, device="cpu", dtype=torch.float32)
    for name, p in start.model.named_parameters():
        moved += int(np.abs(one["params"][name] - p.detach().numpy()).max() > 1e-4)
    assert moved > 10


def test_uneven_batch_raises():
    mesh = Mesh(axis="dp", rank=0, size=2, group=None, device=torch.device("cpu"))
    tr = ttrainer.Trainer(TCFG, TR_CFG, mesh=mesh, dtype=torch.float32)
    batch = tr.upload(_batches(1, batch=3)[0])
    with pytest.raises(ValueError, match="3 rows do not split evenly over 2 ranks"):
        tr.train_step(batch)
    with pytest.raises(ValueError, match="not the mesh's device"):
        ttrainer.Trainer(TCFG, TR_CFG, device="cuda", mesh=mesh)
