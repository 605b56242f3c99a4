"""Rank functions for the port's multi-rank tests.

``lsd_tpu_torch.parallel.run_ranks`` starts each rank as a new process that
imports the module of the function it runs.  These live here, apart from
the test files, because the test files import JAX and the ranks must not:
this module imports numpy, torch and ``lsd_tpu_torch`` only.  Arguments and
results cross the process boundary by pickle, as numpy arrays, dicts and
the port's own config tuples.
"""
import os
import signal
import sys

import numpy as np
import torch
import torch.distributed as dist

from lsd_tpu_torch import convert
from lsd_tpu_torch.parallel import (make_mesh, make_sharded_lio_step, optimize_schur,
                                    optimize_sharded, sharded_lio_init, sharded_lio_update)
from lsd_tpu_torch.parallel.mesh import psum
from lsd_tpu_torch.slam.state import NavState


def _nav(tree) -> NavState:
    return NavState(*[torch.as_tensor(tree[f]) for f in NavState._fields])


def mesh_and_update(mesh, cfg, st_tree, nav_prop, P_prop, ds_pts, ds_mask):
    """What a rank sees of its mesh, and its result of ``sharded_lio_update``."""
    out = dict(rank=mesh.rank, size=mesh.size, axis=mesh.axis, device=str(mesh.device),
               sub_rank=make_mesh(2).rank,
               foreign=sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "lsd_tpu")))
    try:
        make_mesh(mesh.size + 1)
    except ValueError as exc:
        out["too_many"] = str(exc)
    out["psum"] = psum(mesh, torch.full((3,), float(mesh.rank + 1)),
                       torch.ones(2, 2))[0].numpy()
    st = convert.lio_state_from_numpy(st_tree, "cpu")
    nav = sharded_lio_update(cfg, mesh, _nav(nav_prop), torch.as_tensor(P_prop), st.map,
                             torch.as_tensor(ds_pts), torch.as_tensor(ds_mask))
    out["nav"] = {f: v.numpy() for f, v in zip(NavState._fields, nav)}
    return out


def die_in_collective(mesh, how):
    """Rank 1 dies (``how="kill"``) or raises (``"raise"``) while the
    others wait in an all_reduce that it never joins."""
    if mesh.rank == 1:
        if how == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        raise RuntimeError("rank 1 gives up")
    dist.all_reduce(torch.ones(1), group=mesh.group)
    return mesh.rank


def num_threads(mesh):
    """The torch intra-op threads this rank was given."""
    return torch.get_num_threads()


def sharded_map_run(mesh, cfg, scans, nav0=None):
    """The map-sharded step over ``scans`` (tuples of numpy arrays): each
    scan's pose, and this rank's map capacity and occupied slots."""
    nav = _nav(nav0) if nav0 is not None else None
    step = make_sharded_lio_step(cfg, mesh)
    st = sharded_lio_init(cfg, mesh, nav)
    poses = []
    for scan in scans:
        st, pose = step(st, *[torch.as_tensor(a) for a in scan[:5]])
        poses.append(pose.numpy())
    return dict(poses=np.stack(poses), capacity=st.map.capacity,
                shapes=[tuple(st.map.keys.shape), tuple(st.map.coords.shape),
                        tuple(st.map.moments.shape)],
                occupied=int((st.map.keys >= 0).sum()),
                keys=st.map.keys.numpy())


def pgo_runs(mesh, jobs):
    """Each job (graph as a numpy tree of ``convert.graph_to_numpy``,
    "sharded" or "schur", config) solved by ``optimize_sharded`` or
    ``optimize_schur``: node positions and quaternions, and the Schur
    solve's ``gps_inliers``, ``n_sep`` and info keys."""
    out = []
    for tree, which, pgo_cfg in jobs:
        g = convert.graph_from_numpy(tree, "cpu")
        if which == "sharded":
            g2 = optimize_sharded(g, mesh, pgo_cfg)
            info = {}
        else:
            g2, info = optimize_schur(g, mesh, pgo_cfg)
            info = dict(gps_inliers=int(info["gps_inliers"]), n_sep=info["n_sep"],
                        keys=sorted(info))
        out.append(dict(pos=g2.nodes.pos.numpy(), quat=g2.nodes.quat.numpy(), **info))
    return out


def train_steps(mesh, det_cfg, tr_cfg, batches, dtype):
    """``Trainer(mesh=...)`` over ``batches`` (dicts of numpy arrays): each
    step's loss and the parameters after the last."""
    from lsd_tpu_torch.training.trainer import Trainer
    tr = Trainer(det_cfg, tr_cfg, mesh=mesh, dtype=dtype)
    losses = [float(tr.train_step(tr.upload(b))[0]) for b in batches]
    return dict(losses=losses, params={n: p.detach().numpy().copy()
                                       for n, p in tr.model.named_parameters()})


def pgo_planted(mesh, tree, which):
    """``optimize_sharded`` or ``optimize_schur`` where rank 1's graph has
    its first edge's translation moved by 1 m: each rank raises."""
    g = convert.graph_from_numpy(tree, "cpu")
    if mesh.rank == 1:
        g = g._replace(se3=g.se3._replace(t_meas=g.se3.t_meas.clone().index_add_(
            0, torch.tensor([0]), torch.ones(1, 3))))
    if which == "sharded":
        optimize_sharded(g, mesh)
    else:
        optimize_schur(g, mesh)
    return mesh.rank


def merge_counting(mesh, map_a, map_b, out_dir):
    """``campaign_merge.merge_rank``, and how often this rank built the
    joint graph (``slam.map_merge.merge_maps``)."""
    from lsd_tpu_torch.slam import map_merge
    from lsd_tpu_torch.tools import campaign_merge
    real, calls = map_merge.merge_maps, []

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    map_merge.merge_maps = counted
    try:
        rep = campaign_merge.merge_rank(mesh, map_a, map_b, out_dir)
    finally:
        map_merge.merge_maps = real
    return dict(rep, merge_maps_calls=len(calls))
