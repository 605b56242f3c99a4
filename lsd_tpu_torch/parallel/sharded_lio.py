"""Multi-device LIO update: scan points split over the mesh's ranks
(counterpart of ``lsd_tpu/parallel/sharded_lio.py``).

The ESIKF information-matrix build (HtH, Htr) is a sum over scan points.
Each rank matches its contiguous range of the points against the
replicated local map and reduces its partial (HtH, Htr) through the fused
point-to-plane reduction (``ops/p2p.py``, the hand-written kernel on
CUDA); one ``all_reduce`` sums the partials, and every rank solves the
24x24 system redundantly, as the reference's ``shard_map`` does.
"""
from __future__ import annotations

from typing import Union

import torch

from ..ops.hashmap import VoxelHashMap
from ..ops.p2p import p2p_reduce
from ..ops.surfel import SurfelMap
from ..slam.lio import (LioConfig, _gate_degenerate, _match_planes, _update_mask,
                        p2p_weight)
from ..slam.state import ERR_DIM, NavState, boxminus, boxplus
from ..utils.precision import slam_f32
from .mesh import Mesh, psum, rank_rows


@slam_f32
def sharded_lio_update(cfg: LioConfig, mesh: Mesh, nav_prop: NavState,
                       P_prop: torch.Tensor, m: Union[SurfelMap, VoxelHashMap],
                       pts_l: torch.Tensor, mask: torch.Tensor) -> NavState:
    """One iterated-update pass (``cfg.max_iters`` iterations) with the
    points split over the mesh.  Every rank calls it with the same
    arguments and returns the same state."""
    sl = rank_rows(mesh, pts_l.shape[0])
    pts, msk = pts_l[sl].contiguous(), mask[sl]
    dev = pts.device
    upd_mask = _update_mask(cfg, dev)
    eye = torch.eye(ERR_DIM, dtype=torch.float32, device=dev)
    P_inv, _ = torch.linalg.inv_ex(P_prop + 1e-9 * eye)
    nav_i = nav_prop
    for _ in range(cfg.max_iters):
        planes = _match_planes(cfg, nav_i, pts, msk, m)
        HtH_p, Htr_p, _ = p2p_reduce(
            pts, planes[0], planes[1], p2p_weight(cfg, msk, planes),
            nav_i.rot, nav_i.ext_rot, nav_i.ext_t, nav_i.pos, cfg.max_resid,
            est_extrinsic=cfg.est_extrinsic)
        HtH, Htr = psum(mesh, HtH_p, Htr_p)
        E, _, _ = _gate_degenerate(cfg, HtH)
        HtH = E @ HtH @ E.T
        Htr = E @ Htr
        delta = boxminus(nav_i, nav_prop)
        sol, _ = torch.linalg.solve_ex(HtH + P_inv, Htr + P_inv @ delta)
        nav_i = boxplus(nav_i, -sol * upd_mask)
    return nav_i
