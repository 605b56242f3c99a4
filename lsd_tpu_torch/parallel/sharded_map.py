"""Map-block sharded LIO: the surfel map itself is split over the mesh's
ranks (counterpart of ``lsd_tpu/parallel/sharded_map.py``).

Each rank owns a deterministic hash partition of the voxels and stores
them in its own open-addressed table of capacity C / ranks, so the total
map capacity grows with the ranks.  No halo exchange is needed: the surfel
map stores additive Gaussian moments per voxel, a query's 7-voxel
neighbourhood is a sum of translated moments, so each rank sums the
neighbours it owns and one ``all_reduce`` of the (N, 10) partial moments
gives the merge over the whole map.

Per scan: one ``all_reduce`` of the (N, 10) partial moments (association,
once per scan: the step never re-matches planes), and one of the
(24, 24) + (24,) information per Gauss-Newton iteration.  Each rank
reduces its contiguous range of the residual points through the fused
point-to-plane reduction (``ops/p2p.py``, the hand-written kernel on
CUDA) and inserts only the voxels it owns.

The front end (IMU propagation, undistortion, downsample), the solve and
the trim test run on every rank on the same values.  The trim is a host
decision; the number and order of collectives never depend on data.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.hashmap import _hash_coords
from ..ops.p2p import p2p_reduce
from ..ops.surfel import (_face_offsets, planes_from_moments, surfel_insert,
                          surfel_neighborhood_moments, surfel_trim)
from ..ops.voxelize import voxel_downsample
from ..slam.imu import propagate, undistort
from ..slam.lio import (LioConfig, LioState, _gate_degenerate, _update_mask, lio_init,
                        p2p_weight)
from ..slam.state import ERR_DIM, NavState, boxminus, boxplus
from ..utils.precision import slam_f32
from .mesh import Mesh, psum, rank_rows

_OWNER_SEED = 0xA511E9B3


def _owner_of(coords: torch.Tensor, ndev: int) -> torch.Tensor:
    """Deterministic voxel coords (..., 3) -> owning rank (int32), the
    reference's murmur mix of the uint32 coords modulo ``ndev``."""
    return (_hash_coords(coords, _OWNER_SEED) % ndev).to(torch.int32)


def sharded_lio_init(cfg: LioConfig, mesh: Mesh, nav: Optional[NavState] = None) -> LioState:
    """This rank's ``LioState``: the filter state as ``lio_init`` makes it,
    and an empty local surfel map of capacity ``map_capacity / ranks``."""
    if cfg.map_type != "surfel":
        raise ValueError(f"the sharded map is a surfel map, not {cfg.map_type!r}")
    if cfg.map_capacity % mesh.size:
        raise ValueError(f"map_capacity {cfg.map_capacity} does not split over "
                         f"{mesh.size} ranks")
    return lio_init(cfg._replace(map_capacity=cfg.map_capacity // mesh.size), nav,
                    device=mesh.device)


def _to_world(nav: NavState, pts: torch.Tensor) -> torch.Tensor:
    return (pts @ nav.ext_rot.T + nav.ext_t) @ nav.rot.T + nav.pos


def make_sharded_lio_step(cfg: LioConfig, mesh: Mesh):
    """The map-sharded scan step ``step(st, points, stamps, mask, imu,
    imu_mask) -> (st, pose (4, 4))`` of this rank; start it from
    ``sharded_lio_init``.  Every rank calls it with the same scan."""
    ndev, me = mesh.size, mesh.rank
    own_pts = rank_rows(mesh, cfg.ds_capacity)

    @slam_f32
    def step(st: LioState, points, stamps, mask, imu, imu_mask):
        dev = st.P.device
        local_map = st.map
        upd_mask = _update_mask(cfg, dev)

        # ---- front end, the same on every rank --------------------------
        nav_prop, P_prop, track = propagate(st.nav, st.P, imu, imu_mask,
                                            cfg.imu_noise, cfg.acc_scale)
        pts_und = undistort(points[:, :3], stamps, mask, nav_prop, track)
        ds_pts, ds_mask = voxel_downsample(pts_und, mask, cfg.scan_voxel, cfg.ds_capacity)
        ds_pts = ds_pts[:, :3].contiguous()
        eye = torch.eye(ERR_DIM, dtype=torch.float32, device=dev)
        P_inv, _ = torch.linalg.inv_ex(P_prop + 1e-9 * eye)

        # ---- association: owned-neighbour partial moments, summed -------
        pw = _to_world(nav_prop, ds_pts)
        base = torch.floor(pw / local_map.voxel_size).to(torch.int32)
        ncoords = base[:, None, :] + _face_offsets(dev)[None, :, :]
        own = _owner_of(ncoords, ndev) == me
        partial = surfel_neighborhood_moments(local_map, pw, neighbor_mask=own)
        merged, = psum(mesh, partial)
        planes = planes_from_moments(merged, pw, local_map.voxel_size, ds_mask,
                                     cfg.plane_thresh)

        # ---- iterations: this rank's point range, summed ----------------
        my_pts = ds_pts[own_pts]
        my_planes = tuple(p[own_pts] for p in planes)
        weight = p2p_weight(cfg, ds_mask[own_pts], my_planes)
        nav_i = nav_prop
        HtH = torch.zeros((ERR_DIM, ERR_DIM), dtype=torch.float32, device=dev)
        for _ in range(cfg.max_iters):
            HtH_p, Htr_p, _ = p2p_reduce(my_pts, my_planes[0], my_planes[1], weight,
                                         nav_i.rot, nav_i.ext_rot, nav_i.ext_t, nav_i.pos,
                                         cfg.max_resid)
            HtH, Htr = psum(mesh, HtH_p, Htr_p)
            E, _, _ = _gate_degenerate(cfg, HtH)
            HtH = E @ HtH @ E.T
            Htr = E @ Htr
            delta = boxminus(nav_i, nav_prop)
            sol, _ = torch.linalg.solve_ex(HtH + P_inv, Htr + P_inv @ delta)
            nav_i = boxplus(nav_i, -sol * upd_mask)
        P_new, _ = torch.linalg.inv_ex(HtH + P_inv)
        P_new = 0.5 * (P_new + P_new.T)
        nav_new = NavState(*[torch.where(st.initialized, a, b)
                             for a, b in zip(nav_i, nav_prop)])
        P_new = torch.where(st.initialized, P_new, P_prop)

        # ---- map insert: each rank claims only the voxels it owns --------
        if cfg.map_voxel == cfg.scan_voxel:
            ins_pts, ins_mask = ds_pts, ds_mask
        else:
            ins_pts, ins_mask = voxel_downsample(pts_und, mask, cfg.map_voxel,
                                                 cfg.ds_capacity)
            ins_pts = ins_pts[:, :3]
        ins_w = _to_world(nav_new, ins_pts)
        ins_coords = torch.floor(ins_w / local_map.voxel_size).to(torch.int32)
        mine = _owner_of(ins_coords, ndev) == me
        new_map = surfel_insert(local_map, ins_w, ins_mask & mine)
        moved = torch.linalg.norm(nav_new.pos - st.map_center) > cfg.recenter_thresh
        if bool(moved):                                          # host sync
            new_map = surfel_trim(new_map, nav_new.pos, cfg.map_radius)
        new_st = LioState(nav=nav_new, P=P_new, map=new_map,
                          map_center=torch.where(moved, nav_new.pos, st.map_center),
                          initialized=torch.ones((), dtype=torch.bool, device=dev),
                          step_count=st.step_count + 1)
        return new_st, nav_new.pose_matrix()

    return step
