"""Tightly-coupled LiDAR-inertial odometry: iterated error-state Kalman
filter on the 24-dim manifold state.

Counterpart of ``lsd_tpu/slam/lio.py`` with the surfel map.  One scan step:

  propagate IMU -> undistort scan -> voxel-downsample -> match planes ->
  iterate (fused point-to-plane reduction, ops/p2p.py; degeneracy gate;
  optional velocity observation; 24x24 solve) -> covariance update ->
  insert scan into map -> trim map when the sensor moved far.

The reference's two ``lax.cond``s (plane re-search inside the iteration,
map trim after it) are Python ``if``s on device booleans here: one host
sync per iteration after the first, plus one per scan.  The small dense algebra (6x6 eigh,
3x3 eigvalsh, 24x24 solve and inverse) stays on the device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from ..ops.p2p import p2p_reduce
from ..ops.surfel import SurfelMap, surfel_create, surfel_insert, surfel_match, surfel_trim
from ..ops.voxelize import voxel_downsample
from ..utils.device import DeviceLike, resolve_device
from ..utils.precision import slam_f32
from .imu import ImuNoise, propagate, undistort
from .state import ERR_DIM, GRAVITY, IDX_V, NavState, boxminus, boxplus, init_state


class LioConfig(NamedTuple):
    """Every field and default of the reference's ``LioConfig``, so configs
    carry over.  ``use_pallas_p2p`` has no effect here: the port always
    reduces through ``ops/p2p.py:p2p_reduce`` (the reference's
    ``use_pallas_p2p=True`` semantics)."""
    # scan processing
    scan_voxel: float = 0.5          # downsample leaf for residual points
    ds_capacity: int = 8192          # residual point budget
    # map
    map_capacity: int = 2 ** 17
    map_points_per_voxel: int = 8
    map_voxel: float = 0.5
    map_radius: float = 300.0        # local map half-extent
    recenter_thresh: float = 60.0    # trim when moved this far from map center
    # filter
    max_iters: int = 3
    meas_noise: float = 0.05         # point-to-plane sigma (m)
    vel_noise: float = 0.2           # wheelspeed/INS velocity sigma (m/s)
    vel_obs_point_frac: float = 0.1  # velocity info multiplier = frac * n_valid
    degen_rel_frac: float = 0.05     # n_weak: lam < frac * lam_max
    plane_thresh: float = 0.1        # plane inlier threshold
    max_resid: float = 1.0           # residual gate (m)
    research_thresh: float = 0.05    # re-match planes when the iterate moved this far
    degen_thresh: float = 10.0       # eigenvalue gate on the HtH pose block
    neighborhood: int = 7
    map_type: str = "surfel"         # only "surfel" is ported
    use_pallas_p2p: bool = False     # no effect in the port (see above)
    est_extrinsic: bool = False
    est_gravity: bool = False
    imu_noise: ImuNoise = ImuNoise()
    acc_scale: float = GRAVITY       # converts accel units to m/s^2


class LioState(NamedTuple):
    nav: NavState
    P: torch.Tensor              # (24, 24)
    map: SurfelMap
    map_center: torch.Tensor     # (3,)
    initialized: torch.Tensor    # () bool — map seeded
    step_count: torch.Tensor     # () int32


def _check_map_type(cfg: LioConfig) -> None:
    if cfg.map_type != "surfel":
        raise NotImplementedError(
            f"map_type={cfg.map_type!r} is not ported yet; the raw-point map "
            "is ROADMAP queue A item 7")


def lio_init(cfg: LioConfig, nav: Optional[NavState] = None,
             device: DeviceLike = None) -> LioState:
    """Initial filter state; on ``nav``'s device if given, else on ``device``."""
    _check_map_type(cfg)
    dev = nav.pos.device if nav is not None else resolve_device(device)
    P = torch.eye(ERR_DIM, dtype=torch.float32, device=dev) * 1e-4
    P[9:15, 9:15] = torch.eye(6, device=dev) * 1e-3    # bias uncertainty
    P[15:18, 15:18] = torch.eye(3, device=dev) * 1e-2  # gravity
    return LioState(
        nav=nav if nav is not None else init_state(device=dev),
        P=P,
        map=surfel_create(cfg.map_capacity, cfg.map_voxel, device=dev),
        map_center=torch.zeros(3, dtype=torch.float32, device=dev),
        initialized=torch.tensor(False, device=dev),
        step_count=torch.tensor(0, dtype=torch.int32, device=dev),
    )


def _update_mask(cfg: LioConfig, device: torch.device) -> torch.Tensor:
    m = torch.ones((ERR_DIM,), dtype=torch.float32, device=device)
    if not cfg.est_gravity:
        m[15:18] = 0.0
    if not cfg.est_extrinsic:
        m[18:24] = 0.0
    return m


def _match_planes(cfg: LioConfig, nav: NavState, pts_l: torch.Tensor,
                  mask: torch.Tensor, m: SurfelMap):
    """Plane association at pose ``nav``: (normals, d, plane_ok, plane_rms)."""
    pw = (pts_l @ nav.ext_rot.T + nav.ext_t) @ nav.rot.T + nav.pos
    return surfel_match(m, pw, mask, cfg.plane_thresh)


def _gate_degenerate(cfg: LioConfig, HtH: torch.Tensor):
    """Projection removing measurement influence along degenerate pose
    directions (eigenvalues of the 6x6 pose block below threshold), plus
    the degenerate count and the relative-degeneracy count n_weak.

    As in the reference (``lio.py:207``), n_weak reads ``A[3:6, 3:6]``,
    which is the rotation block of the state layout though the reference
    calls it the translation block; this is reproduced, not fixed
    (ROADMAP queue C).
    """
    A = HtH[0:6, 0:6]
    lam, V = torch.linalg.eigh(A)
    keep = (lam >= cfg.degen_thresh).to(A.dtype)
    Pi = (V * keep[None, :]) @ V.T
    E = torch.eye(ERR_DIM, dtype=A.dtype, device=A.device)
    E[0:6, 0:6] = Pi
    n_degenerate = torch.sum(1.0 - keep).to(torch.int32)
    lam_t = torch.linalg.eigvalsh(A[3:6, 3:6])
    n_weak = torch.sum(lam_t < cfg.degen_rel_frac * lam_t[-1]).to(torch.int32)
    return E, n_degenerate, n_weak


class ScanFront(NamedTuple):
    """What a scan step computes before its Gauss-Newton iterations."""
    nav_prop: NavState
    P_prop: torch.Tensor
    track: dict
    pts_und: torch.Tensor     # (N, 3) undistorted scan, scan-end lidar frame
    ds_pts: torch.Tensor      # (ds_capacity, 3) residual points
    ds_mask: torch.Tensor     # (ds_capacity,)
    planes: tuple             # _match_planes at nav_prop


def scan_front(cfg: LioConfig, st: LioState, points: torch.Tensor,
               stamps: torch.Tensor, mask: torch.Tensor, imu: torch.Tensor,
               imu_mask: torch.Tensor) -> ScanFront:
    """IMU propagation, undistortion, downsample and the first plane match."""
    nav_prop, P_prop, track = propagate(st.nav, st.P, imu, imu_mask,
                                        cfg.imu_noise, cfg.acc_scale)
    pts_und = undistort(points[:, :3], stamps, mask, nav_prop, track)
    ds_pts, ds_mask = voxel_downsample(pts_und, mask, cfg.scan_voxel, cfg.ds_capacity)
    ds_pts = ds_pts[:, :3].contiguous()
    planes = _match_planes(cfg, nav_prop, ds_pts, ds_mask, st.map)
    return ScanFront(nav_prop, P_prop, track, pts_und, ds_pts, ds_mask, planes)


def p2p_weight(cfg: LioConfig, ds_mask: torch.Tensor, planes) -> torch.Tensor:
    """Per-point weight of the fused reduction: inverse measurement variance
    (base sigma + plane thickness) where the point and its plane are valid."""
    _, _, plane_ok, plane_rms = planes
    inv_var = 1.0 / (cfg.meas_noise ** 2 + plane_rms ** 2)
    return torch.where(ds_mask & plane_ok, inv_var, 0.0)


def _iterate(cfg: LioConfig, m: SurfelMap, front: ScanFront, P_inv: torch.Tensor,
             vel_obs: torch.Tensor, vel_obs_valid: torch.Tensor):
    """The Gauss-Newton iterations: (nav, gated HtH + velocity info of the
    last iteration, stats [n_valid, sum |r|, n_degenerate, n_weak])."""
    dev = P_inv.device
    nav_prop, ds_pts, ds_mask = front.nav_prop, front.ds_pts, front.ds_mask
    upd_mask = _update_mask(cfg, dev)
    vw = torch.where(vel_obs_valid, 1.0 / (cfg.vel_noise ** 2), 0.0)
    # the iterations reuse the plane set unless the iterate moved beyond
    # research_thresh from the pose it was matched at (FAST-LIO's
    # converge/rematch flag); the last iteration's information matrix
    # feeds the covariance update
    nav_i = nav_prop
    planes = front.planes
    anchor = (nav_prop.pos, nav_prop.quat)
    HtH = torch.zeros((ERR_DIM, ERR_DIM), dtype=torch.float32, device=dev)
    stats = torch.zeros(4, dtype=torch.float32, device=dev)
    for it in range(cfg.max_iters):
        # the first iterate is the anchor itself, so its test is always
        # false and is skipped (one host sync fewer per scan)
        if cfg.research_thresh > 0 and it > 0:
            d_t = torch.linalg.norm(nav_i.pos - anchor[0])
            d_r = torch.linalg.norm(nav_i.quat - anchor[1] *
                                    torch.sign(torch.sum(nav_i.quat * anchor[1])))
            if bool((d_t + 20.0 * d_r) > cfg.research_thresh):   # host sync
                planes = _match_planes(cfg, nav_i, ds_pts, ds_mask, m)
                anchor = (nav_i.pos, nav_i.quat)
        normals, dpl, _, _ = planes
        HtH, Htr, pstats = p2p_reduce(
            ds_pts, normals, dpl, p2p_weight(cfg, ds_mask, planes),
            nav_i.rot, nav_i.ext_rot, nav_i.ext_t, nav_i.pos, cfg.max_resid,
            est_extrinsic=cfg.est_extrinsic)
        n_pts_valid, sum_abs_r = pstats[0], pstats[1]
        E, n_degen, n_weak = _gate_degenerate(cfg, HtH)
        HtH = E @ HtH @ E.T
        Htr = E @ Htr
        # velocity observation: fixed weight when the geometry is
        # well-conditioned, scaled with the competing point count when any
        # pose axis is (relatively) degenerate
        vw_i = vw * torch.where((n_degen > 0) | (n_weak > 0),
                                torch.clamp(cfg.vel_obs_point_frac * n_pts_valid, min=1.0),
                                1.0)
        HtH[IDX_V, IDX_V] += torch.eye(3, device=dev) * vw_i
        Htr[IDX_V] += vw_i * (nav_i.vel - vel_obs)

        delta = boxminus(nav_i, nav_prop)
        A = HtH + P_inv
        b = Htr + P_inv @ delta
        sol, _ = torch.linalg.solve_ex(A, b)
        dx = -sol * upd_mask
        stats = torch.stack([n_pts_valid, sum_abs_r,
                             n_degen.to(torch.float32), n_weak.to(torch.float32)])
        nav_i = boxplus(nav_i, dx)
    return nav_i, HtH, stats


def _update_map(cfg: LioConfig, st: LioState, front: ScanFront, mask: torch.Tensor,
                nav: NavState) -> Tuple[SurfelMap, torch.Tensor]:
    """Insert the scan at pose ``nav``; trim the map when the sensor moved
    ``recenter_thresh`` from its centre.  Returns (map, centre)."""
    if cfg.map_voxel == cfg.scan_voxel:
        ins_pts, ins_mask = front.ds_pts, front.ds_mask
    else:
        ins_pts, ins_mask = voxel_downsample(front.pts_und, mask, cfg.map_voxel,
                                             cfg.ds_capacity)
    ins_w = (ins_pts[:, :3] @ nav.ext_rot.T + nav.ext_t) @ nav.rot.T + nav.pos
    new_map = surfel_insert(st.map, ins_w, ins_mask)
    moved = torch.linalg.norm(nav.pos - st.map_center) > cfg.recenter_thresh
    if bool(moved):                                              # host sync
        new_map = surfel_trim(new_map, nav.pos, cfg.map_radius)
    return new_map, torch.where(moved, nav.pos, st.map_center)


@slam_f32
def lio_step(cfg: LioConfig, st: LioState,
             points: torch.Tensor, stamps: torch.Tensor, mask: torch.Tensor,
             imu: torch.Tensor, imu_mask: torch.Tensor,
             vel_obs: Optional[torch.Tensor] = None,
             vel_obs_valid: Optional[torch.Tensor] = None) -> Tuple[LioState, dict]:
    """Process one scan.  points (N, 3) lidar frame; stamps (N,) sec from
    scan start; imu (M, 7) [t_sec_rel, gyro, accel].  All inputs on the
    state's device.  Returns (state, info)."""
    _check_map_type(cfg)
    dev = st.P.device
    if vel_obs is None:
        vel_obs = torch.zeros(3, dtype=torch.float32, device=dev)
    if vel_obs_valid is None:
        vel_obs_valid = torch.zeros((), dtype=torch.bool, device=dev)

    with record_function("lio_step/front"):
        front = scan_front(cfg, st, points, stamps, mask, imu, imu_mask)
    nav_prop, P_prop = front.nav_prop, front.P_prop
    eye = torch.eye(ERR_DIM, dtype=torch.float32, device=dev)
    P_inv, _ = torch.linalg.inv_ex(P_prop + 1e-9 * eye)
    with record_function("lio_step/iterate"):
        nav_new, HtH, stats = _iterate(cfg, st.map, front, P_inv, vel_obs, vel_obs_valid)

    with record_function("lio_step/covariance"):
        # covariance update with the last iteration's information
        P_new, _ = torch.linalg.inv_ex(HtH + P_inv)
        P_new = 0.5 * (P_new + P_new.T)
        # If the map is not yet seeded, keep the propagated state (first scan).
        nav_new = NavState(*[torch.where(st.initialized, a, b)
                             for a, b in zip(nav_new, nav_prop)])
        P_new = torch.where(st.initialized, P_new, P_prop)

    with record_function("lio_step/map_update"):
        new_map, new_center = _update_map(cfg, st, front, mask, nav_new)

    track = front.track
    info = dict(
        num_valid=stats[0].to(torch.int32),
        num_points=front.ds_mask.to(torch.int32).sum(),
        mean_residual=stats[1] / torch.clamp(stats[0], min=1.0),
        n_degenerate=stats[2].to(torch.int32),
        n_weak=stats[3].to(torch.int32),
        pose=nav_new.pose_matrix(),
        # motion-compensated scan in the scan-end lidar frame
        points_und=front.pts_und,
        # per-IMU-sample propagated trajectory (high-rate pose source)
        imu_t=track["t"], imu_quat=track["quat"], imu_pos=track["pos"],
        vel=nav_new.vel,
    )
    new_st = LioState(nav=nav_new, P=P_new, map=new_map, map_center=new_center,
                      initialized=torch.ones((), dtype=torch.bool, device=dev),
                      step_count=st.step_count + 1)
    return new_st, info


def lio_step_batch(cfg: LioConfig, st: LioState,
                   points: torch.Tensor, stamps: torch.Tensor, mask: torch.Tensor,
                   imu: torch.Tensor, imu_mask: torch.Tensor
                   ) -> Tuple[LioState, torch.Tensor]:
    """Process K scans in order: points (K, N, 3|4), stamps (K, N), mask
    (K, N), imu (K, M, 7), imu_mask (K, M) -> (state, poses (K, 4, 4)).

    Same semantics as K sequential ``lio_step`` calls (the reference runs
    them as one ``lax.scan``)."""
    poses = []
    for k in range(points.shape[0]):
        st, info = lio_step(cfg, st, points[k], stamps[k], mask[k], imu[k], imu_mask[k])
        poses.append(info["pose"])
    return st, torch.stack(poses)
