"""Tightly-coupled LiDAR-inertial odometry: iterated error-state Kalman
filter on the 24-dim manifold state.

Counterpart of ``lsd_tpu/slam/lio.py`` with either local map: the surfel
map (per-voxel moments) or the raw-point voxel hash map (5-NN plane fits).
One scan step:

  propagate IMU -> undistort scan -> voxel-downsample -> match planes ->
  iterate (fused point-to-plane reduction, ops/p2p.py; degeneracy gate;
  optional velocity observation; 24x24 solve) -> covariance update ->
  insert scan into map -> trim map when the sensor moved far.

The reference's two ``lax.cond``s (plane re-search inside the iteration,
map trim after it) are Python ``if``s on device booleans here: one host
sync per iteration after the first, plus one per scan.  The small dense
algebra stays on the device; on CUDA the degeneracy gate's two eigen
problems are one launch of ``csrc/lio_gate.cu``, which never waits.

``lio_step`` runs the eager body (``_lio_step_eager``) for CPU tensors and
replays it as CUDA graphs, cut at the two host decisions, for CUDA tensors
(``slam/lio_graph.py``).  Both compose the same pieces below.

Spans (``utils/spans.py``): ``lio_step/front`` (``/propagate``,
``/undistort``, ``/downsample``, ``/match``), ``lio_step/iterate``
(``/research`` each time the planes are matched again, ``/gate`` each
iteration of the eager body), ``lio_step/covariance``,
``lio_step/map_update``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..ops.hashmap import (VoxelHashMap, hashmap_create, hashmap_insert, hashmap_knn,
                           hashmap_trim)
from ..ops.p2p import p2p_reduce
from ..ops.planefit import fit_planes
from ..ops.surfel import SurfelMap, surfel_create, surfel_insert, surfel_match, surfel_trim
from ..ops.voxelize import voxel_downsample
from ..utils import cuda_build
from ..utils.device import DeviceLike, resolve_device
from ..utils.precision import slam_f32
from ..utils.spans import span
from .imu import ImuNoise, propagate, undistort
from .state import ERR_DIM, GRAVITY, IDX_V, NavState, boxminus, boxplus, init_state


class LioConfig(NamedTuple):
    """Every field and default of the reference's ``LioConfig``, so configs
    carry over.  ``use_pallas_p2p`` has no effect here: the port always
    reduces through ``ops/p2p.py:p2p_reduce`` (the reference's
    ``use_pallas_p2p=True`` semantics), with either map type."""
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
    map_type: str = "surfel"         # "surfel" (moment voxels, fast) or
                                     # "points" (raw-K voxels + 5-NN fit)
    use_pallas_p2p: bool = False     # no effect in the port (see above)
    est_extrinsic: bool = False
    est_gravity: bool = False
    imu_noise: ImuNoise = ImuNoise()
    acc_scale: float = GRAVITY       # converts accel units to m/s^2


class LioState(NamedTuple):
    nav: NavState
    P: torch.Tensor              # (24, 24)
    map: Union[SurfelMap, VoxelHashMap]   # per cfg.map_type
    map_center: torch.Tensor     # (3,)
    initialized: torch.Tensor    # () bool — map seeded
    step_count: torch.Tensor     # () int32


def lio_init(cfg: LioConfig, nav: Optional[NavState] = None,
             device: DeviceLike = None) -> LioState:
    """Initial filter state; on ``nav``'s device if given, else on ``device``."""
    dev = nav.pos.device if nav is not None else resolve_device(device)
    P = torch.eye(ERR_DIM, dtype=torch.float32, device=dev) * 1e-4
    P[9:15, 9:15] = torch.eye(6, device=dev) * 1e-3    # bias uncertainty
    P[15:18, 15:18] = torch.eye(3, device=dev) * 1e-2  # gravity
    if cfg.map_type == "surfel":
        m = surfel_create(cfg.map_capacity, cfg.map_voxel, device=dev)
    else:
        m = hashmap_create(cfg.map_capacity, cfg.map_points_per_voxel, cfg.map_voxel,
                           device=dev)
    return LioState(
        nav=nav if nav is not None else init_state(device=dev),
        P=P,
        map=m,
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
                  mask: torch.Tensor, m: Union[SurfelMap, VoxelHashMap]):
    """Plane association at pose ``nav``: (normals, d, plane_ok, plane_rms).
    The raw-point map fits a plane to each point's 5 nearest map points and
    reports no thickness (plane_rms = 0)."""
    pw = (pts_l @ nav.ext_rot.T + nav.ext_t) @ nav.rot.T + nav.pos
    if isinstance(m, SurfelMap):
        return surfel_match(m, pw, mask, cfg.plane_thresh)
    nbrs, nvalid = hashmap_knn(m, pw, mask, k=5, neighborhood=cfg.neighborhood)
    normals, d, plane_ok = fit_planes(nbrs, nvalid, cfg.plane_thresh)
    return normals, d, plane_ok, torch.zeros_like(d)


def _measurement_system(cfg: LioConfig, nav: NavState, pts_l: torch.Tensor,
                        mask: torch.Tensor, m: Union[SurfelMap, VoxelHashMap],
                        planes=None):
    """Residuals and Jacobian rows of point-to-plane matching at ``nav``:
    (H (N, 24), r (N,), valid (N,), inv_var (N,)).  ``planes=None``
    matches planes at ``nav``.  The plain form of what ``ops/p2p.py``
    reduces: ``p2p_reduce`` with ``p2p_weight`` gives ``H^T W H`` and
    ``H^T W r`` of these rows, W = valid * inv_var."""
    R = nav.rot
    Re = nav.ext_rot
    pb = pts_l @ Re.T + nav.ext_t                 # body (IMU) frame
    pw = pb @ R.T + nav.pos                       # world
    if planes is None:
        planes = _match_planes(cfg, nav, pts_l, mask, m)
    normals, d, plane_ok, plane_rms = planes
    r = torch.sum(pw * normals, -1) + d

    # FAST-LIO validity gate: s = 1 - 0.9 |r| / sqrt(|p_l|)
    pnorm = torch.linalg.norm(pts_l, dim=-1)
    s = 1.0 - 0.9 * torch.abs(r) / torch.sqrt(torch.clamp(pnorm, min=1e-3))
    valid = mask & plane_ok & (s > 0.9) & (torch.abs(r) < cfg.max_resid)

    nR = normals @ R                               # n^T R, (N, 3)
    H = torch.zeros((pts_l.shape[0], ERR_DIM), dtype=pts_l.dtype, device=pts_l.device)
    H[:, 0:3] = normals
    H[:, 3:6] = -torch.linalg.cross(nR, pb)
    if cfg.est_extrinsic:
        nRRe = nR @ Re
        H[:, 18:21] = -torch.linalg.cross(nRRe, pts_l)
        H[:, 21:24] = nR
    # zero invalid rows so non-finite values of degenerate fits cannot leak
    # through the masked products (NaN * 0 = NaN)
    finite = torch.isfinite(r) & torch.all(torch.isfinite(H), dim=-1)
    valid = valid & finite
    H = torch.where(valid[:, None], H, 0.0)
    r = torch.where(valid, r, 0.0)
    # per-point measurement variance: base sigma + plane thickness
    inv_var = 1.0 / (cfg.meas_noise ** 2 + plane_rms ** 2)
    return H, r, valid, inv_var


def _gate_degenerate_plain(cfg: LioConfig, HtH: torch.Tensor):
    """Plain PyTorch version of ``_gate_degenerate`` (the CPU path and the
    version the kernel is held to)."""
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


@functools.lru_cache(maxsize=None)
def _gate_library() -> ctypes.CDLL:
    lib = cuda_build.load("lio_gate")
    lib.lio_gate_launch.restype = ctypes.c_int
    lib.lio_gate_launch.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    return lib


def _gate_degenerate(cfg: LioConfig, HtH: torch.Tensor):
    """Projection removing measurement influence along degenerate pose
    directions (eigenvalues of the 6x6 pose block below threshold), plus
    the degenerate count and the relative-degeneracy count n_weak:
    (E (24, 24), n_degenerate (), n_weak ()), int32 counts.

    As in the reference (``lio.py:207``), n_weak reads ``A[3:6, 3:6]``,
    which is the rotation block of the state layout though the reference
    calls it the translation block; this is reproduced, not fixed
    (ROADMAP queue C).

    CPU tensors take ``_gate_degenerate_plain`` (``torch.linalg``).  A CUDA
    float32 HtH is one launch of ``csrc/lio_gate.cu`` (both eigen problems
    by Jacobi in float64; no host sync, so a CUDA graph can hold it); the
    counts are views of one int32 buffer.
    """
    dev = HtH.device
    if dev.type == "cpu":
        return _gate_degenerate_plain(cfg, HtH)
    if dev.type != "cuda":
        raise ValueError(f"_gate_degenerate: unsupported device {dev}")
    if HtH.dtype is not torch.float32 or HtH.dim() != 2 or min(HtH.shape) < 6:
        raise ValueError(f"_gate_degenerate: HtH has shape {tuple(HtH.shape)} and dtype "
                         f"{HtH.dtype}, expected a float32 matrix of at least 6 x 6")
    E = torch.empty((ERR_DIM, ERR_DIM), dtype=torch.float32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    err = _gate_library().lio_gate_launch(
        HtH.data_ptr(), HtH.stride(0), HtH.stride(1), cfg.degen_thresh, cfg.degen_rel_frac,
        E.data_ptr(), counts.data_ptr(), dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"_gate_degenerate: kernel launch failed with CUDA error {err}")
    return E, counts[0], counts[1]


_gate_degenerate.launches = cuda_build.LaunchCount("lio_gate")   # counted on the device


class ScanFront(NamedTuple):
    """What a scan step computes before its Gauss-Newton iterations."""
    nav_prop: NavState
    P_prop: torch.Tensor
    track: dict
    pts_und: torch.Tensor     # (N, 3) undistorted scan, scan-end lidar frame
    ds_pts: torch.Tensor      # (ds_capacity, 3) residual points
    ds_mask: torch.Tensor     # (ds_capacity,)
    planes: tuple             # _match_planes at nav_prop


def _downsample(cfg: LioConfig, pts_und: torch.Tensor, mask: torch.Tensor):
    """The residual points: (ds_pts (ds_capacity, 3), ds_mask)."""
    ds_pts, ds_mask = voxel_downsample(pts_und, mask, cfg.scan_voxel, cfg.ds_capacity)
    return ds_pts[:, :3].contiguous(), ds_mask


def scan_front(cfg: LioConfig, st: LioState, points: torch.Tensor,
               stamps: torch.Tensor, mask: torch.Tensor, imu: torch.Tensor,
               imu_mask: torch.Tensor) -> ScanFront:
    """IMU propagation, undistortion, downsample and the first plane match."""
    with span("lio_step/front/propagate"):
        nav_prop, P_prop, track = propagate(st.nav, st.P, imu, imu_mask,
                                            cfg.imu_noise, cfg.acc_scale)
    with span("lio_step/front/undistort"):
        pts_und = undistort(points[:, :3], stamps, mask, nav_prop, track)
    with span("lio_step/front/downsample"):
        ds_pts, ds_mask = _downsample(cfg, pts_und, mask)
    with span("lio_step/front/match"):
        planes = _match_planes(cfg, nav_prop, ds_pts, ds_mask, st.map)
    return ScanFront(nav_prop, P_prop, track, pts_und, ds_pts, ds_mask, planes)


def p2p_weight(cfg: LioConfig, ds_mask: torch.Tensor, planes) -> torch.Tensor:
    """Per-point weight of the fused reduction: inverse measurement variance
    (base sigma + plane thickness) where the point and its plane are valid."""
    _, _, plane_ok, plane_rms = planes
    inv_var = 1.0 / (cfg.meas_noise ** 2 + plane_rms ** 2)
    return torch.where(ds_mask & plane_ok, inv_var, 0.0)


def _prior_information(P_prop: torch.Tensor) -> torch.Tensor:
    """The propagated covariance's inverse, which every iteration adds."""
    eye = torch.eye(ERR_DIM, dtype=torch.float32, device=P_prop.device)
    P_inv, _ = torch.linalg.inv_ex(P_prop + 1e-9 * eye)
    return P_inv


def _iteration_weights(cfg: LioConfig, vel_obs_valid: torch.Tensor):
    """(update mask (24,), velocity observation weight ()) of the iterations."""
    upd_mask = _update_mask(cfg, vel_obs_valid.device)
    return upd_mask, torch.where(vel_obs_valid, 1.0 / (cfg.vel_noise ** 2), 0.0)


def _research_due(cfg: LioConfig, nav_i: NavState, anchor) -> torch.Tensor:
    """Whether the iterate moved beyond ``research_thresh`` from the pose
    ``anchor`` = (pos, quat) its planes were matched at (FAST-LIO's
    converge/rematch flag), as a device bool."""
    d_t = torch.linalg.norm(nav_i.pos - anchor[0])
    d_r = torch.linalg.norm(nav_i.quat - anchor[1] *
                            torch.sign(torch.sum(nav_i.quat * anchor[1])))
    return (d_t + 20.0 * d_r) > cfg.research_thresh


def _gn_step(cfg: LioConfig, nav_i: NavState, nav_prop: NavState, ds_pts: torch.Tensor,
             ds_mask: torch.Tensor, planes, P_inv: torch.Tensor, upd_mask: torch.Tensor,
             vw: torch.Tensor, vel_obs: torch.Tensor):
    """One Gauss-Newton iteration at ``nav_i`` on the plane set ``planes``:
    (next iterate, gated HtH + velocity information, stats [n_valid,
    sum |r|, n_degenerate, n_weak])."""
    normals, dpl, _, _ = planes
    HtH, Htr, pstats = p2p_reduce(
        ds_pts, normals, dpl, p2p_weight(cfg, ds_mask, planes),
        nav_i.rot, nav_i.ext_rot, nav_i.ext_t, nav_i.pos, cfg.max_resid,
        est_extrinsic=cfg.est_extrinsic)
    n_pts_valid, sum_abs_r = pstats[0], pstats[1]
    with span("lio_step/iterate/gate"):
        E, n_degen, n_weak = _gate_degenerate(cfg, HtH)
    HtH = E @ HtH @ E.T
    Htr = E @ Htr
    # velocity observation: fixed weight when the geometry is
    # well-conditioned, scaled with the competing point count when any
    # pose axis is (relatively) degenerate
    vw_i = vw * torch.where((n_degen > 0) | (n_weak > 0),
                            torch.clamp(cfg.vel_obs_point_frac * n_pts_valid, min=1.0),
                            1.0)
    HtH[IDX_V, IDX_V] += torch.eye(3, device=HtH.device) * vw_i
    Htr[IDX_V] += vw_i * (nav_i.vel - vel_obs)

    delta = boxminus(nav_i, nav_prop)
    A = HtH + P_inv
    b = Htr + P_inv @ delta
    sol, _ = torch.linalg.solve_ex(A, b)
    dx = -sol * upd_mask
    stats = torch.stack([n_pts_valid, sum_abs_r,
                         n_degen.to(torch.float32), n_weak.to(torch.float32)])
    return boxplus(nav_i, dx), HtH, stats


def _iterate(cfg: LioConfig, m: Union[SurfelMap, VoxelHashMap], front: ScanFront,
             P_inv: torch.Tensor, vel_obs: torch.Tensor, vel_obs_valid: torch.Tensor):
    """The Gauss-Newton iterations: (nav, gated HtH + velocity info of the
    last iteration, stats [n_valid, sum |r|, n_degenerate, n_weak])."""
    dev = P_inv.device
    nav_prop = front.nav_prop
    upd_mask, vw = _iteration_weights(cfg, vel_obs_valid)
    # the iterations reuse the plane set unless the iterate moved beyond
    # research_thresh from the pose it was matched at; the last iteration's
    # information matrix feeds the covariance update
    nav_i = nav_prop
    planes = front.planes
    anchor = (nav_prop.pos, nav_prop.quat)
    HtH = torch.zeros((ERR_DIM, ERR_DIM), dtype=torch.float32, device=dev)
    stats = torch.zeros(4, dtype=torch.float32, device=dev)
    for it in range(cfg.max_iters):
        # the first iterate is the anchor itself, so its test is always
        # false and is skipped (one host sync fewer per scan)
        if (cfg.research_thresh > 0 and it > 0
                and bool(_research_due(cfg, nav_i, anchor))):            # host sync
            with span("lio_step/iterate/research"):
                planes = _match_planes(cfg, nav_i, front.ds_pts, front.ds_mask, m)
            anchor = (nav_i.pos, nav_i.quat)
        nav_i, HtH, stats = _gn_step(cfg, nav_i, nav_prop, front.ds_pts, front.ds_mask,
                                     planes, P_inv, upd_mask, vw, vel_obs)
    return nav_i, HtH, stats


def _covariance(initialized: torch.Tensor, front: ScanFront, nav_i: NavState,
                HtH: torch.Tensor, P_inv: torch.Tensor):
    """Covariance update with the last iteration's information: (nav, P).
    If the map is not yet seeded, the propagated state is kept (first scan)."""
    P_new, _ = torch.linalg.inv_ex(HtH + P_inv)
    P_new = 0.5 * (P_new + P_new.T)
    nav_new = NavState(*[torch.where(initialized, a, b)
                         for a, b in zip(nav_i, front.nav_prop)])
    return nav_new, torch.where(initialized, P_new, front.P_prop)


def _insert_scan(cfg: LioConfig, m: Union[SurfelMap, VoxelHashMap], center: torch.Tensor,
                 front: ScanFront, mask: torch.Tensor, nav: NavState):
    """Insert the scan at pose ``nav``: (map, whether the sensor moved
    ``recenter_thresh`` from the map's centre ``center`` (a device bool),
    the centre after the trim that this calls for)."""
    if cfg.map_voxel == cfg.scan_voxel:
        ins_pts, ins_mask = front.ds_pts, front.ds_mask
    else:
        ins_pts, ins_mask = voxel_downsample(front.pts_und, mask, cfg.map_voxel,
                                             cfg.ds_capacity)
    ins_w = (ins_pts[:, :3] @ nav.ext_rot.T + nav.ext_t) @ nav.rot.T + nav.pos
    insert_fn = surfel_insert if isinstance(m, SurfelMap) else hashmap_insert
    new_map = insert_fn(m, ins_w, ins_mask)
    moved = torch.linalg.norm(nav.pos - center) > cfg.recenter_thresh
    return new_map, moved, torch.where(moved, nav.pos, center)


def _trim(cfg: LioConfig, m: Union[SurfelMap, VoxelHashMap], pos: torch.Tensor):
    """The map cut to ``map_radius`` around ``pos``."""
    trim_fn = surfel_trim if isinstance(m, SurfelMap) else hashmap_trim
    return trim_fn(m, pos, cfg.map_radius)


def _update_map(cfg: LioConfig, st: LioState, front: ScanFront, mask: torch.Tensor,
                nav: NavState) -> Tuple[Union[SurfelMap, VoxelHashMap], torch.Tensor]:
    """Insert the scan at pose ``nav``; trim the map when the sensor moved
    ``recenter_thresh`` from its centre.  Returns (map, centre)."""
    new_map, moved, center = _insert_scan(cfg, st.map, st.map_center, front, mask, nav)
    if bool(moved):                                              # host sync
        new_map = _trim(cfg, new_map, nav.pos)
    return new_map, center


def _step_info(front: ScanFront, stats: torch.Tensor, nav_new: NavState) -> dict:
    """The step's ``info``."""
    track = front.track
    return dict(
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


def _velocity_observation(dev: torch.device, vel_obs: Optional[torch.Tensor],
                          vel_obs_valid: Optional[torch.Tensor]):
    """The velocity observation and its flag, zeros and false when not given."""
    if vel_obs is None:
        vel_obs = torch.zeros(3, dtype=torch.float32, device=dev)
    if vel_obs_valid is None:
        vel_obs_valid = torch.zeros((), dtype=torch.bool, device=dev)
    return vel_obs, vel_obs_valid


def _lio_step_eager(cfg: LioConfig, st: LioState,
                    points: torch.Tensor, stamps: torch.Tensor, mask: torch.Tensor,
                    imu: torch.Tensor, imu_mask: torch.Tensor,
                    vel_obs: Optional[torch.Tensor] = None,
                    vel_obs_valid: Optional[torch.Tensor] = None) -> Tuple[LioState, dict]:
    """The scan step as eager PyTorch: what ``lio_step`` runs for CPU
    tensors, and replays as CUDA graphs for CUDA tensors."""
    dev = st.P.device
    vel_obs, vel_obs_valid = _velocity_observation(dev, vel_obs, vel_obs_valid)

    with span("lio_step/front"):
        front = scan_front(cfg, st, points, stamps, mask, imu, imu_mask)
    P_inv = _prior_information(front.P_prop)
    with span("lio_step/iterate"):
        nav_i, HtH, stats = _iterate(cfg, st.map, front, P_inv, vel_obs, vel_obs_valid)

    with span("lio_step/covariance"):
        nav_new, P_new = _covariance(st.initialized, front, nav_i, HtH, P_inv)

    with span("lio_step/map_update"):
        new_map, new_center = _update_map(cfg, st, front, mask, nav_new)

    new_st = LioState(nav=nav_new, P=P_new, map=new_map, map_center=new_center,
                      initialized=torch.ones((), dtype=torch.bool, device=dev),
                      step_count=st.step_count + 1)
    return new_st, _step_info(front, stats, nav_new)


@slam_f32
def lio_step(cfg: LioConfig, st: LioState,
             points: torch.Tensor, stamps: torch.Tensor, mask: torch.Tensor,
             imu: torch.Tensor, imu_mask: torch.Tensor,
             vel_obs: Optional[torch.Tensor] = None,
             vel_obs_valid: Optional[torch.Tensor] = None) -> Tuple[LioState, dict]:
    """Process one scan.  points (N, 3) lidar frame; stamps (N,) sec from
    scan start; imu (M, 7) [t_sec_rel, gyro, accel].  All inputs on the
    state's device.  Returns (state, info).

    CPU tensors run ``_lio_step_eager``.  CUDA tensors replay it as CUDA
    graphs (``slam/lio_graph.py``): the state passed in is not modified, and
    the returned state and info share no memory with the graphs."""
    if st.P.device.type == "cuda":
        return lio_graph.step(cfg, st, points, stamps, mask, imu, imu_mask,
                              vel_obs, vel_obs_valid)
    lio_graph.counters["eager"] += 1
    return _lio_step_eager(cfg, st, points, stamps, mask, imu, imu_mask,
                           vel_obs, vel_obs_valid)


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


# the graph runner composes this module's pieces; imported last, as it
# imports this module
from . import lio_graph  # noqa: E402
