"""Mapping orchestrator: LIO front-end + pose-graph back-end (counterpart of
``lsd_tpu/slam/mapper.py``).

Host-side bookkeeping around numeric stages that run on the mapper's
device:

    per scan:  lio_step (ESIKF odometry)
    keyframe gate -> store cloud + ScanContext descriptor + odom edge
    loop detect: distance-gated candidates -> ScanContext match ->
                 point-to-plane ICP verify -> loop edge
    every N keyframes: posegraph optimize -> update keyframe poses
    save: LSD-format map directory (map_io.save_map)
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..calibration.lidar import ransac_ground_plane
from ..geometry import np_so3, so3
from ..ops.surfel import surfel_create, surfel_insert
from ..ops.voxelize import voxel_downsample
from ..utils.device import DeviceLike, resolve_device, to_device
from ..utils.spans import span
from .graph_builder import PoseGraphBuilder
from .keyframe import Keyframe, KeyframeStore, KeyframeUpdater
from .lio import LioConfig, lio_init, lio_step
from .map_io import save_map
from .posegraph import PgoConfig, optimize
from .registration import icp_point_to_plane, pad_pow2
from .scancontext import make_descriptor, sc_db_add, sc_db_create, sc_query


# a graph job running this long counts as wedged (see Mapper._enqueue_graph_job)
WEDGED_S = 30.0


def _kf_downsample(pts_und, mask, voxel: float, cap: int):
    """Keyframe-cloud downsample on the device from the still-resident
    undistorted scan (see _scan_step)."""
    pts4 = torch.cat([pts_und, pts_und.new_zeros((pts_und.shape[0], 1))], dim=1)
    return voxel_downsample(pts4, mask, voxel, cap)


def _fetch_cloud(ds: torch.Tensor, dm: torch.Tensor) -> np.ndarray:
    """The valid rows of a downsampled cloud (cap, 4) on the host, in one
    fetch (points and mask packed together)."""
    ds_h = torch.cat([ds, dm.to(ds.dtype)[:, None]], dim=1).cpu().numpy()
    return ds_h[ds_h[:, 4] > 0, :4]


def _scan_step(cfg, st, points, stamps, mask, imu, imu_mask,
               vel_obs, vel_obs_valid, kf_voxel: float, kf_cap: int):
    """LIO step + keyframe material, issued together.

    The keyframe cloud (0.25 m downsample of the undistorted scan) and the
    ScanContext descriptor are computed from the scan while it is still on
    the device: nothing is re-uploaded, a keyframe fetches only the small
    downsampled cloud, and the descriptor goes to the graph work as a
    device tensor."""
    st2, info = lio_step(cfg, st, points, stamps, mask, imu, imu_mask,
                         vel_obs, vel_obs_valid)
    with span("mapper/keyframe_material"):
        kf_cloud = _kf_downsample(info["points_und"], mask, kf_voxel, kf_cap)
        kf_desc = make_descriptor(info["points_und"], mask)
    return st2, info, kf_cloud, kf_desc


@dataclasses.dataclass
class MapperConfig:
    lio: LioConfig = dataclasses.field(default_factory=LioConfig)
    pgo: PgoConfig = dataclasses.field(default_factory=PgoConfig)
    keyframe_delta_trans: float = 2.0
    keyframe_delta_angle: float = 0.2618
    keyframe_cloud_voxel: float = 0.25
    keyframe_cloud_cap: int = 16384
    loop_min_distance: float = 15.0       # accum travel before loop accepted
    loop_search_radius: float = 20.0      # candidate gate (m)
    loop_sc_thresh: float = 0.3
    loop_fitness_thresh: float = 0.4
    # loop VERIFICATION quality (the edge the optimizer trusts): fine
    # target map + residual gate + fitness-scaled information.  A loop
    # edge only helps if its ICP error is below the odometry drift it is
    # meant to correct; a coarse verification map produced ~0.2 m-biased
    # edges that DEGRADED an mm-accurate graph.
    loop_icp_iters: int = 20
    loop_map_voxel: float = 0.25
    loop_map_capacity: int = 2 ** 17
    loop_window: int = 8                  # +-keyframes of odometry-rigid
                                          # context around the candidate
    # odometry-edge information (1/sigma^2).  The LIO's relative accuracy
    # over a 2 m keyframe interval is mm-level, so sigma_t = 1 cm /
    # sigma_rot = 5 mrad is already conservative; a much lower weight
    # lets GPS prior noise (sigma 5-10 cm) deform the graph.
    odom_rot_info: float = 4.0e4
    odom_trans_info: float = 1.0e4
    # run descriptor/loop-detection/PGO on a background worker thread so
    # the per-scan odometry path never blocks on graph work (odometry
    # publishes at sensor rate, the graph follows).  Synchronous by default
    # for deterministic unit tests.
    async_graph: bool = False
    # one-frame-deep pipelined device fetch: issue scan k's step, then
    # complete scan k-1, whose small outputs (pose, tracking arrays) are
    # fetched after scan k's work is queued.  The published live pose is
    # IMU-extrapolated to the current stamp (get_timed_pose).  Off by
    # default for deterministic unit tests.
    async_fetch: bool = False
    loop_max_residual: float = 0.08       # mean |p2plane| acceptance (m)
    loop_min_inliers: int = 200           # absolute aligned-point floor
    # information from the ICP Hessian (ref: hdl_graph_slam
    # information_matrix_calculator.cpp role, derived from the actual
    # Gauss-Newton normal matrix): per-axis info = discount / diag(cov),
    # capped at loop_info_max.  Sliding directions (corridor axis,
    # ground-only yaw) get near-zero info so a partially-constrained
    # match can't drag the graph along its unconstrained axes.
    # ``loop_info_discount`` converts the noise-derived covariance into
    # an honest bound on SYSTEMATIC error (plane-normal bias dominates
    # point noise at a few hundred inliers).
    loop_info_discount: float = 0.02
    loop_info_max: float = 400.0
    # gross-mismatch gate: reject corrections beyond plausible drift
    loop_max_correction_t: float = 3.0    # m
    loop_max_correction_deg: float = 30.0
    optimize_every: int = 10              # keyframes between PGO runs
    gps_info: float = 0.25                # 1/sigma^2 for GPS priors
    # GNSS altitude is a different datum than the map's z (and far
    # noisier than RTK xy); the reference constrains XY only by default
    # (hdl_graph_slam gps_edge_stddev_xy).  Enable z only with a
    # surveyed altitude datum.
    gps_use_z: bool = False
    orient_info: float = 1.0              # 1/sigma^2 for IMU/INS attitude
                                          # priors (hdl_graph_slam_nodelet
                                          # .cpp:462-521 imu_orientation)
    use_floor_prior: bool = False         # RANSAC floor -> z/tilt factor
    floor_z_info: float = 25.0
    floor_tilt_info: float = 10.0


class Mapper:
    def __init__(self, cfg: MapperConfig = MapperConfig(), nav0=None,
                 device: DeviceLike = None):
        """nav0: optional initial NavState (e.g. from GNSS/INS or a known
        map pose); default starts at the identity, which is the map frame
        for GNSS-less mapping.  The mapper runs on ``nav0``'s device if
        given, else on ``device`` (CUDA unless named).  Every tensor it
        makes names that device, so the graph worker thread never depends
        on a thread's current device."""
        self.cfg = cfg
        self.device = nav0.pos.device if nav0 is not None else resolve_device(device)
        self.lio_state = lio_init(cfg.lio, nav0, device=self.device)
        self.updater = KeyframeUpdater(cfg.keyframe_delta_trans, cfg.keyframe_delta_angle)
        self.store = KeyframeStore()
        self.graph = PoseGraphBuilder()
        self.sc_db = sc_db_create(capacity=4096, device=self.device)
        self.sc_ids: List[int] = []       # sc slot -> keyframe id
        self.odometry: List[Tuple[int, np.ndarray]] = []
        self.loops: List[Tuple[int, int]] = []
        # loop-gate observability: why candidates were rejected
        self.loop_stats: Dict[str, int] = dict(
            sc=0, radius=0, travel=0, target=0, fitness=0, residual=0,
            correction=0, accepted=0)
        self.origin_lla: Optional[np.ndarray] = None
        # MAP-FRAME position paired with origin_lla: the map frame is not
        # necessarily anchored at (0,0,0) at the origin fix (a run
        # seeded/relocalized mid-map starts elsewhere), so consumers
        # projecting GNSS into the map frame need the pair.
        self.origin_anchor_xyz: Optional[np.ndarray] = None
        # cache of the newest loop-verification target maps (see _detect_loop)
        self._loop_target_cache: Dict = {}
        self._kf_since_opt = 0
        # graph mutations happen on two threads under async_graph (main:
        # nodes/odom edges/priors; worker: loop edges + optimize)
        self._graph_lock = threading.RLock()
        # PGO solves run OUTSIDE _graph_lock (optimize_graph); editor
        # operations that renumber node ids bump this version so an
        # in-flight solve result is discarded instead of written back
        self._graph_struct_version = 0
        self._opt_lock = threading.Lock()
        self._worker_q: Optional[_queue.Queue] = None
        # what the graph worker's jobs raised: the worker prints each and
        # goes on to the next keyframe, and a caller that must know whether
        # the graph work was done reads this after flush()
        self.worker_errors: List[BaseException] = []
        self._job_since: Optional[float] = None   # when the worker's job began
        if cfg.async_graph:
            self._worker_q = _queue.Queue(maxsize=8)
            self._worker = threading.Thread(target=self._graph_worker,
                                            name="graph-worker", daemon=True)
            self._worker.start()
        # map-frame correction of the raw LIO odometry, refreshed on every
        # graph optimization and composed into every published pose
        # (ref: hdl_graph_slam_nodelet.cpp:600-651 trans_odom2map broadcast,
        # applied at :287 when publishing)
        self.odom2map = np.eye(4)

    # ------------------------------------------------------------------
    def process_scan(self, points, stamps, mask, imu, imu_mask,
                     stamp_us: int = 0, gps_xyz=None, gps_info=None,
                     vel_obs=None, vel_obs_valid=None,
                     images=None, orient_quat=None) -> Dict:
        """Feed one (padded) scan; returns dict(pose, is_keyframe, info).

        With cfg.async_fetch the returned dict describes the PREVIOUS
        scan (its stamp/pose are recorded under its own timestamp), plus
        ``live_pose`` — the IMU-extrapolated pose at THIS scan's stamp —
        and the very first call returns pose=None."""
        cfg = self.cfg
        dev = self.device

        def up(a, dtype=None):
            # tensors already on the device pass through without a copy
            return to_device(a, dev, dtype)
        mask = up(mask)
        imu_mask = up(imu_mask)
        # LIO step + keyframe cloud + descriptor (see _scan_step)
        self.lio_state, info, kf_cloud, kf_desc = _scan_step(
            cfg.lio, self.lio_state, up(points), up(stamps), mask, up(imu), imu_mask,
            None if vel_obs is None else up(vel_obs, torch.float32),
            None if vel_obs_valid is None else up(vel_obs_valid, torch.bool),
            cfg.keyframe_cloud_voxel, cfg.keyframe_cloud_cap)
        # everything the host consumes per scan, packed for ONE fetch:
        # pose, the high-rate IMU track, velocity and the IMU sample count
        packed = torch.cat([
            info["pose"].reshape(-1), info["imu_t"], info["imu_quat"].reshape(-1),
            info["imu_pos"].reshape(-1), info["vel"],
            imu_mask.sum().to(torch.float32)[None]])
        job = dict(stamp_us=stamp_us, info=info, mask=mask, packed=packed,
                   kf_cloud=kf_cloud, kf_desc=kf_desc,
                   gps_xyz=gps_xyz, gps_info=gps_info, images=images,
                   orient_quat=orient_quat)
        if not cfg.async_fetch:
            return self._complete_scan(job)
        prev, self._pending = getattr(self, "_pending", None), job
        if prev is None:
            return dict(pose=None, odom=None, is_keyframe=False, loop=None,
                        info={})
        out = self._complete_scan(prev)
        live = self.get_timed_pose(stamp_us)
        out["live_pose"] = live if live is not None else out["pose"]
        return out

    def _complete_scan(self, job: Dict) -> Dict:
        """Fetch a dispatched scan's results and run keyframe/graph work
        (the host-side half of the pipelined step)."""
        info, stamp_us, mask = job["info"], job["stamp_us"], job["mask"]
        # ONE device fetch (one host sync) for everything the host consumes
        # per scan: see process_scan for the layout
        with span("mapper/fetch"):
            flat = job["packed"].cpu().numpy()
        m = info["imu_t"].shape[0]
        pose_f, t_f, q_f, p_f, v_f, n_imu = np.split(
            flat, np.cumsum([16, m, 4 * m, 3 * m, 3]))
        odom_pose = pose_f.reshape(4, 4).astype(float)
        # n_imu bounds the VALID prefix: the imu buffers are padded to
        # capacity and padding stamps convert to large negative t, which
        # get_timed_pose must never read
        self._track = dict(stamp_us=stamp_us, t=t_f,
                           quat=q_f.reshape(m, 4), pos=p_f.reshape(m, 3),
                           vel=v_f, end_pose=odom_pose,
                           n_imu=int(n_imu[0]))

        is_kf = self.updater.is_update(odom_pose)
        loop = None
        if is_kf:
            # keyframe cloud = UNDISTORTED scan (scan-end lidar frame,
            # matching the scan-end keyframe pose); the raw sweep skews
            # by v * sweep_time and biases loop ICP + saved maps.
            # Downsample + descriptor were issued at scan time
            # (process_scan): one small fetch here, nothing re-uploaded.
            cloud = _fetch_cloud(*job["kf_cloud"])
            loop = self._add_keyframe(None, mask, odom_pose, stamp_us,
                                      job["gps_xyz"],
                                      gps_info=job["gps_info"],
                                      images=job["images"],
                                      orient_quat=job["orient_quat"],
                                      cloud=cloud, desc=job["kf_desc"])
        # publish in the map frame: graph corrections (loop closures, GPS)
        # snap the live pose, not just the stored keyframes
        pose = self.odom2map @ odom_pose
        self.odometry.append((stamp_us, pose))
        return dict(pose=pose, odom=odom_pose, is_keyframe=is_kf, loop=loop,
                    info=info)

    def finish_pending(self) -> Optional[Dict]:
        """Complete the in-flight pipelined scan, if any (called at end
        of stream / before save so the trajectory covers every scan)."""
        job = getattr(self, "_pending", None)
        if job is None:
            return None
        self._pending = None
        return self._complete_scan(job)

    # ------------------------------------------------------------------
    def _add_keyframe(self, points, mask, odom_pose, stamp_us, gps_xyz,
                      gps_info=None, images=None, orient_quat=None,
                      cloud=None, desc=None):
        """``cloud``/``desc``: pre-computed keyframe material from the
        pipelined device dispatch (process_scan).  Callers without it
        (RTKM) pass raw ``points`` and pay the downsample round trip."""
        cfg = self.cfg
        pts4 = None
        if cloud is None:
            pts4 = np.asarray(points, np.float32)
            if pts4.shape[1] == 3:
                pts4 = np.concatenate(
                    [pts4, np.zeros((len(pts4), 1), np.float32)], 1)
            cloud = _fetch_cloud(*voxel_downsample(
                to_device(pts4, self.device), to_device(mask, self.device),
                cfg.keyframe_cloud_voxel, cfg.keyframe_cloud_cap))

        # node enters the graph in the map frame so it is consistent with
        # already-optimized neighbours (ref hdl_graph_slam flush_keyframe_queue
        # odom2map * keyframe->odom)
        pose = self.odom2map @ odom_pose
        kf = Keyframe(id=-1, stamp_us=stamp_us, pose=pose.copy(),
                      odom=odom_pose.copy(),
                      cloud=cloud, images=dict(images or {}),
                      accum_distance=self.updater.accum_distance)
        kid = self.store.add(kf)
        with self._graph_lock:
            self.graph.add_node(pose, fixed=(kid == 0))
            if kid > 0:
                prev = self.store[kid - 1]
                T_rel = np.linalg.inv(prev.odom) @ kf.odom
                self.graph.add_se3_edge(kid - 1, kid, T_rel,
                                        rot_info=cfg.odom_rot_info,
                                        trans_info=cfg.odom_trans_info)
            if gps_xyz is not None:
                self.graph.add_gps_prior(kid, gps_xyz,
                                         xy_only=not cfg.gps_use_z,
                                         info=(gps_info if gps_info is not None
                                               else cfg.gps_info))
            if orient_quat is not None:
                # IMU/INS attitude prior on the keyframe (ref
                # hdl_graph_slam_nodelet.cpp:462-521 imu_orientation edges)
                self.graph.add_orientation_prior(
                    kid, np.asarray(orient_quat, np.float32),
                    info=cfg.orient_info)
            if cfg.use_floor_prior:
                self._add_floor_prior(kid, cloud)

        if self._worker_q is not None:
            self._enqueue_graph_job((kid, desc, pts4, mask))
            return None
        return self._kf_graph_work(kid, desc, pts4, mask)

    def _enqueue_graph_job(self, job) -> None:
        """Graph work off the odometry path.  A wedged worker must NOT stall
        odometry indefinitely: when the bounded queue stays full past a
        short timeout and the worker's job has run for ``WEDGED_S``, drop
        the OLDEST pending job (its keyframe keeps node + odometry edge;
        only its descriptor/loop chance is lost) and coalesce in the new
        one.  A worker on a shorter job is only slower than the scans (a
        replay faster than the sensor): odometry waits for it."""
        while True:
            try:
                self._worker_q.put(job, timeout=2.0)
                return
            except _queue.Full:
                since = self._job_since
                if not (self._worker.is_alive() and
                        (since is None or time.monotonic() - since < WEDGED_S)):
                    break
        try:
            self._worker_q.get_nowait()
            self._worker_q.task_done()
            self.loop_stats["dropped_jobs"] = \
                self.loop_stats.get("dropped_jobs", 0) + 1
        except _queue.Empty:
            pass
        try:
            self._worker_q.put_nowait(job)
        except _queue.Full:      # worker still wedged: shed
            self.loop_stats["dropped_jobs"] = \
                self.loop_stats.get("dropped_jobs", 0) + 1

    # ------------------------------------------------------------------
    def _kf_graph_work(self, kid, desc, pts4, mask):
        """Loop detection + periodic PGO for one keyframe (worker thread
        under async_graph, inline otherwise).  ``desc`` is the device-
        resident ScanContext descriptor issued at scan time; when absent
        (callers that pass raw points) it is computed here."""
        cfg = self.cfg
        if desc is None:
            desc = make_descriptor(to_device(pts4[:, :3], self.device),
                                   to_device(mask, self.device))
        loop = self._detect_loop(kid, desc)
        self.sc_db = sc_db_add(self.sc_db, desc)
        self.sc_ids.append(kid)

        self._kf_since_opt += 1
        if self._kf_since_opt >= cfg.optimize_every:
            self.optimize_graph()
        return loop

    def _graph_worker(self) -> None:
        while True:
            job = self._worker_q.get()
            if job is None:
                self._worker_q.task_done()
                return
            self._job_since = time.monotonic()
            try:
                self._kf_graph_work(*job)
            except Exception as exc:
                self.worker_errors.append(exc)
                traceback.print_exc()
            finally:
                self._job_since = None
                self._worker_q.task_done()

    def flush(self) -> None:
        """Drain the in-flight pipelined scan and pending background
        graph work (no-op when synchronous)."""
        self.finish_pending()
        if self._worker_q is not None:
            self._worker_q.join()

    def close(self) -> None:
        """Stop the background graph worker (idempotent).  Without this,
        every async Mapper leaks its daemon worker for the life of the
        process across module restarts."""
        if self._worker_q is not None:
            self._worker_q.join()
            self._worker_q.put(None)
            self._worker.join(timeout=10.0)
            self._worker_q = None

    # ------------------------------------------------------------------
    def _add_floor_prior(self, kid: int, cloud: np.ndarray) -> None:
        """RANSAC the keyframe's ground plane (sensor frame) and add a
        z+tilt factor (ref: hdl floor_detection_nodelet -> floor edges,
        hdl_graph_slam_nodelet.cpp:523-597)."""
        low = cloud[cloud[:, 2] <= np.percentile(cloud[:, 2], 30) + 0.05]
        if len(low) < 100:
            return
        n, d, inl = ransac_ground_plane(low[:, :3], iters=50)
        if inl.mean() < 0.5 or abs(n[2]) < 0.9:   # not a credible floor
            return
        kf = self.store[kid]
        # sensor height above the local floor (plane n.p + d = 0 in the
        # sensor frame -> origin distance is |d|)
        sensor_h = float(abs(d))
        z_floor_world = kf.pose[2, 3] - sensor_h
        # hdl assumes one planar floor: the first detection sets the datum
        # and later keyframes are constrained to the same floor height
        if not hasattr(self, "_floor_datum"):
            self._floor_datum = z_floor_world
        self.graph.add_floor_prior(kid, self._floor_datum + sensor_h,
                                   z_info=self.cfg.floor_z_info,
                                   tilt_info=self.cfg.floor_tilt_info)

    # ------------------------------------------------------------------
    def _detect_loop(self, kid: int, desc) -> Optional[Tuple[int, int]]:
        cfg = self.cfg
        kf = self.store[kid]
        if kf.accum_distance < cfg.loop_min_distance or len(self.sc_ids) < 5:
            return None
        with span("mapper/sc_query"):
            idx, dist, yaw = sc_query(self.sc_db, desc, num_candidates=10,
                                      exclude_recent=5)
            # one fetch (the index, below 2**24, is exact in float32)
            idx, dist, yaw = torch.stack([idx.to(torch.float32), dist, yaw]).cpu().tolist()
        idx = int(idx)
        if idx < 0 or idx >= len(self.sc_ids) or dist > cfg.loop_sc_thresh:
            self.loop_stats["sc"] += 1
            return None
        cand = self.sc_ids[idx]
        cand_kf = self.store[cand]
        # distance gate in current pose estimates
        if np.linalg.norm(cand_kf.pose[:3, 3] - kf.pose[:3, 3]) > cfg.loop_search_radius:
            self.loop_stats["radius"] += 1
            return None
        # travel-distance gate (avoid adjacent-keyframe "loops")
        if kf.accum_distance - cand_kf.accum_distance < cfg.loop_min_distance:
            self.loop_stats["travel"] += 1
            return None
        # verify with ICP in the CANDIDATE's odometry-rigid frame: the
        # target is a contiguous keyframe window posed by raw odometry
        # relative to the candidate (merged_cloud_relative) — rigid and
        # immune to pose-graph deformation, so a previous bad optimization
        # cannot bias new loop edges (world-frame targets would mix
        # inconsistently-dragged poses).  The ICP result IS the edge
        # measurement T_i^-1 T_j directly.
        w = cfg.loop_window
        ids = [i for i in range(max(cand - w, 0),
                                min(cand + w, len(self.store) - 1) + 1)
               if abs(i - kid) > 2]
        # cache the verification surfel map per (candidate, window):
        # the odometry-rigid target is DETERMINISTIC (raw odometry never
        # changes, clouds are immutable outside editor ops which clear
        # the cache), and building and uploading it is a large part of the
        # check's cost; loop bursts revisit nearby candidates within a few
        # keyframes (the 8 newest are kept).
        ck = (cand, ids[0], ids[-1])
        m = self._loop_target_cache.get(ck)
        if m is None:
            target = self.store.merged_cloud_relative(ids, cand,
                                                      max_points=2 ** 16)
            if len(target) < 1000:
                self.loop_stats["target"] += 1
                return None
            with span("mapper/loop_target"):
                m = surfel_create(capacity=cfg.loop_map_capacity,
                                  voxel_size=cfg.loop_map_voxel, device=self.device)
                m = surfel_insert(m, *pad_pow2(target, self.device))
            self._loop_target_cache[ck] = m
            while len(self._loop_target_cache) > 8:
                self._loop_target_cache.pop(
                    next(iter(self._loop_target_cache)))
        else:
            self.loop_stats["target_cache_hits"] = \
                self.loop_stats.get("target_cache_hits", 0) + 1

        # initial guess: current graph estimate of the relative pose
        # (an estimate only: the measurement basis is pure odometry)
        T0 = np.linalg.inv(cand_kf.pose) @ kf.pose
        with span("mapper/icp_verify"):
            src_pad, smask = pad_pow2(kf.cloud, self.device)
            T0_d = to_device(T0[:3], self.device, torch.float32)
            q, t, icp_info = icp_point_to_plane(
                m, src_pad, smask, so3.matrix_to_quat(T0_d[:, :3]), T0_d[:, 3],
                iters=cfg.loop_icp_iters, plane_thresh=0.1, max_dist=0.5,
                min_points=4)   # the fine local map is sparse per voxel
            # ONE fetch of every scalar/array the gates consume
            flat = torch.cat([
                q, t, torch.stack([icp_info["inlier_ratio"], icp_info["n_inliers"],
                                   icp_info["mean_residual"]]),
                icp_info["JtJ"].reshape(-1)]).cpu().numpy()
        q_h, t_h, (inl_ratio, n_inl, mean_res), JtJ_h = \
            flat[:4], flat[4:7], flat[7:10], flat[10:].reshape(6, 6)
        # quality = inlier ratio among source points with a target plane
        # (coverage-independent — the verification map is LOCAL, so plain
        # fitness is capped by the overlap fraction) + an absolute inlier
        # floor so tiny overlaps can't pass
        quality = float(inl_ratio)
        if quality < cfg.loop_fitness_thresh or \
                float(n_inl) < cfg.loop_min_inliers:
            self.loop_stats["fitness"] += 1
            return None
        if float(mean_res) > cfg.loop_max_residual:
            self.loop_stats["residual"] += 1
            return None
        T_rel = np.eye(4)
        T_rel[:3, :3] = np_so3.quat_to_matrix(np.asarray(q_h))
        T_rel[:3, 3] = np.asarray(t_h)
        # gross-mismatch gate vs the current relative estimate
        D = np.linalg.inv(T0) @ T_rel
        d_ang = np.degrees(np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2,
                                             -1.0, 1.0)))
        if np.linalg.norm(D[:3, 3]) > cfg.loop_max_correction_t or \
                d_ang > cfg.loop_max_correction_deg:
            self.loop_stats["correction"] += 1
            return None
        # anisotropic information from the ICP Hessian: cov = sigma^2 *
        # inv(JtJ), already expressed in node i's (candidate's) frame —
        # the frame the graph residual whitens in; per-axis info =
        # discount/diag(cov), capped.
        A6 = np.asarray(JtJ_h, float)
        sigma = max(float(mean_res), 0.01)
        try:
            cov = sigma ** 2 * np.linalg.inv(A6 + 1e-6 * np.eye(6))
        except np.linalg.LinAlgError:
            self.loop_stats["fitness"] += 1
            return None
        info6 = cfg.loop_info_discount / np.maximum(
            np.concatenate([np.diag(cov[:3, :3]), np.diag(cov[3:, 3:])]),
            1e-12)
        info6 = np.clip(info6, 0.0, cfg.loop_info_max)
        with self._graph_lock:
            self.graph.add_se3_edge(cand, kid, T_rel, rot_info=info6[:3],
                                    trans_info=info6[3:])
        self.loops.append((cand, kid))
        self.loop_stats["accepted"] += 1
        return (cand, kid)

    # ------------------------------------------------------------------
    def optimize_graph(self) -> None:
        """Robust PGO round: snapshot under the graph lock, SOLVE OUTSIDE
        it, reconcile under the lock.

        Holding the lock across the CG solve would pin the odometry
        thread's _add_keyframe for the whole solve.  The solve runs while
        keyframes keep queuing, then reconciles through odom2map.  to_data()
        copies into fresh arrays, so the solve input is immune to
        concurrent appends; structural edits (editor del-vertex/del-edge
        renumber node ids) bump _graph_struct_version and a stale solve
        is discarded rather than written back onto shifted indices."""
        with self._opt_lock:                 # one solve at a time
            with self._graph_lock:
                n_snap = self.graph.num_nodes
                if n_snap < 2:
                    return
                ver_snap = self._graph_struct_version
                data = self.graph.to_data(device=self.device)
            with span("mapper/pgo"):
                data, info = optimize(data, self.cfg.pgo)
            with self._graph_lock:
                if self._graph_struct_version != ver_snap:
                    return               # graph renumbered mid-solve
                self.graph.update_from(data, n_nodes=n_snap)
                for i in range(n_snap):
                    self.store.frames[i].pose = \
                        self.graph.node_pose(i).astype(float)
                # refresh the odometry->map correction from the newest
                # OPTIMIZED keyframe (ref hdl_graph_slam_nodelet.cpp:
                # 600-651: trans_odom2map = estimate * keyframe->odom^-1)
                last = self.store.frames[n_snap - 1]
                odom2map = last.pose @ np.linalg.inv(last.odom)
                # nodes appended while the solve ran were posed with the
                # OLD correction; re-anchor them on the refreshed one
                for i in range(n_snap, self.graph.num_nodes):
                    kf = self.store.frames[i]
                    kf.pose = (odom2map @ kf.odom).astype(float)
                    self.graph.set_node_pose(i, kf.pose)
                self.odom2map = odom2map
                self._kf_since_opt = 0

    # ------------------------------------------------------------------
    def save(self, map_dir: str) -> str:
        self.flush()
        self.optimize_graph()
        stamps = [kf.stamp_us for kf in self.store.frames]
        poses = [kf.pose for kf in self.store.frames]
        clouds = [kf.cloud for kf in self.store.frames]
        edges = []
        for (i, j, q, t, si) in self.graph.se3:
            T = np.eye(4)
            T[:3, :3] = np_so3.quat_to_matrix(np.asarray(q))
            T[:3, 3] = t
            edges.append((i, j, T, np.asarray(si[:6]) ** 2))
        origin = self.origin_lla if self.origin_lla is not None else np.zeros(3)
        meta = {"area": []}
        if self.origin_anchor_xyz is not None:
            meta["origin_anchor_xyz"] = [
                float(v) for v in np.asarray(self.origin_anchor_xyz).flat]
        return save_map(map_dir, origin, stamps, poses, clouds, edges,
                        fixed=[i for i, f in enumerate(self.graph.fixed) if f],
                        images=[kf.images for kf in self.store.frames],
                        meta=meta)

    def trajectory(self) -> np.ndarray:
        return np.stack([T for _, T in self.odometry]) if self.odometry else np.zeros((0, 4, 4))

    def get_timed_pose(self, ts_us: int) -> Optional[np.ndarray]:
        """High-rate pose between scans: interpolate the IMU-propagated
        per-sample trajectory of the last scan, or extrapolate with the
        filter velocity beyond it (ref slam.cpp getTimedPose ->
        fastlio.cpp prediction:18-100). Returned in the map frame
        (odom2map-composed)."""
        tr = getattr(self, "_track", None)
        if tr is None:
            return None
        t_rel = (int(ts_us) - tr["stamp_us"]) / 1e6
        n = int(tr.get("n_imu", 0))
        ts = np.asarray(tr["t"], float)[:n]
        quat = np.asarray(tr["quat"], float)[:n]
        pos = np.asarray(tr["pos"], float)[:n]
        T = np.eye(4)
        if len(ts) >= 2 and t_rel <= float(ts[-1]):
            i = int(np.searchsorted(ts, t_rel))
            i = max(1, min(i, len(ts) - 1))
            a = (t_rel - ts[i - 1]) / max(ts[i] - ts[i - 1], 1e-9)
            a = float(np.clip(a, 0.0, 1.0))
            q = quat[i - 1] * (1 - a) + quat[i] * a     # nlerp
            q = q / max(np.linalg.norm(q), 1e-9)
            T[:3, :3] = np_so3.quat_to_matrix(q)
            T[:3, 3] = pos[i - 1] * (1 - a) + pos[i] * a
        else:
            # extrapolate past the last sample with the filter velocity,
            # bounded to one frame interval — a stale track must degrade
            # to the last known pose, not fling it
            T = tr["end_pose"].copy()
            dt = t_rel - (float(ts[-1]) if len(ts) else 0.0)
            T[:3, 3] = T[:3, 3] + np.asarray(tr["vel"], float) \
                * float(np.clip(dt, 0.0, 0.2))
        return self.odom2map @ T
