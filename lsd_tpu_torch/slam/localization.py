"""Map-based localization: global relocalization + NDT/UKF tracking
(counterpart of ``lsd_tpu/slam/localization.py``).

Load an LSD-format map, globally relocalize with ScanContext (+ ICP
verification, optionally seeded by a user pose hint), then track with UKF
predict (odometry increment / IMU / const-vel) + NDT map matching + ICP
refinement, streaming a local target map from the keyframes around the
vehicle.

The numeric stages run on the localizer's device; the host keeps the
bookkeeping (gates, miss counters, watchdogs) and fetches, per tracked
scan, one packed tensor from the tracking step and one pose from the
side-running LIO.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..geometry import np_so3, so3
from ..ops.surfel import surfel_create, surfel_insert
from ..ops.voxelize import voxel_downsample
from ..utils.device import DeviceLike, resolve_device, to_device
from ..utils.precision import slam_f32
from .keyframe import Keyframe, KeyframeStore
from .lio import LioConfig, lio_init, lio_step
from .map_io import load_map
from .registration import icp_point_to_plane, ndt_align, ndt_build, pad_pow2
from .scancontext import make_descriptor, sc_db_add_batch, sc_db_create, sc_query
from .ukf import (UkfConfig, UkfState, ukf_correct, ukf_correct_position,
                  ukf_init, ukf_pose, ukf_predict, ukf_predict_odom)


@slam_f32
def localize_track_step(ukf_st: UkfState, ndt_map, icp_map,
                        points: torch.Tensor, mask: torch.Tensor, dt: torch.Tensor,
                        imu_gyro: torch.Tensor, imu_acc: torch.Tensor,
                        gps_xyz: torch.Tensor, gps_valid: torch.Tensor,
                        gps_var: torch.Tensor,
                        odom_dq: Optional[torch.Tensor] = None,
                        odom_dt: Optional[torch.Tensor] = None,
                        gate_t: Optional[torch.Tensor] = None,
                        gate_ang: Optional[torch.Tensor] = None,
                        gps_gate: Optional[torch.Tensor] = None,
                        stamps: Optional[torch.Tensor] = None,
                        ukf_cfg: UkfConfig = UkfConfig(),
                        has_imu: bool = False, has_odom: bool = False,
                        ndt_iters: int = 15, ndt_searches: int = 15,
                        icp_iters: int = 6, icp_searches: int = 2,
                        track_voxel: float = 0.0, track_capacity: int = 8192):
    """One fused localization tracking step: UKF predict -> NDT match ->
    ICP refine -> gated UKF pose correct -> optional GNSS position correct.

    Everything, the gates included, stays on the device (state selection by
    ``torch.where``), so the step makes no host sync; the miss bookkeeping
    on the host needs only the returned scalars, which the caller fetches
    together.  All tensors on the filter state's device.  Returns
    (state, pose (4, 4), matched, fitness, ok, gps_ok, diag (3,))."""
    dev = ukf_st.x.device
    if gate_t is None:
        gate_t = torch.full((), 1.0, dtype=torch.float32, device=dev)
    if gate_ang is None:
        gate_ang = torch.full((), float(np.deg2rad(10.0)), dtype=torch.float32, device=dev)
    if gps_gate is None:
        gps_gate = torch.full((), 2.5, dtype=torch.float32, device=dev)
    with record_function("localizer/track_step/ukf_predict"):
        if has_odom:
            # LiDAR-inertial odometry increment drives the prediction
            st_pred = ukf_predict_odom(ukf_st, odom_dq, odom_dt, dt, ukf_cfg)
        else:
            st_pred = ukf_predict(ukf_st, dt, ukf_cfg,
                                  imu_gyro if has_imu else None,
                                  imu_acc if has_imu else None)
        T_pred = ukf_pose(st_pred)
        q0 = so3.matrix_to_quat(T_pred[:3, :3])
        t0 = T_pred[:3, 3]
        if stamps is not None:
            # Motion undistortion to the scan-END instant with the predicted
            # state's velocities (first-order: p += (w x p + v_b) * dt_i).
            # The map stores undistorted keyframe clouds (lio_step
            # points_und); matching the raw sweep instead skews it by
            # v * sweep_time (0.5 m at 5 m/s and 0.1 s) and shows as a
            # constant offset in the tracked pose.
            v_body = T_pred[:3, :3].T @ st_pred.x[3:6]
            w_body = st_pred.x[16:19]
            t_end = torch.max(torch.where(mask, stamps, 0.0))
            dt_i = (stamps - t_end)[:, None]
            points = points + (torch.linalg.cross(w_body.expand_as(points), points)
                               + v_body) * dt_i
        if track_voxel > 0.0 and track_capacity < points.shape[0]:
            # voxel-downsample the tracking scan before the matchers: the
            # NDT runs at ~1 m voxels and the ICP against 0.5 m surfels, so
            # a 32k sweep carries ~4x redundant points per cell, and the
            # association gathers scale linearly with N.  ndt_omp likewise
            # voxel-filters its input cloud.
            points, mask = voxel_downsample(points, mask, track_voxel, track_capacity)
            points = points[:, :3]
    with record_function("localizer/track_step/ndt_align"):
        q, t, ndt_info = ndt_align(ndt_map, points, mask, q0, t0,
                                   iters=ndt_iters, searches=ndt_searches)
    with record_function("localizer/track_step/icp_refine"):
        q, t, icp_info = icp_point_to_plane(icp_map, points, mask, q, t,
                                            iters=icp_iters, searches=icp_searches)
    with record_function("localizer/track_step/ukf_correct"):
        matched = ndt_info["matched_frac"]
        fitness = icp_info["fitness"]
        ok = (matched > 0.15) & (fitness > 0.2)
        innov_t = torch.linalg.norm(t - t0)
        innov_ang = 2.0 * torch.arccos(torch.clamp(torch.abs(torch.sum(q * q0)), 0.0, 1.0))
        if has_odom:
            # Innovation gate vs the odometry-driven prediction.  With LIO
            # increments the prediction is mm-accurate per frame, so a map
            # match that lands far from it is an aliased branch of a
            # self-similar map, not a correction; the quality gate alone
            # cannot see it (an aliased match scores a high matched
            # fraction).  The thresholds are device scalars the HOST WIDENS
            # with consecutive rejections: a fixed gate turns a transient
            # offset into permanent rejection of correct matches; widening
            # re-admits the map match once odometry alone has carried the
            # filter beyond the base gate.
            ok = ok & (innov_t < gate_t) & (innov_ang < gate_ang)
        st_corr = ukf_correct(st_pred, t, q, ukf_cfg)
        st_new = UkfState(x=torch.where(ok, st_corr.x, st_pred.x),
                          P=torch.where(ok, st_corr.P, st_pred.P))
        # GNSS innovation gate (every prediction model): a gross outlier fix
        # (multipath) entering ukf_correct_position at sigma 0.1 m yanks
        # position AND heading through the position<->attitude
        # cross-covariance.
        p_now = st_new.x[0:3]
        gps_innov = torch.linalg.norm((gps_xyz - p_now)[:2])
        gps_ok = gps_valid & (gps_innov < gps_gate)
        st_gps = ukf_correct_position(st_new, gps_xyz, gps_var)
        st_new = UkfState(x=torch.where(gps_ok, st_gps.x, st_new.x),
                          P=torch.where(gps_ok, st_gps.P, st_new.P))
        pose = ukf_pose(st_new)
        # diagnostics rider (fetched with the rest):
        # [innov_t, innov_ang, |gps innovation|]
        diag = torch.stack([innov_t, innov_ang, gps_innov])
    return st_new, pose, matched, fitness, ok, gps_ok, diag


@dataclasses.dataclass
class LocalizerConfig:
    ndt_resolution: float = 1.0
    ndt_capacity: int = 2 ** 16
    local_map_radius: float = 45.0
    update_map_every: float = 5.0    # recentre local map after this travel (m)
    # tracking-scan voxel downsample before the NDT/ICP matchers (the
    # association gathers dominate the step; ndt_omp also voxel-filters
    # its input).  0 disables.
    track_voxel: float = 0.4
    track_capacity: int = 8192
    # NDT association rebuilds per step.  15 = exact classic NDT (every
    # iteration); with the LIO-odometry prediction the prior is mm-scale
    # so the voxel assignment is stable and fewer searches are
    # accuracy-neutral; reloc still uses exact settings.
    ndt_searches: int = 15
    ndt_searches_odom: int = 4
    reloc_sc_thresh: float = 0.35
    reloc_fitness_thresh: float = 0.4
    # tracking-lost fallback: after this many consecutive scans with a
    # failed map match the filter is declared lost and the localizer drops
    # back to global relocalization instead of dead-reckoning on IMU
    # integration (which runs away quadratically and drags the local-map
    # window off the map).
    lost_after_misses: int = 10
    # run a lightweight LIO alongside localization and drive the UKF
    # prediction with its odometry increments when the caller provides
    # full scans+IMU.  Falls back to IMU/const-velocity prediction when
    # inputs or the LIO step are unavailable.
    use_lio_odometry: bool = True
    lio: LioConfig = dataclasses.field(default_factory=lambda: LioConfig(
        ds_capacity=8192, map_capacity=2 ** 17,
        scan_voxel=0.4, map_voxel=0.4, max_iters=3))
    ukf: UkfConfig = UkfConfig()


class Localizer:
    def __init__(self, map_dir: str, cfg: LocalizerConfig = LocalizerConfig(),
                 device: DeviceLike = None):
        """Load the map at ``map_dir``; the numeric stages run on ``device``
        (CUDA unless named)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        data = load_map(map_dir)
        self.store = KeyframeStore()
        kf_images = data.get("images") or [{}] * len(data["stamps"])
        for i, (s, T, c, im) in enumerate(zip(data["stamps"], data["poses"],
                                              data["clouds"], kf_images)):
            self.store.add(Keyframe(id=i, stamp_us=s, pose=T, odom=T, cloud=c,
                                    images=im))
        self.origin = data["origin"]
        self.origin_anchor = np.asarray(
            (data.get("meta") or {}).get("origin_anchor_xyz",
                                         [0.0, 0.0, 0.0]), float)
        # visual (ORB) relocalization DB over keyframe images, when present
        self.visual_db = None
        try:
            from .visual_reloc import VisualRelocDB
            db = VisualRelocDB()
            for kf in self.store.frames:
                for img in kf.images.values():
                    db.add(kf.id, img)
                    break
            if len(db):
                self.visual_db = db
        except RuntimeError:
            pass
        # ScanContext DB over keyframe clouds (in their own frame): all
        # clouds share one padding bucket and go up in one upload, the
        # descriptors land via sc_db_add_batch
        self.sc_db = sc_db_create(capacity=4096, device=self.device)
        if len(self.store):
            kmax = max(max((len(kf.cloud) for kf in self.store.frames)), 2)
            cap = 1 << int(np.ceil(np.log2(kmax)))
            K = len(self.store)
            pads = np.zeros((K, cap, 3), np.float32)
            msks = np.zeros((K, cap), bool)
            for i, kf in enumerate(self.store.frames):
                pts = kf.cloud[:, :3].astype(np.float32)
                pads[i, :len(pts)] = pts
                msks[i, :len(pts)] = True
            pads_d, msks_d = to_device(pads, self.device), to_device(msks, self.device)
            descs = torch.stack([make_descriptor(p, m) for p, m in zip(pads_d, msks_d)])
            self.sc_db = sc_db_add_batch(
                self.sc_db, descs, torch.ones(K, dtype=torch.bool, device=self.device))
        self.initialized = False
        self.ukf: Optional[UkfState] = None
        self.ndt_map = None
        self.icp_map = None
        self.map_center = None
        self.last_stamp_us: Optional[int] = None
        self.init_hint: Optional[np.ndarray] = None
        self._last_scan = None
        self._lio_state = None
        self._misses = 0
        self._gps_rej = 0
        self._gps_incons = 0

    # ------------------------------------------------------------------
    def set_init_pose(self, pose: np.ndarray) -> None:
        """Interactive pose hint."""
        self.init_hint = np.asarray(pose, float)

    def set_init_pose_range(self, pose_range) -> None:
        """Pose hint as [x, y, z, roll, pitch, yaw]."""
        v = [float(x) for x in np.asarray(pose_range, float).reshape(-1)[:6]]
        T = np.eye(4)
        T[:3, :3] = np_so3.rpy_to_matrix(v[3], v[4], v[5])
        T[:3, 3] = v[:3]
        self.init_hint = T
        self.initialized = False   # force re-initialization from the hint

    def get_estimate_pose(self, x0: float, y0: float,
                          x1: float, y1: float) -> Optional[list]:
        """Relocalize the most recent scan against keyframes inside the
        given XY rectangle; returns a flattened 4x4 or None."""
        if self._last_scan is None:
            return None
        points, mask, image = self._last_scan
        lo = np.minimum([x0, y0], [x1, y1])
        hi = np.maximum([x0, y0], [x1, y1])
        pos = self.store.positions()
        in_rect = [i for i in range(len(pos))
                   if np.all(pos[i, :2] >= lo) and np.all(pos[i, :2] <= hi)]
        if not in_rect:
            return None
        hint, self.init_hint = self.init_hint, None
        try:
            # seed the generic relocalizer at the rectangle's keyframes: ICP
            # verifies against the rect's neighborhood, rejecting
            # out-of-area matches
            best = None
            for i in in_rect[:10]:
                self.init_hint = self.store[i].pose
                T = self._relocalize(points, mask, image=image)
                if T is not None and np.all(T[:2, 3] >= lo - 20) \
                        and np.all(T[:2, 3] <= hi + 20):
                    best = T
                    break
        finally:
            self.init_hint = hint
        return None if best is None else np.asarray(best).flatten().tolist()

    def _build_local_map(self, center) -> None:
        with record_function("localizer/build_local_map"):
            ids = self.store.within_radius(center, self.cfg.local_map_radius)
            cloud = self.store.merged_cloud(ids, max_points=2 ** 17)
            pad, m = pad_pow2(cloud, self.device)
            self.ndt_map = ndt_build(pad, m, self.cfg.ndt_resolution, self.cfg.ndt_capacity)
            # companion surfel map for the precise ICP refinement stage
            # (surfel lookups are much cheaper than kNN over raw points)
            icp_m = surfel_create(capacity=2 ** 17, voxel_size=0.5, device=self.device)
            self.icp_map = surfel_insert(icp_m, pad, m)
            self._local_cloud = (pad, m)
            self.map_center = np.asarray(center, float).copy()

    # ------------------------------------------------------------------
    def _relocalize(self, points, mask, image=None, gps_xyz=None,
                    ins_yaw=None) -> Optional[np.ndarray]:
        """Hint / ScanContext / ORB-visual / GNSS-seeded -> ICP verify ->
        initial pose.  ``points`` (N, >=3) and ``mask`` as host arrays or
        tensors on the localizer's device."""
        with record_function("localizer/relocalize"):
            dev = self.device
            pts_d = to_device(points, dev)[:, :3]
            mask_d = to_device(mask, dev)
            cand_pose = None
            yaw0 = 0.0
            # what the last relocalization saw (diagnostics only)
            self.last_reloc = dict(sc_index=None, sc_dist=None, fitness=None)
            if self.init_hint is not None:
                cand_pose = self.init_hint
            else:
                idx, dist, yaw = sc_query(self.sc_db, make_descriptor(pts_d, mask_d),
                                          num_candidates=10, exclude_recent=0)
                # one fetch (the index, below 2**24, is exact in float32)
                idx, dist, yaw = torch.stack([idx.to(torch.float32), dist, yaw]).cpu().tolist()
                self.last_reloc.update(sc_index=int(idx), sc_dist=dist)
                if int(idx) >= 0 and dist <= self.cfg.reloc_sc_thresh:
                    cand_pose = self.store[int(idx)].pose
                    yaw0 = yaw
                elif image is not None and self.visual_db is not None:
                    hits = self.visual_db.query(image)
                    if hits:
                        cand_pose = self.store[hits[0][0]].pose
                if cand_pose is None and gps_xyz is not None:
                    # GNSS-seeded candidate: ScanContext is genuinely
                    # ambiguous along long straight stretches (every
                    # descriptor looks alike); a current fix bounds the
                    # position and the INS heading (or the nearest
                    # keyframe's yaw) seeds the attitude
                    ids = self.store.within_radius(
                        np.asarray(gps_xyz, float), 20.0)
                    if ids:
                        pos = self.store.positions()
                        near = min(ids, key=lambda i: np.linalg.norm(
                            pos[i, :2] - np.asarray(gps_xyz)[:2]))
                        T0 = np.asarray(self.store[near].pose, float).copy()
                        T0[:3, 3] = np.asarray(gps_xyz, float)
                        T0[2, 3] = pos[near, 2]       # keep the map's height
                        if ins_yaw is not None:
                            T0[:3, :3] = np_so3.rpy_to_matrix(
                                0.0, 0.0, float(ins_yaw))
                        cand_pose = T0
                if cand_pose is None:
                    return None
            # verify + refine with ICP against the neighborhood map
            center = cand_pose[:3, 3]
            ids = self.store.within_radius(center, self.cfg.local_map_radius)
            target = self.store.merged_cloud(ids, max_points=2 ** 16)
            if len(target) < 500:
                return None
            m = surfel_create(capacity=2 ** 16, voxel_size=0.5, device=dev)
            m = surfel_insert(m, *pad_pow2(target, dev))
            Rz = np_so3.exp_so3([0.0, 0.0, -float(yaw0)])
            R0 = cand_pose[:3, :3] @ Rz
            q0 = so3.matrix_to_quat(to_device(R0, dev, torch.float32))
            t0 = to_device(cand_pose[:3, 3], dev, torch.float32)
            q, t, info = icp_point_to_plane(m, pts_d, mask_d, q0, t0, iters=15, searches=5)
            # one fetch: the pose and the fitness that gates it
            flat = torch.cat([q, t, info["fitness"][None]]).cpu().numpy()
            self.last_reloc["fitness"] = float(flat[7])
            if float(flat[7]) < self.cfg.reloc_fitness_thresh:
                return None
            T = np.eye(4)
            T[:3, :3] = np_so3.quat_to_matrix(flat[:4])
            T[:3, 3] = flat[4:7]
            return T

    # ------------------------------------------------------------------
    def project_fix(self, lat: float, lon: float,
                    alt: float = 0.0) -> Optional[np.ndarray]:
        """GNSS fix -> map-frame xyz via the map's saved origin anchor
        (graph/map_info.txt + map_meta.json origin_anchor_xyz).

        The anchor is the MAP-FRAME position of the origin fix: a map
        whose frame does not start at (0,0,0) at that fix (a mapping run
        seeded mid-world, merged maps) would otherwise offset every
        projected fix by the anchor."""
        if self.origin is None or np.size(self.origin) < 2:
            return None
        from ..geometry.utm import latlon_to_utm
        o = np.asarray(self.origin, float).reshape(-1)
        x0, y0, zone = latlon_to_utm(o[0], o[1])
        x, y, _ = latlon_to_utm(lat, lon, zone)
        alt0 = o[2] if o.size > 2 else 0.0
        a = np.asarray(self.origin_anchor, np.float32)
        return a + np.asarray([x - x0, y - y0, alt - alt0], np.float32)

    def _lio_increment(self, points, stamps, mask, imu, imu_mask):
        """Advance the side-running LIO; returns (dq, dtrans), the
        body-frame SE3 increment since the previous scan, or None while
        the side filter is warming up / unhealthy.  Inputs as host arrays
        or tensors on the localizer's device.

        The side LIO cold-starts at identity, usually MID-MOTION (a
        localization run rarely begins at rest), so its first
        increments are convergence transients that must not drive the
        UKF.  Increments are withheld for a warm-up window and gated
        against an absolute bound on the step."""
        if stamps is None or imu is None:
            return None
        dev = self.device
        if self._lio_state is None:
            self._lio_state = lio_init(self.cfg.lio, device=dev)
            self._lio_prev = np.eye(4)
            self._lio_n = 0
        with record_function("localizer/lio_increment"):
            self._lio_state, info = lio_step(
                self.cfg.lio, self._lio_state,
                to_device(points, dev)[:, :3], to_device(stamps, dev),
                to_device(mask, dev), to_device(imu, dev, torch.float32),
                to_device(imu_mask, dev))
            pose = info["pose"].cpu().numpy().astype(float)
        dT = np.linalg.inv(self._lio_prev) @ pose
        self._lio_prev = pose
        self._lio_n += 1
        if self._lio_n <= 10 or not np.isfinite(dT).all():
            return None
        mag = float(np.linalg.norm(dT[:3, 3]))
        if mag > 1.5:
            # absolute sanity bound (15 m/s at 10 Hz): a runaway or
            # divergent side filter must not drive the UKF.  A gate against
            # the PUBLISHED pose's step would reject mm-accurate increments
            # exactly while the published pose flails on an aliased map
            # match, removing the one stabilising signal.
            return None
        dq = np_so3.matrix_to_quat(dT[:3, :3]).astype(np.float32)
        return dq, dT[:3, 3].astype(np.float32)

    def process_scan(self, points, mask, stamp_us: int,
                     imu_gyro=None, imu_acc=None, image=None,
                     gps_xyz=None, gps_var: float = 4.0,
                     ins_yaw=None, stamps=None, imu=None,
                     imu_mask=None) -> Dict:
        """Feed one padded scan (sensor frame, host arrays). Returns
        dict(pose, status).  ins_yaw: optional ENU yaw (rad) from a trusted
        INS fix, used to arbitrate reloc hypotheses and tracked heading."""
        dev = self.device
        points = np.asarray(points, np.float32)
        mask = np.asarray(mask, bool)
        self._last_scan = (points, mask, image)
        # the scan goes up once; the side LIO, the relocalizer and the
        # tracking step all read that copy
        pts_d = to_device(points, dev)[:, :3]
        mask_d = to_device(mask, dev)
        stamps_d = to_device(stamps, dev, torch.float32) if stamps is not None else None
        # step the side-running LIO on EVERY scan (also while lost /
        # relocalizing) so its odometry stays continuous across gaps
        inc = (self._lio_increment(pts_d, stamps_d, mask_d, imu, imu_mask)
               if self.cfg.use_lio_odometry else None)

        def yaw_of(Tm):
            return float(np.arctan2(Tm[1, 0], Tm[0, 0]))

        def yaw_diff(a, b):
            return abs((a - b + np.pi) % (2 * np.pi) - np.pi)

        if not self.initialized:
            T = self._relocalize(pts_d, mask_d, image=image,
                                 gps_xyz=gps_xyz, ins_yaw=ins_yaw)
            if T is not None and gps_xyz is not None and \
                    np.linalg.norm(T[:2, 3] - np.asarray(gps_xyz)[:2]) > 20.0:
                # GNSS consistency gate on the reloc hypothesis: in
                # self-similar worlds (figure-eight lobes, parking rows)
                # a ScanContext+ICP match can land on an aliased twin; a
                # current fix within tens of meters arbitrates for free
                T = None
            if T is not None and ins_yaw is not None and \
                    yaw_diff(yaw_of(T), float(ins_yaw)) > 0.8:
                # INS-heading arbitration: a symmetric world admits
                # 180-degree-flipped hypotheses at the RIGHT position;
                # position gates cannot see them, the INS heading can
                T = None
            if T is None:
                return dict(pose=None, status="relocalizing")
            self.ukf = ukf_init(to_device(T, dev, torch.float32))
            self._build_local_map(T[:3, 3])
            self.initialized = True
            self.last_stamp_us = stamp_us
            self._prev_pub = np.asarray(T, float).copy()
            # The side LIO is deliberately NOT re-seeded at the map pose:
            # its increments are body-frame relative transforms, which
            # are invariant to its global frame, while overwriting
            # nav.pos/quat leaves its internal surfel map (built in the
            # old frame) inconsistent with the new pose
            return dict(pose=T, status="initialized")

        dt = max((stamp_us - self.last_stamp_us) / 1e6, 1e-3) if self.last_stamp_us else 0.1
        self.last_stamp_us = stamp_us
        has_imu = imu_gyro is not None
        z3 = np.zeros(3, np.float32)
        # adaptive innovation gates (see localize_track_step): base
        # thresholds widen with consecutive rejections so a transient
        # offset cannot lock the filter out of its own map match
        misses = self._misses
        gate_t = min(1.0 + 0.1 * misses, self.cfg.local_map_radius / 3)
        gate_ang = np.deg2rad(min(10.0 + 1.0 * misses, 60.0))
        gps_rej = self._gps_rej
        gps_gate = min(2.5 + 0.5 * gps_rej, 30.0)
        # every host scalar of the step in one upload:
        # [dt, gyro 3, acc 3, gps 3, gps_valid, gps_var, dq 4, dtrans 3, gates 3]
        s = to_device(np.concatenate([
            [dt], imu_gyro if has_imu else z3, imu_acc if imu_acc is not None else z3,
            gps_xyz if gps_xyz is not None else z3, [float(gps_xyz is not None), gps_var],
            inc[0] if inc is not None else [1.0, 0.0, 0.0, 0.0],
            inc[1] if inc is not None else z3,
            [gate_t, gate_ang, gps_gate]]).astype(np.float32), dev)
        with record_function("localizer/track_step"):
            # one fused device step (predict + NDT + ICP + gated corrections)
            self.ukf, T_dev, matched_dev, fitness_dev, ok_dev, gps_ok_dev, diag_dev = \
                localize_track_step(
                    self.ukf, self.ndt_map, self.icp_map, pts_d, mask_d,
                    s[0], s[1:4], s[4:7], s[7:10], s[10] > 0.5, s[11],
                    odom_dq=s[12:16], odom_dt=s[16:19],
                    gate_t=s[19], gate_ang=s[20], gps_gate=s[21],
                    stamps=stamps_d,
                    ukf_cfg=self.cfg.ukf, has_imu=has_imu,
                    has_odom=inc is not None,
                    ndt_searches=(self.cfg.ndt_searches_odom if inc is not None
                                  else self.cfg.ndt_searches),
                    track_voxel=self.cfg.track_voxel,
                    track_capacity=self.cfg.track_capacity)
        with record_function("localizer/fetch"):
            # ONE fetch (one host sync) of everything the host consumes
            flat = torch.cat([
                T_dev.reshape(-1),
                torch.stack([matched_dev, fitness_dev, ok_dev.to(torch.float32),
                             gps_ok_dev.to(torch.float32)]),
                diag_dev]).cpu().numpy()
        T = flat[:16].reshape(4, 4).astype(float)
        matched, track_ok, gps_ok, step_diag = \
            float(flat[16]), bool(flat[18] > 0.5), bool(flat[19] > 0.5), flat[20:23]
        self.last_step_diag = dict(
            innov_t=float(step_diag[0]),
            innov_ang_deg=float(np.degrees(step_diag[1])),
            gps_innov=float(step_diag[2]), gate_t=gate_t,
            gate_ang_deg=float(np.degrees(gate_ang)),
            track_ok=track_ok, gps_ok=gps_ok, fitness=float(flat[17]),
            has_odom=inc is not None)
        if gps_xyz is not None:
            self._gps_rej = 0 if gps_ok else gps_rej + 1
        if track_ok:
            self._misses = 0
        else:
            self._misses += 1
            # odometry-backed coasting tolerates far more rejected map
            # matches before declaring lost: with LIO increments driving
            # prediction at ~1 mm/frame error the filter dead-reckons
            # safely through an ambiguous region, whereas const-velocity
            # prediction runs away quadratically
            lost_after = (self.cfg.lost_after_misses * 6
                          if inc is not None else self.cfg.lost_after_misses)
            if self._misses >= lost_after:
                # tracking lost: back to global relocalization rather than
                # dead-reckoning away
                self.initialized = False
                self._misses = 0
                return dict(pose=None, status="lost")
        # GNSS consistency watchdog: in self-similar worlds the NDT/ICP
        # matcher can slide onto an aliased branch with a HIGH matched
        # fraction, so the miss counter never fires; a persistent
        # disagreement with an available fix is the unambiguous lost
        # signal.  Sustained > 12 m for 5 fixes -> reinit (reloc is itself
        # GNSS-gated, so recovery lands on the right branch).
        incons = False
        if gps_xyz is not None and \
                np.linalg.norm(T[:2, 3] - np.asarray(gps_xyz)[:2]) > 12.0:
            incons = True
        if ins_yaw is not None and \
                yaw_diff(yaw_of(T), float(ins_yaw)) > 0.8:
            incons = True          # flipped/aliased heading (see reloc gate)
        if gps_xyz is not None or ins_yaw is not None:
            if incons:
                self._gps_incons += 1
                if self._gps_incons >= 5:
                    self.initialized = False
                    self._gps_incons = 0
                    self._misses = 0
                    return dict(pose=None, status="lost")
            else:
                self._gps_incons = 0

        if np.linalg.norm(T[:3, 3] - self.map_center) > self.cfg.update_map_every:
            # coverage guard: only recentre while keyframes exist around
            # the new position: recentring onto a runaway pose builds an
            # empty map and makes the loss permanent
            if self.store.within_radius(T[:3, 3],
                                        self.cfg.local_map_radius):
                self._build_local_map(T[:3, 3])
            else:
                self._misses += 1
        self._prev_pub = T.copy()
        return dict(pose=T, status="tracking", matched_frac=matched)
