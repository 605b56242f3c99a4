"""Concrete pipeline modules (counterpart of ``lsd_tpu/runtime/modules.py``):
the player source, SLAM, detection and the sinks.

- ``PlayerSource``: paced replay of a recording, with the seek / rate /
  pause / step surface (host code, as in the reference);
- ``SlamModule``: the host code between the sensors and the engines (the
  INS status gate, UTM anchoring of the GNSS priors at the fix instant,
  IMU stamps made relative, the end-of-stream drain, the RTK-only fallback
  pose, the odometry publish on the bus) around the port's ``Mapper``,
  ``RtkMapper`` or ``Localizer`` on ``device``;
- ``DetectModule``: ``detection.accumulate`` -> predict -> one packed
  fetch -> ``detection.freespace`` -> (with ``detection.mono3d.enable``:
  the camera model and the late fusion) -> ``detection.tracker`` ->
  ``detection.object_filter``, on ``device``;
- ``FrameSinkModule`` / ``EvalDumpSink`` / ``UdpSinkModule`` /
  ``HttpSinkModule`` and their fan-out ``SinkModule`` (host code).

Modules that touch the card take ``device`` (the card unless the caller
asks for the CPU) and raise without a card when none is named.
"""
from __future__ import annotations

import os
import socket
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..calibration.service import cfg_to_transform
from ..comms import MessageBus
from ..comms.messages import odometry_msg
from ..convert import detector_params_from_flax
from ..detection.accumulate import FrameAccumulator
from ..detection.camera_fusion import fuse_camera_lidar
from ..detection.freespace import seg_to_freespace
from ..detection.object_filter import ObjectFilter
from ..detection.post import PostProcessConfig, postprocess
from ..detection.tracker import Tracker3D, TrackerConfig
from ..geometry import np_so3
from ..geometry.utm import UTMProjector
from ..io.frame import frame_from_dict
from ..io.player import FramePlayer
from ..io.recorder import FrameRecorder
from ..models.detector import CenterPointDetector, DetectorConfig, init_detector_params
from ..models.params_io import load_params
from ..proto.detection import serialize_detection
from ..proto.internal import serialize_pointcloud_map
from ..sensors.ins_status import InsStatusMachine
from ..slam import (Localizer, LocalizerConfig, LioConfig, Mapper, MapperConfig,
                    RtkMapper)
from ..slam.map_editor import MapEditor
from ..slam.mesh import texture_mesh
from ..utils.device import DeviceLike, fetch, resolve_device, to_device
from ..utils.precision import set_slam_precision
from ..utils.spans import span
from ..utils.system import capture_journal
from .interface import register_interface
from .pipeline import DataBank, Module


class PlayerSource(Module):
    """Offline playback source (seek / rate / pause surface)."""

    def __init__(self, cfg):
        super().__init__("Source")
        self.cfg = cfg
        self.player: Optional[FramePlayer] = None
        self.rate = 1.0
        self.playing = True
        self.idx = 0
        self.last_ts = None
        self.last_wall = None
        self.realtime = bool(getattr(getattr(cfg, "input", {}), "realtime", False))
        register_interface("player.seek", self.seek)
        register_interface("player.set_rate", self.set_rate)
        register_interface("player.pause", self.pause)
        register_interface("player.resume", self.resume)
        register_interface("player.step", self.step)
        register_interface("player.get_status", self.get_status)

    def get_status(self) -> Dict:
        """Transport status (ref player_data_manager.get_status:138-146:
        mm:ss elapsed/left + percent)."""
        if self.player is None or len(self.player) == 0:
            return dict(now_time="00:00", left_time="00:00", percent=0.0,
                        playing=self.playing, rate=self.rate)
        n = len(self.player)
        idx = min(self.idx, n - 1)
        t0, t1 = self._span if getattr(self, "_span", None) else (0.0, 0.0)
        tc = t0 + (t1 - t0) * idx / max(n - 1, 1)
        fmt = lambda s: "{0:02d}:{1:02d}".format(int(max(s, 0) / 60),
                                                 int(max(s, 0) % 60))
        return dict(now_time=fmt(tc - t0), left_time=fmt(t1 - tc),
                    percent=idx / n * 100.0, playing=self.playing,
                    rate=self.rate)

    def setup(self, cfg) -> None:
        path = cfg.input.data_path
        self.player = FramePlayer(path)
        n = len(self.player)
        self._span = None
        if n:
            self._span = (
                self.player.read_dict(0)["frame_timestamp_monotonic"] / 1e6,
                self.player.read_dict(n - 1)["frame_timestamp_monotonic"] / 1e6)
        self.logger.info("player: %d frames from %s", n, path)

    # control surface ---------------------------------------------------
    def seek(self, percent: float) -> None:
        if self.player:
            self.idx = int(len(self.player) * max(0.0, min(percent, 100.0)) / 100.0)

    def set_rate(self, rate: float) -> None:
        self.rate = max(0.1, float(rate))

    def pause(self) -> None:
        self.playing = False

    def resume(self) -> None:
        self.playing = True

    def step(self) -> None:
        self.playing = False
        self.idx = min(self.idx + 1, len(self.player) - 1 if self.player else 0)

    # producer ----------------------------------------------------------
    def get_data(self) -> Optional[Dict]:
        if self.player is None or len(self.player) == 0:
            time.sleep(0.05)
            return None
        if self.idx >= len(self.player):
            # at end of data: keep re-emitting the last frame (ref
            # loop_run_once caps current_idx and re-parses)
            self.idx = len(self.player) - 1
            time.sleep(0.1)
        if not self.playing:
            time.sleep(0.05)
            d = self.player.read_dict(self.idx)
            d["_source"] = "Source"
            return d
        d = self.player.read_dict(self.idx)
        self.idx += 1
        # paced replay (ref loop_run_once :193-236)
        if self.realtime:
            ts = d["frame_timestamp_monotonic"] / 1e6
            now = time.monotonic()
            if self.last_ts is not None:
                dt = (ts - self.last_ts) / self.rate - (now - self.last_wall)
                if 0 < dt < 0.5:
                    time.sleep(dt)
            self.last_ts, self.last_wall = ts, time.monotonic()
        d["_source"] = "Source"
        return d


def register_static_slam_tools(device: DeviceLike = None) -> None:
    """Stateless SLAM tool interfaces that need no live engine — the
    offline part of the reference's slam_wrapper surface
    (slam_wrapper.cpp:307 texture_mesh); its kNN runs on ``device``."""
    register_interface(
        "slam.texture_mesh",
        lambda mesh_path, cloud_path, output_path, k=3: texture_mesh(
            mesh_path, cloud_path, output_path, k=k, device=device))


def _relative_imu(imu: np.ndarray, scan_start_us: int) -> np.ndarray:
    """IMU rows with absolute microsecond stamps as seconds from the scan
    start; rows already relative (no stamp above 1e6) pass unchanged."""
    imu_rel = np.asarray(imu, np.float64).copy()
    if imu_rel.size and imu_rel[:, 0].max() > 1e6:
        imu_rel[:, 0] = (imu_rel[:, 0] - scan_start_us) / 1e6
    return imu_rel


class SlamModule(Module):
    """SLAM stage hosting the Mapper, the RtkMapper or the Localizer, whose
    numeric stages run on ``device``."""

    def __init__(self, cfg, device: DeviceLike = None):
        # offline mode blocks (no frame drops: slam_manager.py:72-84)
        super().__init__("SLAM", blocking=cfg.input.mode == "offline")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.engine = None
        self.last_pose = np.eye(4)
        self.bus = MessageBus.core()
        register_interface("slam.get_pose", lambda: self.last_pose.tolist())
        register_interface("slam.get_timed_pose", self._get_timed_pose)
        register_static_slam_tools(self.device)

    def _get_timed_pose(self, ts_us):
        """High-rate pose between scans (ref slam.cpp getTimedPose)."""
        if hasattr(self.engine, "get_timed_pose"):
            T = self.engine.get_timed_pose(int(ts_us))
            if T is not None:
                return np.asarray(T).tolist()
        return self.last_pose.tolist()

    def setup(self, cfg) -> None:
        if hasattr(self.engine, "close"):   # restart: stop the old
            self.engine.close()             # engine's graph worker
        register_interface("slam.restart_mapping", self._restart_mapping)
        if cfg.slam.mode == "mapping":
            kfi = cfg.slam.key_frames_interval
            mcfg = MapperConfig(
                lio=LioConfig(scan_voxel=cfg.slam.resolution,
                              map_voxel=cfg.slam.resolution),
                keyframe_delta_trans=kfi[0], keyframe_delta_angle=kfi[1],
                # graph work (descriptor/loops/PGO) on a background
                # thread so odometry publishes at sensor rate (ref
                # fastlio.cpp runGraph + slam.cpp runMappingThread)
                async_graph=bool(getattr(cfg.slam, "async_graph", True)))
            if str(getattr(cfg.slam, "method", "FastLIO")) == "RTKM":
                # GNSS-interpolated mapping, no LiDAR odometry (ref
                # slam.cpp getMappingTypeByName RTKM -> rtkm.cpp)
                self.engine = RtkMapper(mcfg, device=self.device)
            else:
                # pipelined device fetch hides the host<->device round
                # trip behind the next scan's compute (ref latency-hiding
                # threads, manager_template.py:68-96)
                mcfg.async_fetch = bool(getattr(cfg.slam, "async_fetch", True))
                self.engine = Mapper(mcfg, device=self.device)
            register_interface("slam.save_map", self.engine.save)
            # map-editor surface mirroring the reference's full interface
            # set (slam/slam.py:27-47 register_interface list + the
            # slam_manager save/progress interfaces)
            ed = MapEditor(self.engine, camera_params=self._camera_params(cfg))
            self.editor = ed
            register_interface("slam.get_status", ed.get_status)
            register_interface("slam.get_vertex_poses", ed.get_pose)
            register_interface("slam.get_edge", ed.get_edge)
            register_interface("slam.get_graph_meta", ed.get_graph_meta)
            register_interface("slam.get_key_frame", ed.get_key_frame)
            register_interface("slam.get_vertex_cloud", ed.get_vertex_cloud)
            register_interface("slam.get_color_map", ed.get_color_map)
            register_interface("slam.del_vertex", ed.del_vertex)
            register_interface("slam.del_points", ed.del_points)
            register_interface("slam.add_edge", ed.add_edge)
            register_interface("slam.del_edge", ed.del_edge)
            register_interface("slam.add_area", ed.add_area)
            register_interface("slam.del_area", ed.del_area)
            register_interface("slam.set_vertex_fix", ed.set_vertex_fix)
            register_interface("slam.set_vertex_pose", ed.set_vertex_pose)
            register_interface("slam.graph_optimize", ed.graph_optimize)
            register_interface("slam.keyframe_align", ed.keyframe_align)
            register_interface("slam.merge_map", ed.merge_map)
            register_interface("slam.set_export_map_config",
                               ed.set_export_map_config)
            register_interface("slam.export_map", ed.export_map)
            register_interface("slam.rotate_ground_constraint",
                               ed.rotate_ground_constraint)
            register_interface("slam.save_mapping", ed.start_save_mapping)
            register_interface("slam.get_save_progress", ed.get_save_progress)
        else:
            self.engine = Localizer(cfg.slam.map_path, LocalizerConfig(
                use_lio_odometry=bool(getattr(cfg.slam, "lio_fusion", True))),
                device=self.device)
            eng = self.engine
            register_interface("slam.set_init_pose", self._set_init_pose)
            register_interface("slam.get_estimate_pose",
                               lambda pr: eng.get_estimate_pose(
                                   float(pr[0][0]), float(pr[0][1]),
                                   float(pr[1][0]), float(pr[1][1])))
            register_interface("slam.get_status",
                               lambda: dict(initialized=eng.initialized))

    @staticmethod
    def _camera_params(cfg) -> Dict:
        """Per-camera K + T_cam_from_lidar from the config (reference
        extrinsic_parameters convention), for map colouration and the
        camera detector."""
        out: Dict = {}
        for cam in getattr(cfg, "camera", None) or []:
            intr = cam.get("intrinsic_parameters")
            extr = cam.get("extrinsic_parameters")
            name = cam.get("name")
            if not (name and intr and extr and len(intr) >= 4):
                continue
            K = np.asarray([[intr[0], 0, intr[2]],
                            [0, intr[1], intr[3]], [0, 0, 1.0]])
            T = np.linalg.inv(cfg_to_transform(*[float(v) for v in extr][:6]))
            out[str(name)] = dict(K=K, T_cam_from_lidar=T)
        return out

    def _set_init_pose(self, p) -> None:
        """Accepts a 4x4 pose or the reference's 6-element pose_range."""
        arr = np.asarray(p, float)
        if arr.size == 16:
            self.engine.set_init_pose(arr.reshape(4, 4))
        else:
            self.engine.set_init_pose_range(arr.reshape(-1))

    def release(self) -> None:
        if hasattr(self.engine, "close"):
            self.engine.close()

    def _restart_mapping(self, payload=None) -> str:
        """Re-initialize the SLAM engine, optionally from a new config
        (ref slam_server.restart_mapping -> slam.restart_mapping)."""
        cfg = self.cfg
        if isinstance(payload, dict) and payload.get("config") is not None:
            from .config import AttrDict
            cfg = AttrDict(payload["config"])
            self.cfg = cfg
        self._last_ts = None
        self.last_pose = np.eye(4)
        self.setup(cfg)
        return "ok"

    def process(self, d: Dict) -> Optional[Dict]:
        frame = frame_from_dict(d)
        if frame.scan is None:
            return d
        # timestamp monotonicity gate (ref slam/slam.py enqueue checks):
        # duplicate/out-of-order frames (e.g. the player re-emitting the
        # last frame at end of data) must not be re-integrated
        ts = frame.scan.timestamp
        if getattr(self, "_last_ts", None) is not None and ts <= self._last_ts:
            # end-of-stream (player re-emits the last frame): drain the
            # pipelined in-flight scan so the trajectory is complete
            if hasattr(self.engine, "finish_pending"):
                self.engine.finish_pending()
            d["slam_pose"] = self.last_pose
            return d
        self._last_ts = ts
        if isinstance(self.engine, Mapper):
            out = self._process_mapping(d, frame, ts)
        else:
            out = self._process_localization(d, frame)
        if out.get("pose") is not None:
            # live_pose = IMU-extrapolated to THIS frame's stamp when the
            # mapper runs pipelined (its "pose" is the previous scan's)
            self.last_pose = np.asarray(out.get("live_pose", out["pose"]))
            # observability: publish fused odometry on the bus (ref:
            # slam.cpp ZCM slam.odometry publish).  The reference wraps
            # this in ``except Exception: pass``; here a failure raises.
            self.bus.publish("slam.odometry",
                             odometry_msg(frame.scan.timestamp, self.last_pose))
        d["slam_pose"] = self.last_pose
        return d

    def _process_mapping(self, d: Dict, frame, ts: int) -> Dict:
        imu = frame.imu.data if frame.imu is not None else np.zeros((1, 7))
        imu_mask = frame.imu.mask if frame.imu is not None else np.zeros(1, bool)
        # convert absolute us stamps to seconds relative to scan start
        imu_rel = _relative_imu(imu, frame.scan.timestamp)
        # INS -> GPS prior + map origin + velocity observation
        # (ref slam.cpp feedInsData -> enqueue_graph_gps +
        # wheelspeed observation laserMapping.cpp:794-812), gated by
        # the status priority/stable-time state machine
        # (slam.cpp preprocessInsData:194-268)
        gps_xyz = vel_obs = vel_obs_valid = None
        ins = d.get("ins_data") or {}
        accepted = False
        if ins:
            if not hasattr(self, "_ins_sm"):
                self._ins_sm = InsStatusMachine()
            prio = self._ins_sm.update(
                ts / 1e6, int(ins.get("Status", 0)),
                float(ins.get("latitude", 0.0) or 0.0),
                float(ins.get("longitude", 0.0) or 0.0))
            accepted = prio >= 0
        gps_info = None
        if d.get("ins_valid") and ins.get("latitude") and accepted:
            # pose AT THE FIX INSTANT for anchoring + outlier gating
            # (ref ins_driver trigger / hdl gps interpolation).  The
            # module's last_pose lags the fix by 1-2 frames (0.5-1 m
            # at speed) — an anchor built from it offsets EVERY
            # later prior by that constant.
            pose_ref = self.last_pose
            fix_ts_ref = float(ins.get("timestamp", ts))
            T_at = self.engine.get_timed_pose(int(fix_ts_ref))
            if T_at is not None:
                pose_ref = np.asarray(T_at, float)
            if not hasattr(self, "_proj"):
                self._proj = UTMProjector()
                if self.engine.origin_lla is None:
                    self.engine.origin_lla = np.asarray(
                        [float(ins["latitude"]), float(ins["longitude"]),
                         float(ins.get("altitude", 0.0))])
                    # pair the origin with its MAP-FRAME position so
                    # saved maps can project fixes even when the map
                    # frame is not anchored at the origin fix
                    self.engine.origin_anchor_xyz = np.asarray(
                        pose_ref[:3, 3], float).copy()
                # anchor the GNSS frame to the MAP frame at the first
                # accepted fix: the prior for that fix lands exactly on
                # the current SLAM pose, and later fixes are offsets
                # from it (ref: the reference stores the map origin in
                # map_info.txt and projects fixes relative to it,
                # slam.cpp UTM origin)
                e0, n0 = self._proj.project(float(ins["latitude"]),
                                            float(ins["longitude"]),
                                            relative=False)
                self._gps_anchor = (float(np.ravel(e0)[0]),
                                    float(np.ravel(n0)[0]),
                                    float(ins.get("altitude", 0.0)))
                self._map_anchor = np.asarray(pose_ref[:3, 3], float).copy()
            e, n = self._proj.project(float(ins["latitude"]),
                                      float(ins["longitude"]),
                                      relative=False)
            a0 = self._gps_anchor
            gps_xyz = np.asarray(
                [float(np.ravel(e)[0]) - a0[0] + self._map_anchor[0],
                 float(np.ravel(n)[0]) - a0[1] + self._map_anchor[1],
                 float(ins.get("altitude", 0.0)) - a0[2]
                 + self._map_anchor[2]], np.float32)
            # time-align the fix to the SCAN-END pose the keyframe
            # stores: extrapolate with the fix's own ENU velocity
            # (ref: ins_driver.cpp trigger interpolates the fix to the
            # requested stamp; hdl flush_gps_queue interpolates gps to
            # keyframe stamps)
            fix_ts = float(ins.get("timestamp", ts))
            dt_s = (ts + frame.timestep - fix_ts) / 1e6
            if abs(dt_s) < 1.0:
                gps_xyz = gps_xyz + np.asarray(
                    [float(ins.get("Ve", 0.0)),
                     float(ins.get("Vn", 0.0)),
                     float(ins.get("Vu", 0.0))],
                    np.float32) * np.float32(dt_s)
            # information scaled by fix quality (ref slam.cpp status
            # priority; hdl gps_edge_stddev_xy): RTK-fix sigma 0.1 m,
            # float 0.5 m, single 2 m
            gps_info = {2: 100.0, 1: 4.0}.get(prio, 0.25)
            # ingest-side outlier gate vs the locally-accurate SLAM
            # pose: a "fixed" status 20 m from the estimate is a
            # multipath jump, not a correction
            if np.linalg.norm(gps_xyz[:2] - pose_ref[:2, 3]) > 5.0:
                gps_xyz = gps_info = None
            if "Ve" in ins:
                vel_obs = np.asarray([float(ins.get("Ve", 0.0)),
                                      float(ins.get("Vn", 0.0)),
                                      float(ins.get("Vu", 0.0))],
                                     np.float32)
                vel_obs_valid = np.asarray(True)
        # INS attitude -> keyframe orientation prior (ref
        # hdl_graph_slam_nodelet.cpp:462-521), same acceptance gate
        # as the GPS priors so only trustworthy fixes constrain
        # attitude; heading is NED-clockwise degrees -> ENU yaw
        orient_quat = None
        if gps_xyz is not None and ins.get("heading") is not None:
            R = np_so3.rpy_to_matrix(
                np.deg2rad(float(ins.get("roll", 0.0) or 0.0)),
                np.deg2rad(float(ins.get("pitch", 0.0) or 0.0)),
                np.deg2rad(90.0 - float(ins.get("heading", 0.0) or 0.0)))
            orient_quat = np_so3.matrix_to_quat(R)
        images = {k: v for k, v in (frame.images or {}).items()
                  if isinstance(v, (bytes, bytearray))}
        if isinstance(self.engine, RtkMapper):
            # RTKM mode: feed the raw fix stream; pose comes from RTK
            # interpolation, not LiDAR odometry (rtkm.cpp feedInsData)
            if ins and d.get("ins_valid") and accepted:
                fix = dict(ins)
                fix.setdefault("timestamp", ts)
                self.engine.feed_ins(fix)
            return self.engine.process_scan(
                frame.scan.points[:, :3], frame.scan.stamps,
                frame.scan.mask, stamp_us=frame.scan.timestamp,
                gps_xyz=gps_xyz, images=images)
        return self.engine.process_scan(
            frame.scan.points[:, :3], frame.scan.stamps,
            frame.scan.mask,
            imu_rel.astype(np.float32), imu_mask,
            stamp_us=frame.scan.timestamp, gps_xyz=gps_xyz,
            gps_info=gps_info,
            vel_obs=vel_obs, vel_obs_valid=vel_obs_valid,
            images=images, orient_quat=orient_quat)

    def _process_localization(self, d: Dict, frame) -> Dict:
        # IMU sample + GNSS fix (projected into the map frame via the
        # map's origin anchor) feed the UKF fusion
        gyro = acc = gps = None
        if frame.imu is not None and frame.imu.mask.any():
            last = np.asarray(frame.imu.data)[int(frame.imu.mask.sum()) - 1]
            gyro, acc = last[1:4], last[4:7]
        ins = d.get("ins_data") or {}
        gps_var = 4.0
        ins_yaw = None
        if d.get("ins_valid") and ins.get("latitude") \
                and int(ins.get("Status", 0)) != 0:
            gps = self.engine.project_fix(float(ins["latitude"]),
                                          float(ins["longitude"]),
                                          float(ins.get("altitude", 0.0)))
            if ins.get("heading") is not None:
                # NED-clockwise degrees -> ENU yaw (rad); arbitrates
                # flipped/aliased reloc hypotheses and tracking
                ins_yaw = float(np.deg2rad(
                    90.0 - float(ins.get("heading") or 0.0)))
            # measurement variance from fix quality (ref slam.cpp
            # status priority -> covariance-weighted LIO/GPS fusion,
            # docs/slam.md:200-214): RTK-fix sigma 0.5 m, float 1 m,
            # single 2 m.  In localization mode the map match is the
            # cm-accurate absolute source and GNSS is the divergence
            # guard + reloc arbiter.
            gps_var = {42: 0.25, 52: 1.0}.get(int(ins.get("Status", 0)), 4.0)
        # full scan stamps + IMU batch feed the localizer's
        # side-running LIO odometry (relative times like mapping)
        imu_rel = imu_mask = None
        if frame.imu is not None:
            imu_rel = _relative_imu(frame.imu.data, frame.scan.timestamp).astype(np.float32)
            imu_mask = frame.imu.mask
        out = self.engine.process_scan(frame.scan.points[:, :3],
                                       frame.scan.mask,
                                       stamp_us=frame.scan.timestamp,
                                       imu_gyro=gyro, imu_acc=acc,
                                       gps_xyz=gps, gps_var=gps_var,
                                       ins_yaw=ins_yaw,
                                       stamps=frame.scan.stamps,
                                       imu=imu_rel,
                                       imu_mask=imu_mask)
        if out.get("pose") is None and gps is not None:
            # fallback chain (ref slam.cpp:440-455): while the
            # localizer is lost/relocalizing, publish the RTK-only
            # position (orientation held) instead of freezing the
            # last fused pose — the published stream must keep
            # following the vehicle
            T = np.asarray(self.last_pose, float).copy()
            T[:2, 3] = np.asarray(gps, float)[:2]
            self.last_pose = T
        return out

def shipped_detector_weights(det_cfg) -> Optional[str]:
    """Path of the in-repo trained checkpoint matching ``det_cfg``'s
    capacity, or None.  The reference capacity (+-64 m, 0.2 m pillars, 640^2
    grid) and the deployed pitch (0.1 m pillars, 1280^2 fine grid) ship
    trained weights; ``pc_range``, ``voxel_size`` and ``s2d_factor`` must
    match exactly."""
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "weights")

    def _matches(ref):
        return (tuple(det_cfg.pc_range) == tuple(ref.pc_range)
                and tuple(det_cfg.voxel_size) == tuple(ref.voxel_size)
                and getattr(det_cfg, "s2d_factor", 1) == ref.s2d_factor)

    for ref, name in ((DetectorConfig.true_reference_capacity(), "detector_true_refcap.msgpack"),
                      (DetectorConfig.reference_capacity(), "detector_refcap.msgpack")):
        p = os.path.join(root, name)
        if _matches(ref) and os.path.exists(p):
            return p
    return None


def build_detector_predict_fn(weights: Optional[str] = None, det_cfg=None, with_seg: bool = False,
                              allow_random_init: bool = False, device: DeviceLike = None):
    """A ``(points, mask) -> (boxes, scores, labels, keep)`` function (with
    ``with_seg`` also the (H, W, 1) freespace logits) from the port's
    CenterPoint detector in bf16, as the reference serves it, with
    ``weights`` (a flax msgpack checkpoint; for DSVT-Pillar, which ships
    none, one that ``params_io.state_dict_to_tree`` nested) and the
    reference's postprocessing.

    With no ``weights`` the shipped checkpoint that matches the capacity is
    used; where none matches this raises, unless ``allow_random_init``
    (the reference's behaviour).  points (N, >=4), as host arrays or
    tensors; columns past the fourth (the accumulator's frame lag) are
    dropped.  The outputs are tensors on ``device`` (the card unless the
    caller asks for the CPU); the function makes no host sync: uploads are
    pinned and asynchronous, and nothing is read back.  The model is
    ``fn.model``."""
    cfg = det_cfg or DetectorConfig()
    dev = resolve_device(device)
    # the heads' last convolutions are float32 in the reference: no TF32
    set_slam_precision()
    model = CenterPointDetector(cfg)
    if not weights:
        weights = shipped_detector_weights(cfg)
        if weights is None and not allow_random_init:
            raise ValueError(
                "detection.enable=true but no detection.weights configured "
                "and no shipped checkpoint matches this capacity — refusing "
                "to serve a random-init model (set detection.weights, use "
                "capacity: reference, or train one)")
    if weights:
        model.load_state_dict(detector_params_from_flax(load_params(weights)))
    else:
        init_detector_params(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval().requires_grad_(False).fold()
    pcfg = PostProcessConfig()

    @torch.inference_mode()
    def predict(points, mask):
        with span("detect/upload"):
            points, mask = to_device(points, dev, torch.float32), to_device(mask, dev, torch.bool)
        preds = model(points[:, :4], mask)
        out = postprocess(pcfg, *model.decode(preds))
        return out + (preds["seg"],) if with_seg else out

    predict.model = model
    return predict


def _get(obj, key, default=None):
    if obj is None:
        return default
    if isinstance(obj, dict):
        return obj.get(key, default)
    return getattr(obj, key, default)


class DetectModule(Module):
    """Detection stage: model forward -> postprocess -> (camera fusion) ->
    tracker -> filter.  Everything runs on ``device`` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, cfg, device: DeviceLike = None):
        super().__init__("Detect", blocking=cfg.input.mode == "offline")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.predict_fn = None
        self.tracker = None
        self.obj_filter = None

    def setup(self, cfg) -> None:
        self.tracker = Tracker3D(TrackerConfig(), device=self.device)

        # cfg.roi entries ({contour: [[x,y],...], is_included: bool} — the
        # reference's board_cfg roi schema) become the filter's polygons
        def build_filter(roi_list):
            inc, exc = [], []
            for r in (roi_list or []):
                get = (r.get if isinstance(r, dict)
                       else lambda k, d=None: getattr(r, k, d))
                poly = get("contour") or []
                if len(poly) >= 3:
                    (inc if get("is_included", True) else exc).append(
                        np.asarray(poly, float))
            self.obj_filter = ObjectFilter(include_polygons=inc or None,
                                           exclude_polygons=exc or None)
            return "ok"

        build_filter(getattr(cfg, "roi", None))
        register_interface("detect.set_roi", build_filter)
        n_acc = int(getattr(cfg.detection, "accum_frames", 2) or 1)
        self.accumulator = FrameAccumulator(num_frames=n_acc) if n_acc > 1 else None
        self.det_cfg_ref = None
        if bool(getattr(cfg.detection, "enable", False)):
            try:
                cap = str(getattr(cfg.detection, "capacity", "reference"))
                self.det_cfg_ref = (
                    DetectorConfig.true_reference_capacity()
                    if cap in ("true_reference", "deployed")
                    else DetectorConfig.reference_capacity()
                    if cap == "reference"
                    else DetectorConfig.dsvt_pillar()
                    if cap == "dsvt_pillar" else DetectorConfig())
                self.predict_fn = build_detector_predict_fn(
                    weights=getattr(cfg.detection, "weights", None),
                    det_cfg=self.det_cfg_ref, with_seg=True, device=self.device)
            except ValueError:
                # enabled without usable weights is fatal: serving no
                # detections while configured to detect would mask it
                raise
            except Exception as e:  # model load failure degrades gracefully
                self.logger.error("detector unavailable: %s", e)
        # the camera mono3D beside the lidar engine, late-fused
        self.mono3d = None
        self._mono3d_cams = {}
        m3 = _get(cfg.detection, "mono3d")
        if m3 is not None and bool(_get(m3, "enable", False)):
            from ..detection.mono3d_infer import Mono3DInfer
            self._mono3d_cams = SlamModule._camera_params(cfg)
            try:
                self.mono3d = Mono3DInfer(
                    weights=_get(m3, "weights") or None,
                    score_thresh=float(_get(m3, "score_threshold", 0.3)),
                    device=self.device)
                self._mono3d_cam_name = _get(m3, "camera")
            except ValueError:
                raise      # enabled without weights is fatal, like lidar
            except Exception as e:
                self.logger.error("mono3d unavailable: %s", e)

    def _run_mono3d_fusion(self, d: Dict, frame, lidar_objs):
        """Mono3D on the frame's camera image + late fusion with the
        lidar list; returns the fused object list (lidar-frame boxes)."""
        name = getattr(self, "_mono3d_cam_name", None)
        images = frame.images or {}
        if name is None and images:
            name = next((n for n in images if n in self._mono3d_cams), None)
        cam = self._mono3d_cams.get(str(name)) if name is not None else None
        img = images.get(str(name)) if name is not None else None
        if cam is None or not isinstance(img, (bytes, bytearray, np.ndarray)):
            return lidar_objs
        V2C = np.asarray(cam["T_cam_from_lidar"], float)
        det = self.mono3d.detect(img, cam["K"], C2V=np.linalg.inv(V2C))
        if det["K_scaled"] is None:
            return lidar_objs
        fused = fuse_camera_lidar(lidar_objs, det["camera_objs"], V2C,
                                  det["K_scaled"],
                                  image_hw=self.mono3d.cfg.image_hw,
                                  heat=det["heat"])
        out = []
        for o in fused:
            if o.get("fused") == "unmatch_camera":
                if o.get("box_lidar") is None:
                    continue           # no extrinsic -> can't track it
                o = dict(o, box=np.asarray(o["box_lidar"], np.float32))
            out.append(o)
        return out

    def set_model(self, predict_fn, det_cfg=None) -> None:
        """predict_fn(points (N,4), mask) -> (boxes, scores, labels, mask[,
        freespace logits]).  ``process`` turns the logits into
        ``d["freespace"]`` where it knows the ``DetectorConfig``: from
        ``setup``, or ``det_cfg`` here (the one ``predict_fn`` was built at)."""
        self.predict_fn = predict_fn
        if det_cfg is not None:
            self.det_cfg_ref = det_cfg

    def process(self, d: Dict) -> Optional[Dict]:
        with span("detect/parse"):
            frame = frame_from_dict(d)
        motion = frame.motion if frame.motion_valid else None
        if frame.scan is None or self.predict_fn is None:
            # camera-only mono3D: the mono model still yields tracked
            # objects when no lidar engine is configured
            if getattr(self, "mono3d", None) is not None:
                fused = self._run_mono3d_fusion(d, frame, [])
                if fused:
                    with span("detect/tracker"):
                        out = self.tracker.update(
                            np.stack([o["box"] for o in fused]),
                            np.asarray([o["score"] for o in fused], np.float32),
                            np.asarray([o["label"] for o in fused], np.int32),
                            dt=frame.timestep / 1e6, motion=motion)
                    out = self.obj_filter.filter(out)
                    d["objects"] = out["objects"]
                    return d
            d.setdefault("objects", [])
            return d
        pts, msk = frame.scan.points, frame.scan.mask
        if self.accumulator is not None:
            if self.accumulator.cap != pts.shape[0]:
                self.accumulator = type(self.accumulator)(
                    num_frames=self.accumulator.num_frames,
                    capacity_per_frame=pts.shape[0])
            with span("detect/accumulate"):
                pts, msk = self.accumulator.push(pts, msk, motion=motion)
        out_t = self.predict_fn(pts, msk)
        with span("detect/fetch"):
            out_t = (fetch(*out_t) if all(isinstance(t, torch.Tensor) for t in out_t)
                     else [np.asarray(t) for t in out_t])
        boxes, scores, labels, bmask = out_t[:4]
        if len(out_t) > 4 and self.det_cfg_ref is not None:
            with span("detect/freespace"):
                d["freespace"] = seg_to_freespace(out_t[4], self.det_cfg_ref.pc_range,
                                                  self.det_cfg_ref.voxel_size[0])
        keep = np.asarray(bmask, bool)
        det_boxes, det_scores, det_labels = boxes[keep], scores[keep], labels[keep]
        if getattr(self, "mono3d", None) is not None:
            lidar_objs = [dict(box=det_boxes[i], score=float(det_scores[i]),
                               label=int(det_labels[i]), source="lidar")
                          for i in range(len(det_boxes))]
            fused = self._run_mono3d_fusion(d, frame, lidar_objs)
            if fused:
                det_boxes = np.stack([o["box"] for o in fused])
                det_scores = np.asarray([o["score"] for o in fused], np.float32)
                det_labels = np.asarray([o["label"] for o in fused], np.int32)
            else:
                det_boxes = np.zeros((0, 7), np.float32)
                det_scores = np.zeros((0,), np.float32)
                det_labels = np.zeros((0,), np.int32)
        with span("detect/tracker"):
            out = self.tracker.update(det_boxes, det_scores, det_labels,
                                      dt=frame.timestep / 1e6, motion=motion)
        out = self.obj_filter.filter(out)
        d["objects"] = out["objects"]
        return d


class FrameSinkModule(Module):
    """Recorder sink (ref module/sink/frame_sink.py)."""

    def __init__(self, cfg):
        super().__init__("FrameSink")
        rec = cfg.system.record
        self.recorder = FrameRecorder(rec.path, frames_per_log=rec.frames_per_log,
                                      max_logs=rec.max_logs)
        self.enabled = bool(rec.use)
        register_interface("record.start", self.start_record)
        register_interface("record.stop", self.stop_record)

    def start_record(self) -> None:
        self.enabled = True
        # journal snapshot beside the recording for post-mortem
        # (ref frame_sink.py:90-94 journalctl/dmesg capture; best-effort:
        # capture_journal returns None where the logs cannot be read)
        if self.recorder.log_dir:
            capture_journal(self.recorder.log_dir)

    def stop_record(self) -> None:
        self.enabled = False
        self.recorder.log_dir = None

    def process(self, d: Dict) -> Optional[Dict]:
        if self.enabled:
            rec = {k: v for k, v in d.items() if not k.startswith("_")}
            self.recorder.write(rec)
        return d


class EvalDumpSink(Module):
    """SLAM-vs-RTK pose pair dump for accuracy evaluation.

    Re-derivation of the reference's (disabled-by-default) DumpSink
    (module/sink/dump_sink.py): per frame with a valid SLAM pose and a
    valid INS fix, append one row
        ts slam_x slam_y slam_z rtk_x rtk_y rtk_z rtk_heading_deg
    with RTK projected into a metric frame anchored at the first fix —
    the raw material for the docs/slam.md localization-error table."""

    def __init__(self, cfg, out_path: str = "output/dump_data.txt"):
        super().__init__("EvalDump")
        self.out_path = out_path
        self.enabled = bool(getattr(getattr(cfg, "output", {}), "eval_dump",
                                    False))
        self._f = None
        self._proj = None
        register_interface("evaldump.start", self.start_dump)
        register_interface("evaldump.stop", self.stop_dump)

    def start_dump(self) -> None:
        self.enabled = True

    def stop_dump(self) -> None:
        self.enabled = False
        if self._f:
            self._f.close()
            self._f = None

    def process(self, d: Dict) -> Optional[Dict]:
        if not self.enabled:
            return d
        ins = d.get("ins_data") or {}
        pose = d.get("slam_pose")
        if pose is None or not ins or not ins.get("latitude"):
            return d
        if int(ins.get("Status", 0)) == 0:
            return d
        if self._proj is None:
            self._proj = UTMProjector()
        x, y = self._proj.project(float(ins["latitude"]),
                                  float(ins["longitude"]))
        if self._f is None:
            os.makedirs(os.path.dirname(self.out_path) or ".", exist_ok=True)
            self._f = open(self.out_path, "a", buffering=1)
        T = np.asarray(pose, float).reshape(4, 4)
        self._f.write("%d %.4f %.4f %.4f %.4f %.4f %.4f %.3f\n" % (
            int(d.get("frame_start_timestamp", 0)),
            T[0, 3], T[1, 3], T[2, 3],
            x, y, float(ins.get("altitude", 0.0)),
            float(ins.get("heading", 0.0))))
        return d

    def release(self) -> None:
        self.stop_dump()


class UdpSinkModule(Module):
    """Protobuf Detection over UDP (ref module/sink/udp_sink.py)."""

    def __init__(self, cfg):
        super().__init__("UdpSink")
        proto_cfg = cfg.output.protocol.UDP
        self.enabled = bool(proto_cfg.use)
        self.dest = (str(proto_cfg.dest), int(proto_cfg.port))
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def process(self, d: Dict) -> Optional[Dict]:
        if self.enabled:
            payload = serialize_detection(dict(
                timestamp=d.get("frame_timestamp_monotonic", 0),
                objects=d.get("objects", []),
                fps=self.fps.fps))
            self.sock.sendto(payload, self.dest)
        return d


class HttpSinkModule(Module):
    """On-demand protobuf provider for the web preview
    (ref module/sink/http_sink.py: serialization only runs while a client
    polls; auto-stops 2 s after the last request)."""

    def __init__(self, cfg):
        super().__init__("HttpSink", queue_size=2)
        self.latest: Optional[bytes] = None
        self.latest_raw: Optional[bytes] = None
        self.last_request = 0.0
        self.last_raw_request = 0.0
        self._lock = threading.Lock()
        register_interface("sink.get_proto_http", self.get_proto_http)
        register_interface("sink.get_proto_http_raw", self.get_proto_http_raw)

    def process(self, d: Dict) -> Optional[Dict]:
        if time.monotonic() - self.last_request < 2.0:
            payload = serialize_detection(dict(
                timestamp=d.get("frame_timestamp_monotonic", 0),
                objects=d.get("objects", []),
                radar=d.get("radar"),
                freespace=d.get("freespace"),
                fps=self.fps.fps), include_points=False)
            with self._lock:
                self.latest = payload
        if time.monotonic() - self.last_raw_request < 2.0:
            clouds = {str(k): np.asarray(v, np.float32).reshape(-1, 4)
                      for k, v in (d.get("points") or {}).items()}
            raw = serialize_pointcloud_map(clouds)
            with self._lock:
                self.latest_raw = raw
        return d

    def get_proto_http(self) -> Optional[bytes]:
        self.last_request = time.monotonic()
        with self._lock:
            return self.latest

    def get_proto_http_raw(self) -> Optional[bytes]:
        """Raw per-lidar pointcloud frame as internal.proto
        LidarPointcloudMap (ref http_sink.get_proto_http_raw ->
        /v1/lidar-pointcloud-map)."""
        self.last_raw_request = time.monotonic()
        with self._lock:
            return self.latest_raw


class SinkModule(Module):
    """Fan-in sink wrapper owning the concrete sinks
    (ref module/sink/sink_manager.py)."""

    def __init__(self, cfg):
        super().__init__("Sink")
        self.sinks: List[Module] = [FrameSinkModule(cfg), UdpSinkModule(cfg),
                                    HttpSinkModule(cfg), EvalDumpSink(cfg),
                                    DataBank()]

    def setup(self, cfg) -> None:
        for s in self.sinks:
            s.setup(cfg)

    def process(self, d: Dict) -> Optional[Dict]:
        for s in self.sinks:
            s.process(d)
        return d

    @property
    def data_bank(self) -> DataBank:
        return self.sinks[-1]
