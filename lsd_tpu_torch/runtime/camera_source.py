"""Camera source: cv2 capture -> JPEG-compressed frames in the frame dict
(a copy of ``lsd_tpu/runtime/camera_source.py`` for the port).

Re-derivation of module/source/camera_data_manager.py: per-camera capture
(v4l2 device index, video file, RTSP/HTTP URL — cv2.VideoCapture handles
the gstreamer-style sources the reference builds pipelines for), per-camera
image parameters (intrinsics + lidar->camera extrinsic), JPEG encoding for
the wire/preview path.  The gate is the reference's (``HAS_CV2``; a
``CameraUnit`` refuses to open without OpenCV), but ``cv2`` is imported
when a camera opens, not when the module is imported.
"""
from __future__ import annotations

import importlib.util
import time
from typing import Dict, List, Optional

from .pipeline import Module

HAS_CV2 = importlib.util.find_spec("cv2") is not None


class CameraUnit:
    def __init__(self, name: str, source, intrinsic=None, extrinsic=None,
                 jpeg_quality: int = 85, cam_cfg: Optional[Dict] = None):
        if not HAS_CV2:
            raise RuntimeError("cv2 unavailable; camera source disabled")
        import cv2
        self.name = name
        # prefer a gstreamer pipeline built from the camera config
        # (flip/crop/scale/undistort chain like the reference's
        # _generate_cap_string) when OpenCV has the backend
        self.cap = None
        if cam_cfg:
            from .gst_caps import build_cap_string, cv2_has_gstreamer
            cap_str = build_cap_string(dict(cam_cfg, name=name))
            if cap_str and cv2_has_gstreamer():
                cap = cv2.VideoCapture(cap_str, cv2.CAP_GSTREAMER)
                if cap.isOpened():
                    self.cap = cap
        if self.cap is None:
            self.cap = cv2.VideoCapture(source)
        if not self.cap.isOpened():
            raise OSError(f"camera source {source!r} failed to open")
        self.intrinsic = intrinsic
        self.extrinsic = extrinsic
        self.jpeg_quality = int(jpeg_quality)
        # per-frame undistortion (ref camera_data_manager.py:84
        # 'undistortion' key -> hardware/gstreamer gstopencvremap.cpp;
        # here a cv2.remap with maps precomputed on the first frame from
        # intrinsic_parameters [fx fy cx cy k1 k2 p1 p2 (k3)])
        self.undistort = bool((cam_cfg or {}).get(
            "undistortion", (cam_cfg or {}).get("undistort", False)))
        self._maps = None

    def _undistort_maps(self, hw):
        import cv2
        import numpy as np
        intr = list(self.intrinsic or [])
        if len(intr) < 8:
            return None
        fx, fy, cx, cy = intr[:4]
        dist = np.asarray(list(intr[4:9]) + [0.0] * (5 - len(intr[4:9])),
                          np.float64)
        K = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        h, w = hw
        m1, m2 = cv2.initUndistortRectifyMap(
            K, dist, None, K, (w, h), cv2.CV_16SC2)
        return m1, m2

    def grab(self) -> Optional[bytes]:
        import cv2
        ok, frame = self.cap.read()
        if not ok:
            return None
        if self.undistort:
            if self._maps is None:
                self._maps = self._undistort_maps(frame.shape[:2]) or False
            if self._maps:
                frame = cv2.remap(frame, self._maps[0], self._maps[1],
                                  cv2.INTER_LINEAR)
        ok, enc = cv2.imencode(".jpg", frame,
                               [cv2.IMWRITE_JPEG_QUALITY, self.jpeg_quality])
        return enc.tobytes() if ok else None

    def params(self) -> Dict:
        return dict(intrinsic=self.intrinsic, extrinsic=self.extrinsic,
                    timestamp=int(time.monotonic() * 1e6))

    def close(self) -> None:
        try:
            self.cap.release()
        except Exception:
            pass


class CameraSource(Module):
    """Standalone camera source module (cfg.camera: [{name, source,
    intrinsic?, extrinsic?}]); emits image-only frame dicts at frame rate."""

    def __init__(self, cfg):
        super().__init__("CameraSource")
        self.cfg = cfg
        self.units: List[CameraUnit] = []
        self.period = 1.0 / float(getattr(getattr(cfg, "input", {}), "camera_hz", 10.0))

    def setup(self, cfg) -> None:
        for cc in getattr(cfg, "camera", []):
            cc = dict(cc)
            try:
                self.units.append(CameraUnit(
                    name=str(cc.get("name", len(self.units))),
                    source=cc.get("source", cc.get("device", 0)),
                    intrinsic=cc.get("intrinsic",
                                     cc.get("intrinsic_parameters")),
                    extrinsic=cc.get("extrinsic",
                                     cc.get("extrinsic_parameters")),
                    cam_cfg=cc))
            except (OSError, RuntimeError) as e:
                self.logger.warning("camera %s unavailable: %s", cc.get("name"), e)

    def release(self) -> None:
        for u in self.units:
            u.close()
        self.units = []

    def get_data(self) -> Optional[Dict]:
        if not self.units:
            time.sleep(0.1)
            return None
        t0 = time.monotonic()
        images = {}
        params = {}
        for u in self.units:
            jpg = u.grab()
            if jpg is not None:
                images[u.name] = jpg
                params[u.name] = u.params()
        dt = self.period - (time.monotonic() - t0)
        if dt > 0:
            time.sleep(dt)
        if not images:
            return None
        ts = int(time.monotonic() * 1e6)
        return dict(frame_start_timestamp=ts, frame_timestamp_monotonic=ts,
                    points={}, points_attr={},
                    image=images, image_param=params,
                    lidar_valid=False, image_valid=True, radar_valid=False,
                    ins_valid=False, ins_data={}, motion_valid=False,
                    timestep=int(self.period * 1e6), _source="CameraSource")
