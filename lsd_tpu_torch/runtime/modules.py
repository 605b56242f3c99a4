"""The detection stage (counterpart of ``lsd_tpu/runtime/modules.py:508-775``
and ``:226-245``): ``shipped_detector_weights``,
``build_detector_predict_fn``, ``camera_params`` and ``DetectModule``.

``DetectModule.process`` runs the reference's sequence on one frame dict:
``detection.accumulate`` -> predict -> one packed fetch ->
``detection.freespace`` -> (with ``detection.mono3d.enable``: the camera
model and the late fusion) -> ``detection.tracker`` ->
``detection.object_filter``.  ``PlayerSource``, ``SlamModule`` and the
sinks are not ported yet, so ``camera_params`` (``SlamModule``'s static
method in the reference) is a function here.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..convert import detector_params_from_flax
from ..detection.post import PostProcessConfig, postprocess
from ..models.detector import CenterPointDetector, DetectorConfig, init_detector_params
from ..models.params_io import load_params
from ..calibration.service import cfg_to_transform
from ..detection.accumulate import FrameAccumulator
from ..detection.camera_fusion import fuse_camera_lidar
from ..detection.freespace import seg_to_freespace
from ..detection.object_filter import ObjectFilter
from ..detection.tracker import Tracker3D, TrackerConfig
from ..io.frame import frame_from_dict
from ..utils.device import DeviceLike, fetch, resolve_device, to_device
from ..utils.precision import set_slam_precision
from .interface import register_interface
from .pipeline import Module


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
    ``weights`` (a flax msgpack checkpoint) and the reference's
    postprocessing.

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
    model = model.to(dev).eval().requires_grad_(False)
    pcfg = PostProcessConfig()

    @torch.inference_mode()
    def predict(points, mask):
        points, mask = to_device(points, dev, torch.float32), to_device(mask, dev, torch.bool)
        preds = model(points[:, :4], mask)
        out = postprocess(pcfg, *model.decode(preds))
        return out + (preds["seg"],) if with_seg else out

    predict.model = model
    return predict


def camera_params(cfg) -> Dict:
    """Per-camera K + T_cam_from_lidar from the config (reference
    extrinsic_parameters convention)."""
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
                    if cap == "reference" else DetectorConfig())
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
            self._mono3d_cams = camera_params(cfg)
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

    def set_model(self, predict_fn) -> None:
        """predict_fn(points (N,4), mask) -> (boxes, scores, labels, mask)."""
        self.predict_fn = predict_fn

    def process(self, d: Dict) -> Optional[Dict]:
        frame = frame_from_dict(d)
        motion = frame.motion if frame.motion_valid else None
        if frame.scan is None or self.predict_fn is None:
            # camera-only mono3D: the mono model still yields tracked
            # objects when no lidar engine is configured
            if getattr(self, "mono3d", None) is not None:
                fused = self._run_mono3d_fusion(d, frame, [])
                if fused:
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
            pts, msk = self.accumulator.push(pts, msk, motion=motion)
        out_t = self.predict_fn(pts, msk)
        out_t = (fetch(*out_t) if all(isinstance(t, torch.Tensor) for t in out_t)
                 else [np.asarray(t) for t in out_t])
        boxes, scores, labels, bmask = out_t[:4]
        if len(out_t) > 4 and self.det_cfg_ref is not None:
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
        out = self.tracker.update(det_boxes, det_scores, det_labels,
                                  dt=frame.timestep / 1e6, motion=motion)
        out = self.obj_filter.filter(out)
        d["objects"] = out["objects"]
        return d
