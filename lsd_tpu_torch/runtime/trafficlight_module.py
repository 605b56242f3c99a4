"""Trafficlight inference pipeline stage (counterpart of
``lsd_tpu/runtime/trafficlight_module.py``).

``TrafficlightModule`` consumes camera frames, selects the map lights in
view of the current pose, runs the 2D detector and attaches proto-ready
``lights`` to the frame.  Unlike the reference it has no gate on OpenCV
being installed: a frame with an image and selected lights reaches the
model, or raises (``utils.image.load_image`` needs OpenCV only for
compressed bytes; arrays need nothing).

``build_yolo_predict_fn`` serves the port's ``Yolo2D`` (bf16, float32
heads) on the card: the uint8 frame goes up pinned and is resized there as
``cv2.resize`` resizes it, decode and ``nms_2d`` run with no host sync, and
one packed copy brings boxes, scores, labels and the keep mask back.  With
``cfg`` None it builds the reference's ``Yolo2DConfig()`` (8 classes); a
checkpoint whose heads do not match raises ``ValueError`` when the function
is built.  The shipped ``weights/yolo2d_trafficlight.msgpack`` has 4
classes (it was trained with ``Yolo2DConfig(num_classes=4)``), so it is
served with that config and given to the module with ``set_model``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..convert import load_camera_params
from ..detection.trafficlight import MapLight, match_detections, select_lights
from ..models.mono3d import init_camera_params, maps_hwc
from ..models.params_io import load_params
from ..models.yolo2d import Yolo2D, Yolo2DConfig, decode_yolo2d, nms_2d
from ..utils.device import DeviceLike, fetch, resolve_device, to_device
from ..utils.image import load_image, resize_linear
from ..utils.spans import span
from .pipeline import Module


class TrafficlightModule(Module):
    def __init__(self, cfg, device: DeviceLike = None):
        super().__init__("Trafficlight", blocking=cfg.input.mode == "offline")
        self.cfg = cfg
        self.device = device
        self.predict_fn = None
        self.map_lights: List[MapLight] = []
        self.K = np.asarray([[1000.0, 0, 960], [0, 1000, 540], [0, 0, 1]])
        self.image_size = (1920, 1080)
        self.camera_name: Optional[str] = None

    def setup(self, cfg) -> None:
        tl = getattr(cfg, "trafficlight", None) or {}
        for l in tl.get("lights", []):
            self.map_lights.append(MapLight(str(l["name"]),
                                            np.asarray(l["position"], float)))
        if tl.get("intrinsic") is not None:
            self.K = np.asarray(tl["intrinsic"], float)
        if tl.get("image_size") is not None:
            self.image_size = tuple(tl["image_size"])
        self.camera_name = tl.get("camera")
        if tl.get("enable"):
            try:
                self.predict_fn = build_yolo_predict_fn(tl.get("weights"), device=self.device)
            except ValueError:
                # a checkpoint that does not fit the config is fatal:
                # serving no lights while configured to detect would mask it
                raise
            except Exception as e:
                self.logger.warning("trafficlight model unavailable: %s", e)

    def set_model(self, predict_fn) -> None:
        """predict_fn(image (H, W, 3) uint8) -> (boxes, scores, labels, keep)."""
        self.predict_fn = predict_fn

    def process(self, d: Dict) -> Optional[Dict]:
        if not (self.predict_fn and self.map_lights and d.get("image")):
            d.setdefault("lights", [])
            return d
        name = self.camera_name or next(iter(d["image"]))
        img = d["image"].get(name)
        if img is not None:
            img = load_image(img, rgb=False)
        if img is None:
            d.setdefault("lights", [])
            return d
        pose = np.asarray(d.get("slam_pose", np.eye(4)), float)
        sel = select_lights(pose, self.map_lights, self.K, image_size=self.image_size)
        if not sel:
            d["lights"] = []
            return d
        boxes, scores, labels, keep = self.predict_fn(img)
        d["lights"] = match_detections(sel, boxes, scores, labels, keep)
        return d


def build_yolo_predict_fn(weights: Optional[str] = None, input_hw=(256, 320),
                          cfg: Optional[Yolo2DConfig] = None, device: DeviceLike = None):
    """image (H, W, 3) uint8 (as decoded: BGR) -> (boxes xyxy in the
    image's pixels, scores, labels, keep) as numpy arrays, through the
    port's ``Yolo2D`` on ``device``.  Without ``weights`` the model is
    randomly initialised (seed 0), as the reference's is."""
    cfg = cfg or Yolo2DConfig()
    dev = resolve_device(device)
    model = Yolo2D(cfg)
    if weights:
        load_camera_params(model, load_params(weights))
    else:
        init_camera_params(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval().requires_grad_(False)
    H, W = input_hw

    @torch.inference_mode()
    def run(image):
        with span("camera/prep"):
            x = resize_linear(to_device(image, dev), (H, W)).float() / 255.0
        with span("camera/yolo2d"):
            preds = maps_hwc(model(x.permute(2, 0, 1)[None]))
        with span("camera/decode"):
            boxes, scores, labels, mask = decode_yolo2d(preds, cfg.stride, cfg.max_boxes)
        with span("camera/nms"):
            keep = nms_2d(boxes, scores, mask)
        return boxes, scores, labels, keep

    def predict(image):
        ih, iw = image.shape[:2]
        out = run(image)
        with span("camera/fetch"):
            boxes, scores, labels, keep = fetch(*out)
        # boxes back to the image's own pixels
        return boxes * np.asarray([iw / W, ih / H, iw / W, ih / H]), scores, labels, keep

    predict.model = model
    return predict
