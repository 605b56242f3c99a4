"""GStreamer capture-pipeline builder for the camera sources
(a copy of ``lsd_tpu/runtime/gst_caps.py`` for the port).

Re-derivation of the reference's cap-string generator
(module/source/camera_data_manager.py:67-130 _generate_cap_string +
hardware/gstreamer/{jetson,base}/driver.py templates): given a camera
config (name scheme + input/output geometry + flip/crop/undistort), emit
the gst-launch pipeline string for that source on the current platform.

Two template sets, selected like the reference's is_jetson() switch:
  * jetson — NVMM zero-copy elements (nvv4l2camerasrc, nvvidconv,
    nvjpegdec); detected via /etc/nv_tegra_release.
  * generic — pure software elements (v4l2src, videoconvert, videoscale,
    videoflip, jpegdec) that work with any stock GStreamer.

The strings feed cv2.VideoCapture(cap, CAP_GSTREAMER) when OpenCV has
the gstreamer backend (camera_source.CameraUnit tries this first), and
are also what a user would paste into gst-launch-1.0 to debug a sensor.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

# videoflip method names per v4l2/nvvidconv flip-method index
_FLIP_GENERIC = {0: None, 1: "counterclockwise", 2: "rotate-180",
                 3: "clockwise", 4: "horizontal-flip", 5: "upper-left-diagonal",
                 6: "vertical-flip", 7: "upper-right-diagonal"}


def is_jetson() -> bool:
    """Platform probe (ref hardware/platform_common.is_jetson)."""
    return os.path.exists("/etc/nv_tegra_release")


def _geom(cfg: Dict, prefix: str) -> str:
    w, h = cfg.get(prefix + "_width"), cfg.get(prefix + "_height")
    out = ""
    if w and h:
        out += f",width={int(w)},height={int(h)}"
    if prefix == "input" and cfg.get("format"):
        out += ",format={}".format(cfg["format"])
    return out


def _crop_jetson(crop: List[int], in_w: int, in_h: int) -> str:
    # crop = [top, bottom_margin?, left, right?] in the reference's
    # [t, b, l, r] margin convention (camera_data_manager get_crop call)
    t, b, left, r = crop
    return (f"! nvvidconv top={t} bottom={in_h - b} left={left} "
            f"right={in_w - r} ! video/x-raw(memory:NVMM),"
            f"width={in_w - left - r},height={in_h - t - b}")


def _crop_generic(crop: List[int], in_w: int, in_h: int) -> str:
    t, b, left, r = crop
    return f"! videocrop top={t} bottom={b} left={left} right={r}"


def build_cap_string(cfg: Dict, mode: str = "online") -> str:
    """Camera config dict -> pipeline string ('' when no scheme matches
    or the recording player serves the stream in offline mode).

    Name schemes (ref _generate_cap_string): bare digits = local CSI/v4l2
    device, ``usb:N`` = Nth by-id usb cam, ``rtsp://``, ``http://``
    (MJPEG over HTTP), ``flir:N`` (thermal).
    """
    if mode != "online":
        return ""
    name = str(cfg.get("name", ""))
    jet = cfg.get("jetson", is_jetson())
    in_p = _geom(cfg, "input")
    out_p = _geom(cfg, "output")
    in_w = int(cfg.get("input_width", 0) or 0)
    in_h = int(cfg.get("input_height", 0) or 0)

    flip = int(cfg.get("flip_method", 0) or 0)
    crop = cfg.get("crop")

    if jet:
        flip_s = (f"! nvvidconv flip-method={flip} "
                  f"! video/x-raw(memory:NVMM)") if flip else ""
        crop_s = _crop_jetson(crop, in_w, in_h) if crop else ""
        convert_out = f"! nvvidconv ! video/x-raw{out_p},format=I420"
    else:
        method = _FLIP_GENERIC.get(flip)
        flip_s = f"! videoflip method={method}" if method else ""
        crop_s = _crop_generic(crop, in_w, in_h) if crop else ""
        convert_out = (f"! videoconvert ! videoscale "
                       f"! video/x-raw{out_p},format=I420")

    sink = "! appsink sync=false drop=true max-buffers=2"

    if name.isdigit():
        device = f"/dev/video{int(name)}"
        src = (f"nvv4l2camerasrc device={device} "
               f"! video/x-raw(memory:NVMM){in_p}" if jet else
               f"v4l2src device={device} ! video/x-raw{in_p}")
        return " ".join(x for x in
                        [src, flip_s, crop_s, convert_out, sink] if x)

    if name.startswith("usb:"):
        device = usb_camera_device(int(name[4:]))
        if device is None:
            return ""
        src = f"v4l2src device={device} ! video/x-raw{in_p}"
        if jet:
            src += " ! videoconvert ! nvvidconv ! video/x-raw(memory:NVMM)"
        return " ".join(x for x in
                        [src, flip_s, crop_s, convert_out, sink] if x)

    if name.startswith("rtsp://"):
        src = (f"rtspsrc location={name} latency=0 ! decodebin")
        return " ".join(x for x in
                        [src, flip_s, crop_s, convert_out, sink] if x)

    if name.startswith("http://"):
        # the reference rewrites host:idx -> :17777/stream?topic=idx
        sep = name.find(":", 7)
        location = (name[:sep] + ":17777/stream?topic=" + name[sep + 1:]
                    if sep != -1 else name)
        dec = "! jpegparse ! nvjpegdec" if jet else "! jpegdec"
        src = f"souphttpsrc timeout=0 location={location} {dec}"
        return " ".join(x for x in
                        [src, crop_s, convert_out, sink] if x)

    if name.startswith("flir:"):
        src = f"flirsrc device={name[5:]} ! video/x-raw{in_p}"
        return " ".join(x for x in
                        [src, flip_s, crop_s, convert_out, sink] if x)

    return ""


def usb_camera_device(index: int) -> Optional[str]:
    """Nth usb camera by /dev/v4l/by-id index0 entries (ref
    camera_data_manager usb: scheme)."""
    byid = "/dev/v4l/by-id"
    if not os.path.isdir(byid):
        return None
    devices = []
    for entry in sorted(os.listdir(byid)):
        if "index0" in entry:
            target = os.path.realpath(os.path.join(byid, entry))
            devices.append(target)
    if index >= len(devices):
        return None
    return devices[index]


def cv2_has_gstreamer() -> bool:
    try:
        import cv2
        return "GStreamer:" in cv2.getBuildInformation() and \
            "YES" in cv2.getBuildInformation().split("GStreamer:")[1][:40]
    except Exception:
        return False
