"""HTTP API server: the reference's /v1 surface on the stdlib
(a copy of ``lsd_tpu/web/server.py`` for the port).

Re-derivation of web_backend/server.py + perception_server.py +
module/source/player_server.py + module/slam/slam_server.py route tables —
the same endpoints, served by a threading stdlib HTTP server (Flask is not
in the image; the API shape is what matters for UI parity):

    GET  /v1/config               POST /v1/config
    GET  /v1/restore-config       POST /v1/status
    POST /v1/detection-pb         (protobuf Detection bytes)
    GET  /v1/player-status        POST /v1/player-seek / -rate / -play /
                                       -pause / -step
    POST /v1/map-save             POST /v1/set-init-pose
    POST /api                     (JSON-RPC: method + params)

The web store's default file is in ``tempfile.gettempdir()`` (``/tmp`` in
the reference, the same directory unless ``TMPDIR`` names another); the
built-in UI is this package's own copy of ``lsd_tpu/web/www``.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

from ..runtime.interface import call_interface, has_interface
from ..runtime.perception import Perception
from ..utils.log import get_logger


def _id_of(body):
    """Editor payloads arrive either as {'id': n} or as a bare value."""
    if isinstance(body, dict):
        return body.get("id", 0)
    return body


class PerceptionServer:
    def __init__(self, perception: Perception):
        self.perception = perception
        self.logger = get_logger("web")
        self.httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        p = perception
        self.routes: Dict[Tuple[str, str], Callable[[Dict], Any]] = {
            ("GET", "/v1/config"): lambda q: p.get_config(),
            ("POST", "/v1/config"): lambda body: {"result": p.set_config(body)},
            ("GET", "/v1/restore-config"): self._restore_config,
            ("POST", "/v1/status"): self._status,
            ("GET", "/v1/status"): self._status,
            ("POST", "/v1/detection-pb"): self._detection_pb,
            ("GET", "/v1/player-status"): lambda q: (
                call_interface("player.get_status")
                if has_interface("player.get_status") else {"playing": False}),
            ("POST", "/v1/player-seek"): lambda b: self._call_ok("player.seek", b.get("percent", 0)),
            ("POST", "/v1/player-rate"): lambda b: self._call_ok("player.set_rate", b.get("rate", 1.0)),
            ("POST", "/v1/player-play"): lambda b: self._call_ok("player.resume"),
            ("POST", "/v1/player-pause"): lambda b: self._call_ok("player.pause"),
            ("POST", "/v1/player-step"): lambda b: self._call_ok("player.step"),
            ("POST", "/v1/map-save"): lambda b: self._call_ok("slam.save_map", b.get("path", "/tmp/lsd_tpu_map")),
            ("POST", "/v1/set-init-pose"): lambda b: self._call_ok("slam.set_init_pose", b.get("pose")),
            # map editor (ref slam_server.py /v1/map-* routes)
            ("GET", "/v1/graph-meta"): lambda q: self._call_ok("slam.get_graph_meta"),
            ("POST", "/v1/vertex-data"): lambda b: self._call_ok("slam.get_key_frame", b.get("id", 0)),
            ("POST", "/v1/add-edge"): lambda b: self._call_ok("slam.add_edge", b.get("prev"), b.get("next"), b.get("relative")),
            ("POST", "/v1/del-edge"): lambda b: self._call_ok("slam.del_edge", b.get("id")),
            ("POST", "/v1/set-vertex-fix"): lambda b: self._call_ok("slam.set_vertex_fix", b.get("id"), b.get("fix", True)),
            ("POST", "/v1/graph-optimize"): lambda b: self._call_ok("slam.graph_optimize"),
            ("GET", "/v1/slam-pose"): lambda q: {"pose": call_interface("slam.get_pose")} if has_interface("slam.get_pose") else {"pose": None},
            ("GET", "/v1/message-meta"): self._message_meta,
            ("POST", "/v1/message-data"): self._message_data,
            ("POST", "/v1/ipc-enable"): self._ipc_enable,
            ("POST", "/v1/detection-json"): self._detection_json,
            ("GET", "/v1/detection-json"): self._detection_json,
            ("POST", "/api"): self._jsonrpc,
        }
        self._message_server = None
        # --- reference-exact route names (web_backend/perception_server.py,
        # module/slam/slam_server.py, module/source/player_server.py,
        # web_backend/{message,system}_server.py, calibration_server.py) ---
        self.blacklist: set = set()
        self.client_users: Dict[str, Dict] = {}
        self._web_store: Dict = self._load_web_store()
        r = self.routes
        # user manager
        r[("GET", "/v1/client-users")] = self._client_users
        r[("POST", "/v1/add-blacklist")] = self._add_blacklist
        r[("POST", "/v1/remove-blacklist")] = self._remove_blacklist
        # roi
        r[("GET", "/v1/roi")] = lambda q: p.get_config().get("roi", [])
        r[("POST", "/v1/roi")] = self._set_roi
        # raw preview
        r[("GET", "/v1/lidar-pointcloud-map")] = \
            lambda q: self._proto_bytes("sink.get_proto_http_raw")
        # player server
        r[("GET", "/v1/player-start")] = lambda q: self._do(p.start)
        r[("GET", "/v1/player-pause")] = lambda q: self._do(p.pause)
        r[("GET", "/v1/record-files")] = self._record_files
        r[("POST", "/v1/play-record-file")] = self._play_record_file
        # slam server
        r[("GET", "/v1/restart-mapping")] = self._restart_mapping
        r[("POST", "/v1/rotate-ground-constraint")] = \
            lambda b: self._call_ok("slam.rotate_ground_constraint")
        r[("POST", "/v1/save-map")] = self._save_map
        r[("GET", "/v1/get-save-progress")] = \
            lambda q: str(call_interface("slam.get_save_progress")
                          if has_interface("slam.get_save_progress") else 0.0)
        r[("GET", "/v1/map-vertex")] = \
            lambda q: (call_interface("slam.get_vertex_poses")
                       if has_interface("slam.get_vertex_poses") else {})
        r[("GET", "/v1/map-status")] = \
            lambda q: (call_interface("slam.get_status")
                       if has_interface("slam.get_status") else {})
        r[("POST", "/v1/get-color-map")] = self._get_color_map
        r[("POST", "/v1/get-estimate-pose")] = \
            lambda b: self._call_ok("slam.get_estimate_pose",
                                    b.get("pose_range"))
        r[("GET", "/v1/map-files")] = self._map_files
        r[("POST", "/v1/open-map-file")] = self._open_map_file
        r[("POST", "/v1/merge-map-file")] = \
            lambda b: self._call_ok("slam.merge_map", b.get("map_file"))
        r[("POST", "/v1/map-del-vertex")] = \
            lambda b: self._call_ok("slam.del_vertex", _id_of(b))
        r[("POST", "/v1/map-del-edge")] = \
            lambda b: self._call_ok("slam.del_edge", _id_of(b))
        r[("POST", "/v1/map-add-area")] = \
            lambda b: self._call_ok("slam.add_area", b)
        r[("POST", "/v1/map-del-area")] = \
            lambda b: self._call_ok("slam.del_area", _id_of(b))
        r[("POST", "/v1/map-set-vertex-pose")] = \
            lambda b: self._call_ok("slam.set_vertex_pose", _id_of(b),
                                    b.get("pose"))
        r[("POST", "/v1/map-set-vertex-fix")] = \
            lambda b: self._call_ok("slam.set_vertex_fix", _id_of(b),
                                    b.get("fix", True))
        r[("GET", "/v1/map-optimize")] = \
            lambda q: self._call_ok("slam.graph_optimize")
        r[("POST", "/v1/set-export-map-config")] = \
            lambda b: self._call_ok("slam.set_export_map_config",
                                    b.get("z_min", -1e9), b.get("z_max", 1e9),
                                    b.get("color", False))
        r[("GET", "/v1/map-export-pcd")] = self._map_export_pcd
        # vertex-data ships the reference's internal.proto bytes
        r[("POST", "/v1/vertex-data")] = \
            lambda b: self._proto_bytes("slam.get_key_frame",
                                        _id_of(b), b.get("item", "p")
                                        if isinstance(b, dict) else "p")
        # raw f32 (N,4) keyframe cloud for the built-in editor UI
        r[("POST", "/v1/map-vertex-bin")] = \
            lambda b: (call_interface("slam.get_vertex_cloud", _id_of(b))
                       if has_interface("slam.get_vertex_cloud") else b"")
        # message server (TViz)
        r[("GET", "/v1/start-message-subscribe")] = \
            lambda q: self._subscribe_messages(True)
        r[("GET", "/v1/stop-message-subscribe")] = \
            lambda q: self._subscribe_messages(False)
        r[("GET", "/v1/get-message-meta")] = self._message_meta
        r[("POST", "/v1/get-message-data")] = self._message_data
        r[("POST", "/v1/publish-message")] = self._publish_message
        # system server
        r[("GET", "/v1/get-web-store")] = lambda q: self._web_store
        # calibration server
        r[("POST", "/v1/source-data")] = \
            lambda b: self._proto_bytes("calibration.get_calibrate_camera",
                                        p.get_config(),
                                        b.get("do_distort", False))
        r[("GET", "/v1/get-position-points")] = \
            lambda q: self._proto_bytes("calibration.get_position_points")
        r[("GET", "/v1/get-imu-position-points")] = \
            lambda q: self._proto_bytes("calibration.get_imu_position_points",
                                        p.get_config())
        # dev page (ref web_ui components/dev: Log, BoardConfig, dump)
        r[("GET", "/v1/log")] = self._recent_log
        r[("POST", "/v1/log-level")] = self._set_log_level
        # log files — same-origin mirrors of the :1235 upgrade-server
        # routes (ref web_ui rpc/http-upgrade.ts:52-56 + dev/Log.jsx),
        # so the built-in UI's dev Log view needs no cross-port fetch
        r[("GET", "/v1/log-file-list")] = self._log_file_list
        r[("GET", "/v1/log-content")] = self._log_content
        r[("GET", "/v1/log-download")] = self._log_download
        r[("GET", "/v1/get-panorama")] = \
            lambda q: self._proto_bytes("calibration.get_panorama")
        r[("GET", "/v1/set-panorama-config")] = self._set_panorama_config
        from ..calibration.service import register_calibration_interfaces
        register_calibration_interfaces()

    # reference-route handlers -------------------------------------------
    def _status(self, body: Dict) -> Dict:
        """Module status + wall-clock + record-disk usage (ref
        perception_server.get_status:85-90 adding time + disk)."""
        import datetime
        import shutil
        st = self.perception.get_status()
        st["time"] = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        disk = dict(has_disk=False, disk_name="", total=0, used_percent=0)
        try:
            root = self._record_root()
            import os
            probe = root if os.path.isdir(root) else "/"
            du = shutil.disk_usage(probe)
            disk = dict(has_disk=os.path.isdir(root),
                        disk_name=os.path.basename(root.rstrip("/")) or "/",
                        total=du.total,
                        used_percent=round(du.used / du.total * 100, 1))
        except OSError:
            pass
        st.setdefault("disk", {}).update(disk)
        return st

    def _do(self, fn, *args):
        fn(*args)
        return ""

    def _proto_bytes(self, name: str, *args) -> bytes:
        if not has_interface(name):
            return b""
        out = call_interface(name, *args)
        return out if isinstance(out, (bytes, bytearray)) else b""

    def _client_users(self, q: Dict) -> Dict:
        return {"users": self.client_users}

    def _add_blacklist(self, body: Dict) -> str:
        ip = body.get("ip", "")
        if ip in self.client_users:
            self.blacklist.add(ip)
            self.client_users[ip]["disable"] = True
        return "ok"

    def _remove_blacklist(self, body: Dict) -> str:
        ip = body.get("ip", "")
        self.blacklist.discard(ip)
        if ip in self.client_users:
            self.client_users[ip]["disable"] = False
        return "ok"

    def _set_roi(self, body: Dict) -> str:
        cfg = self.perception.get_config()
        cfg["roi"] = [body]
        self.perception.set_config(cfg)
        # apply live (cfg "roi" alone does not reset the pipeline)
        try:
            self.perception.call("detect.set_roi", [body])
        except KeyError:
            pass            # no Detect module in the pipeline
        return ""

    def _record_root(self) -> str:
        cfg = self.perception.get_config()
        return ((cfg.get("system") or {}).get("record") or {}).get(
            "path", "/tmp/lsd_tpu_records")

    def _list_dirs(self, root: str):
        import os
        if not os.path.isdir(root):
            return []
        return sorted(os.path.join(root, d) for d in os.listdir(root)
                      if os.path.isdir(os.path.join(root, d)))

    def _record_files(self, q: Dict):
        return self._list_dirs(self._record_root())

    def _map_files(self, q: Dict):
        import os
        return self._list_dirs(os.path.join(self._record_root(), "map"))

    def _play_record_file(self, body: Dict) -> str:
        cfg = self.perception.get_config()
        cfg.setdefault("input", {})["data_path"] = body.get("record_file", "")
        self.perception.set_config(cfg)
        return ""

    def _restart_mapping(self, q: Dict) -> str:
        p = self.perception
        p.pause()
        self._call_ok("slam.restart_mapping", dict(config=p.get_config()))
        p.start()
        return ""

    def _save_map(self, body: Dict) -> Dict:
        import os
        root = body.get("root_path") or os.path.join(self._record_root(),
                                                     "map")
        return self._call_ok("slam.save_mapping", root, body.get("name"))

    def _get_color_map(self, body: Dict) -> bytes:
        """Reassemble the segmented color-map stream in one response (ref
        slam_server.get_color_map polls segments of MAX_SEGMENT_LEN)."""
        from ..slam.map_editor import MAX_SEGMENT_LEN
        if not has_interface("slam.get_color_map"):
            return b""
        data = b""
        while True:
            segment = call_interface("slam.get_color_map")
            data += segment
            if len(segment) < MAX_SEGMENT_LEN:
                return data

    def _open_map_file(self, body: Dict) -> str:
        cfg = self.perception.get_config()
        cfg.setdefault("slam", {})["mode"] = "localization"
        cfg["slam"].setdefault("localization", {})["map_path"] = \
            body.get("map_file", "")
        cfg["slam"]["map_path"] = body.get("map_file", "")
        self._call_ok("slam.restart_mapping", dict(config=cfg))
        return ""

    def _map_export_pcd(self, q: Dict) -> bytes:
        out = self._call_ok("slam.export_map")
        path = out.get("result") if isinstance(out, dict) else None
        if not path:
            return b""
        with open(path, "rb") as f:
            return f.read()

    def _subscribe_messages(self, enable: bool) -> str:
        srv = self._ensure_message_server()
        if hasattr(srv, "set_enabled"):
            srv.set_enabled(enable)
        return "ok"

    def _publish_message(self, body: Dict) -> str:
        from ..comms import MessageBus
        payload = body.get("data", {})
        raw = json.dumps(payload).encode() if not isinstance(
            payload, (bytes, bytearray)) else bytes(payload)
        MessageBus.core().publish(body.get("channel", ""), raw)
        return "ok"

    def _set_web_store(self, store: Dict) -> Dict:
        self._web_store = store
        self._dump_web_store()
        return self._web_store

    def _web_store_path(self) -> str:
        import os
        return os.environ.get("LSD_TPU_WEB_STORE", os.path.join(
            tempfile.gettempdir(), "lsd_tpu_web_store.json"))

    def _load_web_store(self) -> Dict:
        import os
        path = self._web_store_path()
        if os.path.exists(path):
            try:
                with open(path) as f:
                    return json.load(f)
            except (ValueError, OSError):
                pass
        return {}

    def _dump_web_store(self) -> None:
        try:
            with open(self._web_store_path(), "w") as f:
                json.dump(self._web_store, f)
        except OSError:
            pass

    def _set_panorama_config(self, q: Dict):
        if not has_interface("calibration.set_panorama_config"):
            return {}
        result, cfg = call_interface("calibration.set_panorama_config",
                                     self.perception.get_config())
        self.perception.set_config(cfg)
        return result

    # TViz backend ------------------------------------------------------
    def _ensure_message_server(self):
        if self._message_server is None:
            from ..comms import MessageBus, MessageServer
            self._message_server = MessageServer(MessageBus.core())
        return self._message_server

    def _message_meta(self, q: Dict) -> Dict:
        return self._ensure_message_server().get_meta()

    def _message_data(self, body: Dict) -> Dict:
        srv = self._ensure_message_server()
        ch = body.get("channel", "")
        if body.get("field"):
            return {"series": srv.get_series(ch, body["field"])}
        out = srv.get_latest(ch)
        return out if out is not None else {}

    def _ipc_enable(self, body: Dict) -> Dict:
        from ..comms import MessageBus
        MessageBus.core().set_enabled(bool(body.get("enable", True)))
        return {"status": "ok"}

    # handlers ----------------------------------------------------------
    def _restore_config(self, q: Dict) -> Dict:
        from ..runtime.config import DEFAULT_CONFIG
        self.perception.config_manager.set_config(DEFAULT_CONFIG)
        return self.perception.get_config()

    def _detection_pb(self, body: Dict) -> bytes:
        if has_interface("sink.get_proto_http"):
            data = call_interface("sink.get_proto_http")
            if data:
                return data
        return b""

    def _detection_json(self, body: Dict) -> Dict:
        """JSON preview frame for the built-in web UI (points as base64
        float32 xyzi; objects in proto field names; pose; jpeg images)."""
        import base64

        import numpy as np
        out: Dict[str, Any] = {"valid": False}
        frame = (call_interface("databank.get_latest")
                 if has_interface("databank.get_latest") else None)
        if frame is None:
            return out
        out["valid"] = True
        out["timestamp"] = int(frame.get("frame_start_timestamp", 0))
        max_pts = int(body.get("max_points", 60000)) if isinstance(body, dict) else 60000
        clouds = [np.asarray(p, np.float32).reshape(-1, 4)
                  for p in frame.get("points", {}).values()]
        if clouds:
            pts = np.concatenate(clouds, axis=0)
            if len(pts) > max_pts:
                pts = pts[:: len(pts) // max_pts + 1]
            out["points_b64"] = base64.b64encode(
                np.ascontiguousarray(pts, np.float32).tobytes()).decode()
            out["num_points"] = int(len(pts))
        objs = []
        for o in frame.get("objects", []):
            b = np.asarray(o.get("box", np.zeros(7)), float)
            objs.append(dict(id=int(o.get("id", 0)),
                             label=int(o.get("label", 0)),
                             score=float(o.get("score", 0.0)),
                             box=[float(v) for v in b[:7]],
                             velocity=[float(v) for v in
                                       np.asarray(o.get("velocity", [0, 0, 0]), float)[:3]],
                             trajectory=[[float(v) for v in row[:3]]
                                         for row in np.asarray(
                                             o.get("trajectory", np.zeros((0, 7))), float)]))
        out["objects"] = objs
        if has_interface("slam.get_pose"):
            out["pose"] = call_interface("slam.get_pose")
        ins = frame.get("ins_data") or {}
        if ins:
            out["ins"] = {k: ins.get(k, 0) for k in
                          ("latitude", "longitude", "altitude", "heading",
                           "Status")}
        images = {}
        for name, img in (frame.get("image") or {}).items():
            if isinstance(img, (bytes, bytearray)):
                images[name] = base64.b64encode(bytes(img)).decode()
        if images:
            out["images_b64"] = images
        fs = frame.get("freespace")
        if isinstance(fs, dict) and fs.get("cells") is not None:
            out["freespace"] = {k: fs[k] for k in
                                ("x_min", "x_max", "y_min", "y_max",
                                 "resolution", "x_num", "y_num") if k in fs}
            out["freespace"]["cells_b64"] = base64.b64encode(
                bytes(fs["cells"])).decode()
        return out

    def _log_file_list(self, q: Dict) -> Dict:
        from .upgrade import default_log_dirs, list_log_files
        return list_log_files(default_log_dirs())

    def _log_content(self, q: Dict) -> Dict:
        from .upgrade import default_log_dirs, read_log_content
        fn = (q or {}).get("filename", "")
        return read_log_content(default_log_dirs(), fn)

    def _log_download(self, q: Dict) -> bytes:
        """File bytes when ?filename= names a log file; the in-memory
        recent-log ring otherwise."""
        from .upgrade import default_log_dirs, read_log_bytes
        fn = (q or {}).get("filename", "")
        if fn:
            return read_log_bytes(default_log_dirs(), fn)
        from ..utils.log import get_recent_logs
        return ("\n".join(get_recent_logs(500)) + "\n").encode()

    def _recent_log(self, q: Dict) -> Dict:
        from ..utils.log import get_recent_logs
        try:
            n = int(q.get("n", 200)) if isinstance(q, dict) else 200
        except (TypeError, ValueError):
            n = 200
        return {"lines": get_recent_logs(n)}

    def _set_log_level(self, body: Dict) -> Dict:
        from ..utils.log import set_logger_level
        level = str((body or {}).get("level", "INFO"))
        set_logger_level(level)
        return {"status": "ok", "level": level.upper()}

    def _call_ok(self, name: str, *args) -> Dict:
        if not has_interface(name):
            return {"status": "error", "message": f"no interface {name}"}
        out = call_interface(name, *args)
        return {"status": "ok", "result": out}

    def _jsonrpc(self, body: Dict) -> Dict:
        method = body.get("method", "")
        params = body.get("params", [])
        args, kwargs = ((params, {}) if isinstance(params, (list, tuple))
                        else ([], dict(params)))
        try:
            out = self._jsonrpc_call(method, args, kwargs)
        except KeyError:
            return {"id": body.get("id"), "error": f"unknown method {method}"}
        return {"id": body.get("id"), "result": out}

    def _cfg_call(self, name: str, *args, **kwargs):
        """Reference pattern for calibration RPCs: the interface returns
        (result, config) and the server commits the new config
        (calibration_server.py:75-138)."""
        result, cfg = call_interface(name, self.perception.get_config(),
                                     *args, **kwargs)
        self.perception.set_config(cfg)
        return result

    def _jsonrpc_call(self, method: str, args, kwargs):
        p = self.perception
        simple = {
            "reboot": lambda: {"status": "unsupported-in-dev"},
            "start_record": lambda: self._call_ok("record.start"),
            "stop_record": lambda: self._call_ok("record.stop"),
            "start_player": lambda: self._call_ok("player.resume"),
            "pause_player": lambda: self._call_ok("player.pause"),
            "dump": lambda: {"stacks": p.dump()},
            "set_web_store": lambda store: self._set_web_store(store),
            # slam editor RPCs (ref slam_server.py add_method set)
            "get_map_edge": lambda: (call_interface("slam.get_edge")
                                     if has_interface("slam.get_edge") else []),
            "get_map_meta": lambda: (call_interface("slam.get_graph_meta")
                                     if has_interface("slam.get_graph_meta")
                                     else {}),
            "map_keyframe_align": lambda source, target, guess:
                call_interface("slam.keyframe_align", source, target, guess),
            "map_add_edge": lambda prev, next, relative:
                call_interface("slam.add_edge", prev, next, relative),
            "map-del-points": lambda index:
                call_interface("slam.del_points", index),
            # calibration RPCs without config round-trip
            "get_projection_forward": lambda *a: call_interface(
                "calibration.get_projection_forward", *a),
            "get_projection_backward": lambda *a: call_interface(
                "calibration.get_projection_backward", *a),
            "get_transform": lambda extrinsic_parameters: call_interface(
                "calibration.get_transform", extrinsic_parameters),
            "get_vector_from_transform": lambda transform: call_interface(
                "calibration.get_vector_from_transform", transform),
            "find_corners": lambda imageData, cameraName, config:
                call_interface("calibration.find_corners", imageData,
                               cameraName, config),
            "restart_lidar_ins_calibration": lambda: call_interface(
                "calibration.restart_lidar_ins_calibration", p.get_config()),
            "calibrate_lidar_ins": lambda: call_interface(
                "calibration.calibrate_lidar_ins"),
            "get_lidar_ins_calibration": lambda: call_interface(
                "calibration.get_lidar_ins_calibration"),
            "get_lidar_ins_transform": lambda: call_interface(
                "calibration.get_lidar_ins_transform"),
            "restart_lidar_imu_calibration": lambda: call_interface(
                "calibration.restart_lidar_imu_calibration", p.get_config()),
            "calibrate_lidar_imu": lambda: call_interface(
                "calibration.calibrate_lidar_imu"),
            "lidar_imu_get_lidar_poses": lambda: call_interface(
                "calibration.lidar_imu_get_lidar_poses"),
            "lidar_imu_get_imu_poses": lambda: call_interface(
                "calibration.lidar_imu_get_imu_poses"),
            "get_homography": lambda *a, **k: call_interface(
                "calibration.get_homography", *a, **k),
            # calibration RPCs that rewrite the config
            "finetune_lidar": lambda lidarIndex, transform: self._cfg_call(
                "calibration.finetune_lidar", lidarIndex, transform),
            "calibrate_ground": lambda points, contour, key: self._cfg_call(
                "calibration.calibrate_ground", points, contour, key),
            "calibrate_heading": lambda source, target, key: self._cfg_call(
                "calibration.calibrate_heading", source, target, key),
            "finetune_camera": lambda cameraName, transform: self._cfg_call(
                "calibration.finetune_camera", cameraName, transform),
            "calibrate_lidar_camera": lambda pointsLidar, pointsCamera,
                cameraName: self._cfg_call("calibration.calibrate_lidar_camera",
                                           pointsLidar, pointsCamera,
                                           cameraName),
            "calibrate_camera": lambda pointsCamera, cameraName, config:
                self._cfg_call("calibration.calibrate_camera", pointsCamera,
                               cameraName, config),
            "set_lidar_ins_transform": lambda transform: self._cfg_call(
                "calibration.set_lidar_ins_transform", transform),
            "set_lidar_imu_extrinsics": lambda: self._do(
                p.set_config,
                call_interface("calibration.set_lidar_imu_extrinsics",
                               p.get_config())),
        }
        if method in simple:
            return simple[method](*args, **kwargs)
        if has_interface(method):
            return call_interface(method, *args, **kwargs)
        raise KeyError(method)

    # server ------------------------------------------------------------
    def start(self, host: str = "0.0.0.0", port: int = 1234) -> int:
        routes = self.routes
        logger = self.logger
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _dispatch(self, method: str) -> None:
                path = self.path.split("?")[0]
                # user tracking + blacklist middleware
                # (ref web_backend/server.py:54-70 before_request)
                ip = self.client_address[0]
                user = server.client_users.setdefault(
                    ip, {"disable": False, "requests": 0})
                user["requests"] += 1
                if ip in server.blacklist:
                    self.send_response(403)
                    self.end_headers()
                    return
                if method == "GET" and path == "/v1/camera":
                    self._stream_mjpeg()
                    return
                fn = routes.get((method, path))
                if fn is None:
                    if method == "GET" and self._serve_static(path):
                        return
                    self.send_response(404)
                    self.end_headers()
                    return
                body: Dict = {}
                if method == "GET" and "?" in self.path:
                    from urllib.parse import parse_qs
                    body = {k: v[0] for k, v in
                            parse_qs(self.path.split("?", 1)[1]).items()}
                if method == "POST":
                    ln = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(ln) if ln else b""
                    if raw:
                        try:
                            body = json.loads(raw)
                        except ValueError:
                            # malformed JSON must NOT silently become {} —
                            # e.g. POST /v1/config with {} would reset the
                            # whole configuration
                            self.send_response(400)
                            self.send_header("Content-Type", "application/json")
                            self.end_headers()
                            self.wfile.write(b'{"error": "malformed JSON body"}')
                            return
                try:
                    out = fn(body)
                except Exception as e:  # surface errors as 500 JSON
                    logger.exception("route %s failed", path)
                    self.send_response(500)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(json.dumps({"error": str(e)}).encode())
                    return
                if isinstance(out, bytes):
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.end_headers()
                    self.wfile.write(out)
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(json.dumps(out).encode())

            def _stream_mjpeg(self) -> None:
                """multipart/x-mixed-replace MJPEG of one camera's frames
                (ref player_data_manager camera_server_main re-serving
                recorded camera streams on :38000).  ?name= picks the
                camera; default is the first one present."""
                import time as _time
                from urllib.parse import parse_qs, urlparse
                q = parse_qs(urlparse(self.path).query)
                want = q.get("name", [None])[0]
                self.send_response(200)
                self.send_header("Content-Type",
                                 "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                last = None
                try:
                    while True:
                        frame = (call_interface("databank.get_latest")
                                 if has_interface("databank.get_latest")
                                 else None)
                        images = (frame or {}).get("image") or {}
                        name = want if want in images else \
                            (next(iter(images)) if images else None)
                        jpeg = images.get(name) if name else None
                        if isinstance(jpeg, (bytes, bytearray)) \
                                and bytes(jpeg) != last:
                            last = bytes(jpeg)
                            self.wfile.write(b"--frame\r\n"
                                             b"Content-Type: image/jpeg\r\n"
                                             b"Content-Length: "
                                             + str(len(last)).encode()
                                             + b"\r\n\r\n" + last + b"\r\n")
                        _time.sleep(0.05)
                except (BrokenPipeError, ConnectionResetError):
                    return

            def _serve_static(self, path: str) -> bool:
                """Serve the built-in UI from web/www (ref: Flask serving
                the prebuilt www/ bundle, web_backend/server.py:34-40)."""
                import mimetypes
                import os
                www = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "www")
                rel = path.lstrip("/") or "index.html"
                # pretty URLs like the reference's /editor, /calibration
                # (web_ui react-router routes) map to <name>.html
                if "." not in rel and \
                        os.path.isfile(os.path.join(www, rel + ".html")):
                    rel += ".html"
                full = os.path.realpath(os.path.join(www, rel))
                if not full.startswith(os.path.realpath(www) + os.sep) and \
                        full != os.path.realpath(os.path.join(www, "index.html")):
                    return False
                if not os.path.isfile(full):
                    return False
                ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
                with open(full, "rb") as f:
                    data = f.read()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return True

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        actual_port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="WebServer", daemon=True)
        self._thread.start()
        self.logger.info("web API listening on %s:%d", host, actual_port)
        return actual_port

    def stop(self) -> None:
        if self.httpd:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None
