"""Firmware-upgrade service — the daemon behind the reference's Upgrade UI
(a copy of ``lsd_tpu/web/upgrade.py`` for the port).

The reference web UI (web_ui/src/rpc/http-upgrade.ts, components/upgrade/)
talks to a board-management daemon on web-port+500 that the reference repo
does not ship (it lives in the device firmware).  This implements that
contract so the upgrade workflow runs end-to-end:

    GET  /v1/version             -> {"version": {"ver": ...}}
    GET  /v1/status              -> {"stage", "percentage", "log"}
    POST /v1/firmware            -> multipart or raw LSD package upload
    GET  /v1/log-file-list       -> {"files": [...]}
    GET  /v1/log-content?filename=...
    POST /v1/system-power-action -> {"action": "reboot"|"poweroff"}

Package layout (mirrors the UI's parse() in components/upgrade/index.tsx:
magic, then two length-prefixed text parts):

    b"LSD" magic | int32-be len | version text
                 | int32-be len | release-note text | payload bytes

Stages walk uploading -> preparing -> upgrading -> verifying ->
postprocessing -> success (or failed), with percentage + log, exactly the
states Status.tsx renders.  "Installing" here means staging the payload
under ``staging_dir`` and recording its sha256 — the host-integration
point where a real deployment would flash/swap partitions.  Where the
reference names ``/tmp`` (the default staging directory, a log directory),
this copy names ``tempfile.gettempdir()``, the same directory unless
``TMPDIR`` names another.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from .. import __version__
from ..utils.log import get_logger

STAGES = ("idle", "uploading", "preparing", "upgrading", "verifying",
          "postprocessing", "restarting", "failed", "success")


def pack_firmware(version: str, release_note: str, payload: bytes) -> bytes:
    """Build an LSD upgrade package (the inverse of parse_firmware)."""
    v = version.encode()
    n = release_note.encode()
    return (b"LSD" + struct.pack(">i", len(v)) + v
            + struct.pack(">i", len(n)) + n + payload)


def parse_firmware(blob: bytes) -> Dict:
    """Validate + split an LSD package -> {valid, version, release_note,
    payload} (ref components/upgrade/index.tsx parse())."""
    if not blob.startswith(b"LSD"):
        return {"valid": False}
    try:
        off = 3
        (vlen,) = struct.unpack_from(">i", blob, off)
        off += 4
        version = blob[off:off + vlen].decode()
        off += vlen
        (nlen,) = struct.unpack_from(">i", blob, off)
        off += 4
        note = blob[off:off + nlen].decode()
        off += nlen
    except (struct.error, UnicodeDecodeError):
        return {"valid": False}
    return {"valid": True, "version": version, "release_note": note,
            "payload": blob[off:]}


def default_log_dirs() -> Tuple[str, ...]:
    """Log directories scanned by the dev-page Log view: the configured
    LSD_TPU_LOG_DIR (where utils/log.py writes lsd_tpu.log) plus the
    reference's system locations (web_ui rpc/http-upgrade.ts serves
    /v1/log-file-list off the target's log dirs)."""
    dirs = []
    env = os.environ.get("LSD_TPU_LOG_DIR")
    if env:
        dirs.append(env)
    dirs += ["/var/log", tempfile.gettempdir()]
    return tuple(dict.fromkeys(dirs))


def list_log_files(log_dirs) -> Dict:
    files = []
    for d in log_dirs:
        try:
            for name in sorted(os.listdir(d)):
                p = os.path.join(d, name)
                if os.path.isfile(p) and name.endswith(".log"):
                    files.append(p)
        except OSError:
            continue
    return {"files": files}


def _log_path_allowed(log_dirs, filename: str) -> bool:
    return any(os.path.realpath(filename).startswith(
        os.path.realpath(d) + os.sep) for d in log_dirs)


def read_log_content(log_dirs, filename: str,
                     max_bytes: int = 256 * 1024) -> Dict:
    if not _log_path_allowed(log_dirs, filename) \
            or not os.path.isfile(filename):
        return {"error": "not found"}
    with open(filename, "rb") as f:
        f.seek(max(0, os.path.getsize(filename) - max_bytes))
        return {"content": f.read().decode("utf-8", "replace")}


def read_log_bytes(log_dirs, filename: str) -> bytes:
    """Whole-file bytes for /v1/log-download (ref dev/Log.jsx downloadLog)."""
    if not _log_path_allowed(log_dirs, filename) \
            or not os.path.isfile(filename):
        return b""
    with open(filename, "rb") as f:
        return f.read()


class UpgradeManager:
    """Upgrade state machine; thread-safe, one upgrade at a time."""

    def __init__(self, staging_dir: str = os.path.join(tempfile.gettempdir(),
                                                       "lsd_tpu_upgrade"),
                 log_dirs: Optional[Tuple[str, ...]] = None,
                 allow_power_actions: bool = False,
                 step_delay: float = 0.05):
        self.staging_dir = staging_dir
        self.log_dirs = log_dirs if log_dirs is not None \
            else default_log_dirs()
        self.allow_power_actions = allow_power_actions
        self.step_delay = step_delay
        self.logger = get_logger("upgrade")
        self._lock = threading.Lock()
        self._stage = "idle"
        self._pct = 0
        self._log = ""
        self._worker: Optional[threading.Thread] = None

    # -- status ------------------------------------------------------------
    def status(self) -> Dict:
        with self._lock:
            return {"stage": self._stage, "percentage": self._pct,
                    "log": self._log}

    def _set(self, stage: str, pct: int, line: str = "") -> None:
        with self._lock:
            self._stage = stage
            self._pct = pct
            if line:
                self._log += line + "\n"
        if line:
            self.logger.info("%s (%d%%) %s", stage, pct, line)

    # -- firmware ----------------------------------------------------------
    def submit(self, blob: bytes) -> Dict:
        with self._lock:
            if self._worker is not None and self._worker.is_alive():
                return {"status": "error", "message": "upgrade in progress"}
            self._stage, self._pct, self._log = "uploading", 0, ""
        meta = parse_firmware(blob)
        if not meta["valid"]:
            self._set("failed", 0, "invalid firmware package (bad magic)")
            return {"status": "error", "message": "invalid package"}
        self._worker = threading.Thread(
            target=self._run, args=(meta,), daemon=True, name="Upgrade")
        self._worker.start()
        return {"status": "ok", "version": meta["version"]}

    def _run(self, meta: Dict) -> None:
        try:
            payload = meta["payload"]
            self._set("preparing", 10,
                      f"package v{meta['version']} ({len(payload)} bytes)")
            os.makedirs(self.staging_dir, exist_ok=True)
            time.sleep(self.step_delay)
            self._set("upgrading", 40, "staging payload")
            dst = os.path.join(self.staging_dir,
                               f"firmware-{meta['version']}.bin")
            with open(dst, "wb") as f:
                f.write(payload)
            time.sleep(self.step_delay)
            self._set("verifying", 70, "verifying sha256")
            digest = hashlib.sha256(payload).hexdigest()
            with open(dst, "rb") as f:
                if hashlib.sha256(f.read()).hexdigest() != digest:
                    raise IOError("staged payload digest mismatch")
            with open(dst + ".meta", "w") as f:
                json.dump({"version": meta["version"], "sha256": digest,
                           "release_note": meta["release_note"]}, f)
            time.sleep(self.step_delay)
            self._set("postprocessing", 90, "recorded " + dst)
            time.sleep(self.step_delay)
            self._set("success", 100, "upgrade staged; restart to apply")
        except Exception as e:  # any failure -> failed stage with reason
            self._set("failed", self._pct, f"error: {e}")

    # -- logs / power ------------------------------------------------------
    def log_files(self) -> Dict:
        return list_log_files(self.log_dirs)

    def log_content(self, filename: str, max_bytes: int = 256 * 1024) -> Dict:
        return read_log_content(self.log_dirs, filename, max_bytes)

    def log_bytes(self, filename: str) -> bytes:
        return read_log_bytes(self.log_dirs, filename)

    def power_action(self, action: str) -> Dict:
        if action not in ("reboot", "poweroff"):
            return {"status": "error", "message": f"unknown action {action}"}
        if not self.allow_power_actions:
            self.logger.warning("power action %s requested (disabled in "
                                "this deployment)", action)
            return {"status": "disabled", "action": action}
        os.system({"reboot": "reboot", "poweroff": "poweroff"}[action])
        return {"status": "ok", "action": action}


class UpgradeServer:
    """Standalone HTTP daemon on web-port+500 (ref http-upgrade.ts PORT)."""

    def __init__(self, manager: Optional[UpgradeManager] = None):
        self.manager = manager or UpgradeManager()
        self.httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self, host: str = "0.0.0.0", port: int = 1735) -> int:
        mgr = self.manager

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Access-Control-Allow-Origin", "*")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/v1/version":
                    return self._json({"version": {"ver": __version__}})
                if path == "/v1/status":
                    return self._json(mgr.status())
                if path == "/v1/log-file-list":
                    return self._json(mgr.log_files())
                if path == "/v1/log-content":
                    from urllib.parse import parse_qs
                    fn = parse_qs(query).get("filename", [""])[0]
                    return self._json(mgr.log_content(fn))
                if path == "/v1/log-download":
                    from urllib.parse import parse_qs
                    fn = parse_qs(query).get("filename", [""])[0]
                    data = mgr.log_bytes(fn)
                    self.send_response(200 if data else 404)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("Content-Disposition",
                                     "attachment; filename=" +
                                     os.path.basename(fn or "lsd.log"))
                    self.send_header("Access-Control-Allow-Origin", "*")
                    self.end_headers()
                    self.wfile.write(data)
                    return
                self._json({"error": "not found"}, 404)

            def do_POST(self):
                ln = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(ln) if ln else b""
                if self.path == "/v1/firmware":
                    blob = _extract_upload(raw, self.headers)
                    return self._json(mgr.submit(blob))
                if self.path == "/v1/system-power-action":
                    try:
                        body = json.loads(raw or b"{}")
                    except ValueError:
                        body = {}
                    return self._json(mgr.power_action(
                        str(body.get("action", ""))))
                self._json({"error": "not found"}, 404)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        actual = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="UpgradeServer", daemon=True)
        self._thread.start()
        get_logger("upgrade").info("upgrade service on %s:%d", host, actual)
        return actual

    def stop(self) -> None:
        if self.httpd:
            self.httpd.shutdown()
            self.httpd = None


def _extract_upload(raw: bytes, headers) -> bytes:
    """Accept either a raw package body or multipart/form-data with a
    ``file`` part (the UI posts FormData)."""
    ctype = headers.get("Content-Type", "")
    if "multipart/form-data" not in ctype:
        return raw
    try:
        boundary = ctype.split("boundary=")[1].strip().encode()
    except IndexError:
        return raw
    for part in raw.split(b"--" + boundary):
        head, _, body = part.partition(b"\r\n\r\n")
        if b"filename=" in head:
            return body.rsplit(b"\r\n", 1)[0]
    return raw
