"""Port parity for the web layer: both packages' ``PerceptionServer`` over an
offline Source -> Sink pipeline on one recording (the reference's
``FrameRecorder``, ``tests/test_io.py`` frames), each bound to port 0; the
built-in UI's files; ``UpgradeServer``; and ``python -m lsd_tpu_torch run``.

- ``/v1/status``: the same keys at every level (the values are clocks,
  rates and counts of two live pipelines); ``/v1/config`` get and set, the
  JSON-RPC methods (the calibration RPCs too, the config ones leaving equal
  configs), ``/v1/detection-pb`` (parsed), ``/v1/message-meta`` and
  ``/v1/get-message-data`` over the same bus messages, the web store, 404s:
  equal answers.
- ``lsd_tpu_torch/web/www`` holds byte-equal copies of ``lsd_tpu/web/www``,
  and both servers serve the same bytes for the same paths.
- ``UpgradeServer``: the version, a raw and a multipart upload staged to
  ``success`` with the same payload and meta, the log list, the power
  action refused.
- The CLI on the CPU (``--device cpu``): prints its port, answers
  ``/v1/status`` and exits 0 on SIGINT; without a card and without
  ``--device`` it fails before serving.
"""
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import lsd_tpu.runtime as jrt
import lsd_tpu_torch.runtime as trt
from lsd_tpu.comms import bus as jbus
from lsd_tpu.comms import messages as jmsg
from lsd_tpu.io.recorder import FrameRecorder
from lsd_tpu.runtime.perception import Perception as JPerception
from lsd_tpu.web import PerceptionServer as JServer
from lsd_tpu.web import upgrade as jup
from lsd_tpu_torch.comms import bus as tbus
from lsd_tpu_torch.comms import messages as tmsg
from lsd_tpu_torch.proto.detection import parse_detection
from lsd_tpu_torch.runtime.perception import Perception as TPerception
from lsd_tpu_torch.web import PerceptionServer as TServer
from lsd_tpu_torch.web import upgrade as tup
from tests.test_io import make_frame_dict
from tests.test_torch_slam_module import private_buses  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WWW = ("calibration.html", "editor.html", "i18n.js", "index.html", "upgrade.html")


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def _post(url, body=None):
    req = urllib.request.Request(url, data=json.dumps(body or {}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, r.read()


@pytest.fixture
def servers(tmp_path, monkeypatch):
    """Both packages' facade and server on the same recording, records under
    ``tmp_path``; yields {pkg: (base url, perception)}."""
    monkeypatch.setenv("LSD_TPU_WEB_STORE", str(tmp_path / "web_store.json"))
    rec = FrameRecorder(str(tmp_path / "rec"))
    for k in range(5):
        rec.write(make_frame_dict(ts=1_000_000 + k * 100_000))
    out, started = {}, []
    try:
        for pkg, rt, make, server in (("jax", jrt, JPerception, JServer),
                                      ("torch", trt, lambda: TPerception(device="cpu"), TServer)):
            rt.clear_interfaces()
            p = make()
            cfg = p.get_config()
            cfg["input"]["data_path"] = rec.log_dir
            cfg["pipeline"] = [["Source", "Sink"]]
            cfg["system"]["record"]["path"] = str(tmp_path / f"records_{pkg}")
            cfg["lidar"] = [dict(name="0-Ouster-OS1", extrinsic_parameters=[0, 0, 1.8, 0, 0, 0])]
            p.config_manager.set_config(cfg)
            p.setup()
            p.start()
            srv = server(p)
            started.append((srv, p, rt))
            out[pkg] = (f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}", p)
        yield out
    finally:
        for srv, p, rt in started:
            srv.stop()
            p.release()
            rt.clear_interfaces()


def _keys(tree):
    """The nested key structure of a JSON value."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__


def _both(servers, fn):
    return {pkg: fn(base, p) for pkg, (base, p) in servers.items()}


def test_status_and_config_match(servers):
    st = _both(servers, lambda b, p: json.loads(_post(b + "/v1/status")[1]))
    assert _keys(st["torch"]) == _keys(st["jax"])
    assert st["torch"]["status"] == st["jax"]["status"] == "Running"
    assert set(st["torch"]["modules"]) == {"Source", "Sink"}
    got = _both(servers, lambda b, p: json.loads(_get(b + "/v1/config")[1]))
    for pkg in got:
        got[pkg]["system"]["record"].pop("path")
    assert got["torch"] == got["jax"]

    def set_udp(b, p):
        cfg = json.loads(_get(b + "/v1/config")[1])
        cfg["output"]["protocol"]["UDP"]["use"] = True
        bad = json.loads(json.dumps(cfg))
        bad["output"]["protocol"]["UDP"]["dest"] = "not-an-ip"
        return (json.loads(_post(b + "/v1/config", cfg)[1]),
                json.loads(_post(b + "/v1/config", bad)[1]),
                json.loads(_get(b + "/v1/roi")[1]), _post(b + "/v1/roi", {"include": [[0, 0]]})[1],
                json.loads(_get(b + "/v1/roi")[1]))
    answers = _both(servers, set_udp)
    assert answers["torch"] == answers["jax"] and answers["jax"][0] == {"result": "Success"}


def test_jsonrpc_methods_match(servers):
    calls = [("get_transform", [[1, 2, 3, 0, 0, 90]]),
             ("get_vector_from_transform", [[[0, -1, 0, 1], [1, 0, 0, 2], [0, 0, 1, 3],
                                             [0, 0, 0, 1]]]),
             ("get_projection_forward", [37.0, -122.0, 37.001, -122.002]),
             ("get_projection_backward", [37.0, -122.0, 100.0, -50.0]),
             ("finetune_lidar", [0, [[1, 0, 0, 0.5], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]]),
             ("calibrate_heading", [[[0, 0], [1, 0], [2, 0.5]], [[0, 0], [0, 1], [-0.5, 2]],
                                    0]),
             ("set_web_store", [{"lang": "en", "theme": 2}]),
             ("restart_lidar_ins_calibration", []), ("calibration.lidar_ins_get_positions", []),
             ("no_such_method", []), ("get_map_meta", []), ("get_map_edge", [])]

    def run(b, p):
        out = [json.loads(_post(b + "/api", {"method": m, "params": a, "id": k})[1])
               for k, (m, a) in enumerate(calls)]
        dump = json.loads(_post(b + "/api", {"method": "dump", "id": 99})[1])
        return out, p.get_config()["lidar"], json.loads(_get(b + "/v1/get-web-store")[1]), \
            sorted(dump["result"])
    got = _both(servers, run)
    assert got["torch"][:3] == got["jax"][:3]
    assert got["jax"][0][-3]["error"].startswith("unknown method")
    assert got["jax"][2] == {"lang": "en", "theme": 2}
    assert "stacks" in got["torch"][3] and "stacks" in got["jax"][3]


def test_detection_pb_and_messages_match(servers):
    def poll(b, p):
        deadline, data = time.time() + 5, b""
        while time.time() < deadline and not data:
            data = _post(b + "/v1/detection-pb")[1]
            time.sleep(0.05)
        return parse_detection(data)
    got = _both(servers, poll)
    for pkg in got:
        got[pkg]["header"].pop("fps", None)
    assert _keys(got["torch"]) == _keys(got["jax"]) and got["torch"].get("object", []) == []
    T = np.eye(4)
    T[:3, 3] = [1.0, 2.0, 3.0]

    def messages(b, p):
        _get(b + "/v1/start-message-subscribe")
        time.sleep(0.1)
        bus, msg = (tbus, tmsg) if isinstance(p, TPerception) else (jbus, jmsg)
        for k in range(3):
            bus.MessageBus.core().publish("slam.odometry", msg.odometry_msg(k, T, vel=[k, 0, 0]))
        deadline = time.time() + 3
        while time.time() < deadline and not json.loads(_get(b + "/v1/message-meta")[1]):
            time.sleep(0.02)
        time.sleep(0.1)
        return (json.loads(_get(b + "/v1/message-meta")[1]),
                json.loads(_post(b + "/v1/get-message-data", {"channel": "slam.odometry"})[1]),
                json.loads(_post(b + "/v1/message-data", {"channel": "slam.odometry",
                                                          "field": "twist.linear.x"})[1]))
    got = _both(servers, messages)
    assert got["torch"] == got["jax"]
    assert got["jax"][0] == {"slam.odometry": "Odometry"}
    assert got["jax"][2]["series"] == [0.0, 1.0, 2.0]


def test_builtin_ui_is_the_reference_copy(servers):
    for name in WWW:
        with open(os.path.join(REPO, "lsd_tpu", "web", "www", name), "rb") as f:
            ref = f.read()
        with open(os.path.join(REPO, "lsd_tpu_torch", "web", "www", name), "rb") as f:
            assert f.read() == ref, name
    assert sorted(os.listdir(os.path.join(REPO, "lsd_tpu_torch", "web", "www"))) == list(WWW)
    for path in ("/", "/index.html", "/editor", "/calibration", "/i18n.js", "/upgrade.html"):
        got = _both(servers, lambda b, p: _get(b + path)[1])
        assert got["torch"] == got["jax"] and len(got["jax"]) > 1000, path
    for path in ("/../server.py", "/v1/nope", "/nothing.html"):
        for base, _ in servers.values():
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(base + path)
            assert e.value.code == 404


def test_upgrade_server_matches(tmp_path):
    blob = tup.pack_firmware("9.9.9", "notes", b"\x00\x01payload" * 100)
    assert blob == jup.pack_firmware("9.9.9", "notes", b"\x00\x01payload" * 100)
    assert tup.parse_firmware(blob) == jup.parse_firmware(blob)
    assert tup.parse_firmware(b"XYZ") == jup.parse_firmware(b"XYZ") == {"valid": False}
    got = {}
    for pkg, mod in (("jax", jup), ("torch", tup)):
        stage = tmp_path / f"stage_{pkg}"
        logs = tmp_path / f"logs_{pkg}"
        logs.mkdir()
        (logs / "a.log").write_text("line\n")
        srv = mod.UpgradeServer(mod.UpgradeManager(str(stage), log_dirs=(str(logs),),
                                                   step_delay=0.0))
        base = f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}"
        try:
            version = json.loads(_get(base + "/v1/version")[1])
            req = urllib.request.Request(base + "/v1/firmware", data=blob)
            with urllib.request.urlopen(req, timeout=10) as r:
                raw = json.loads(r.read())
            deadline = time.time() + 5
            while time.time() < deadline and \
                    json.loads(_get(base + "/v1/status")[1])["stage"] != "success":
                time.sleep(0.02)
            boundary = "XyZ"
            body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
                    f"filename=\"fw.bin\"\r\n\r\n").encode() + blob + \
                f"\r\n--{boundary}--\r\n".encode()
            req = urllib.request.Request(base + "/v1/firmware", data=body, headers={
                "Content-Type": f"multipart/form-data; boundary={boundary}"})
            with urllib.request.urlopen(req, timeout=10) as r:
                multi = json.loads(r.read())
            while time.time() < deadline and \
                    json.loads(_get(base + "/v1/status")[1])["stage"] != "success":
                time.sleep(0.02)
            status = json.loads(_get(base + "/v1/status")[1])
            files = json.loads(_get(base + "/v1/log-file-list")[1])
            content = json.loads(_get(base + f"/v1/log-content?filename={logs / 'a.log'}")[1])
            power = json.loads(_post(base + "/v1/system-power-action", {"action": "reboot"})[1])
        finally:
            srv.stop()
        staged = sorted(os.listdir(stage))
        with open(stage / "firmware-9.9.9.bin", "rb") as f:
            payload = f.read()
        with open(stage / "firmware-9.9.9.bin.meta") as f:
            meta = json.load(f)
        got[pkg] = (version, raw, multi, status["stage"], status["percentage"],
                    [os.path.basename(x) for x in files["files"]], content, power, staged,
                    payload, meta)
    assert got["torch"] == got["jax"]
    assert got["jax"][0] == {"version": {"ver": "0.1.0"}} and got["jax"][3] == "success"
    assert got["jax"][9] == b"\x00\x01payload" * 100


def _write_config(path, cfg):
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def test_run_cli_serves_and_stops(tmp_path):
    rec = FrameRecorder(str(tmp_path / "rec"))
    for k in range(3):
        rec.write(make_frame_dict(ts=1_000_000 + k * 100_000))
    cfg = dict(input=dict(mode="offline", data_path=rec.log_dir), pipeline=[["Source", "Sink"]],
               system=dict(record=dict(use=False, path=str(tmp_path / "records"))))
    path = _write_config(tmp_path / "cfg.yaml", cfg)
    env = dict(os.environ, LSD_TPU_WEB_STORE=str(tmp_path / "store.json"))
    cmd = [sys.executable, "-m", "lsd_tpu_torch", "run", "--config", path, "--host", "127.0.0.1",
           "--port", "0"]
    proc = subprocess.Popen(cmd + ["--device", "cpu"], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        line = proc.stdout.readline()
        assert line.startswith("lsd_tpu_torch serving on 127.0.0.1:"), proc.stderr.read()
        base = "http://127.0.0.1:" + line.strip().rsplit(":", 1)[1]
        status = json.loads(_post(base + "/v1/status")[1])
        assert status["status"] == "Running" and set(status["modules"]) == {"Source", "Sink"}
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    no_card = subprocess.run(cmd, cwd=REPO, env=dict(env, CUDA_VISIBLE_DEVICES=""),
                             capture_output=True, text=True, timeout=120)
    assert no_card.returncode != 0 and "CUDA" in no_card.stderr
    assert "serving on" not in no_card.stdout


def test_upgrade_service_skipped_past_the_last_port(tmp_path, monkeypatch):
    """A web port above 65035 leaves no port + 500 for the upgrade service:
    ``start_system`` serves without it, as where that port is taken (the
    reference raises ``OverflowError`` there)."""
    import socket

    from lsd_tpu_torch.__main__ import start_system, stop_system
    rec = FrameRecorder(str(tmp_path / "rec"))
    rec.write(make_frame_dict(ts=1_000_000))
    cfg = dict(input=dict(mode="offline", data_path=rec.log_dir), pipeline=[["Source", "Sink"]],
               system=dict(record=dict(use=False, path=str(tmp_path / "records"))))
    monkeypatch.setenv("LSD_TPU_WEB_STORE", str(tmp_path / "store.json"))
    for port in range(65535, 65035, -1):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        break
    trt.clear_interfaces()
    p, srv, upgrade, got = start_system(_write_config(tmp_path / "cfg.yaml", cfg), None,
                                        "127.0.0.1", port, device="cpu")
    try:
        assert got == port and upgrade is None
        status = json.loads(_post(f"http://127.0.0.1:{port}/v1/status")[1])
        assert status["status"] == "Running"
    finally:
        stop_system(p, srv, upgrade)
        trt.clear_interfaces()
