"""Port parity for the runtime around the engines: ``PlayerSource``, the
Source -> Sink and Split pipelines, the ``Perception`` facade and its
``set_config`` classification, ``EvalDumpSink``, ``InsStatusMachine``,
``network_validation``, the message bus and the ``replay`` CLI.

Each scenario of ``tests/test_runtime.py`` runs in both packages on the
same recording (written from a seed) and must give equal results: equal
transport states, equal frame dicts out of the sinks, equal classifications
and verdicts, equal dump lines (byte for byte) and equal accepted
priorities.  The port's modules are built with ``device="cpu"`` where they
take one.  The CLI runs as a subprocess on a recording the reference's
``FrameRecorder`` wrote and must integrate every frame.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import lsd_tpu.runtime as jrt
import lsd_tpu_torch.runtime as trt
from lsd_tpu.io.recorder import FrameRecorder as JRecorder
from lsd_tpu.runtime import modules as jmod
from lsd_tpu.runtime import pipeline as jpipe
from lsd_tpu.runtime.perception import Perception as JPerception
from lsd_tpu.sensors.ins_status import InsStatusMachine as JIns
from lsd_tpu.utils.network import network_validation as jnet
from lsd_tpu_torch.runtime import modules as tmod
from lsd_tpu_torch.runtime import pipeline as tpipe
from lsd_tpu_torch.runtime.perception import Perception as TPerception
from lsd_tpu_torch.sensors.ins_status import InsStatusMachine as TIns
from lsd_tpu_torch.utils.network import network_validation as tnet
from tests.test_io import make_frame_dict
from tests.test_torch_player import _equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jrt, jmod, jpipe), "torch": (trt, tmod, tpipe)}


@pytest.fixture(autouse=True)
def _clean_interfaces():
    jrt.clear_interfaces()
    trt.clear_interfaces()
    yield
    jrt.clear_interfaces()
    trt.clear_interfaces()


@pytest.fixture
def recording(tmp_path):
    rec = JRecorder(str(tmp_path / "rec"))
    for k in range(10):
        rec.write(make_frame_dict(ts=1_000_000 + k * 1_000_000, n=64))
    return rec.log_dir


def _cfg(pkg, rec_dir, tmp_path, pipeline):
    cfg = PKGS[pkg][0].ConfigManager().config
    cfg.input.data_path = rec_dir
    cfg.pipeline = pipeline
    cfg.system.record.path = str(tmp_path / f"records_{pkg}")
    return cfg


def test_player_transport(recording, tmp_path):
    states = {}
    for pkg, (rt, mod, _) in PKGS.items():
        cfg = _cfg(pkg, recording, tmp_path, [["Source", "Sink"]])
        src = mod.PlayerSource(cfg)
        src.setup(cfg)
        got = [rt.call_interface("player.get_status")]
        frames = [src.get_data()["frame_start_timestamp"] for _ in range(3)]
        rt.call_interface("player.seek", 50.0)
        got.append(rt.call_interface("player.get_status"))
        rt.call_interface("player.set_rate", 0.01)
        got.append(rt.call_interface("player.get_status"))
        rt.call_interface("player.step")
        got.append(rt.call_interface("player.get_status"))
        frames.append(src.get_data()["frame_start_timestamp"])   # paused: no advance
        rt.call_interface("player.resume")
        frames += [src.get_data()["frame_start_timestamp"] for _ in range(6)]
        got.append(rt.call_interface("player.get_status"))
        rt.call_interface("player.pause")
        got.append(rt.call_interface("player.get_status"))
        states[pkg] = (got, frames)
    assert states["torch"] == states["jax"]
    got, frames = states["torch"]
    assert got[0]["left_time"] == "00:09" and got[1]["percent"] == 50.0
    assert got[2]["rate"] == 0.1 and got[3]["playing"] is False
    # the end of the recording re-emits the last frame
    assert frames[-2:] == [10_000_000, 10_000_000]


def _run_pipeline(pkg, cfg, registry, banks, n_frames, timeout=10.0):
    mm = PKGS[pkg][2].ModuleManager(registry)
    mm.build(cfg.pipeline, cfg)
    mm.start()
    deadline = time.time() + timeout
    while time.time() < deadline and not all(
            b.get_latest() is not None
            and b.get_latest()["frame_start_timestamp"] >= 1_000_000 * n_frames
            for b in banks()):
        time.sleep(0.05)
    latest = [b.get_latest() for b in banks()]
    status = mm.get_status()
    mm.stop()
    return latest, status


def test_source_sink_replay(recording, tmp_path):
    out = {}
    for pkg, (_, mod, _) in PKGS.items():
        cfg = _cfg(pkg, recording, tmp_path, [["Source", "Sink"]])
        sinks = {}

        def make_sink(cfg, mod=mod, sinks=sinks):
            sinks["s"] = mod.SinkModule(cfg)
            return sinks["s"]
        latest, status = _run_pipeline(pkg, cfg, {"Source": mod.PlayerSource, "Sink": make_sink},
                                       lambda: [sinks["s"].data_bank], 10)
        assert status["status"] == "Running" and status["modules"]["Source"]["frames"] >= 10
        out[pkg] = latest[0]
    assert _equal(out["torch"], out["jax"])


def test_split_pipeline(recording, tmp_path):
    out = {}
    for pkg, (_, mod, pipe) in PKGS.items():
        cfg = _cfg(pkg, recording, tmp_path,
                   [["Source", "Split"], ["Split", "SinkA"], ["Split", "SinkB"]])
        banks = {}

        def make_bank(name, pipe=pipe, banks=banks):
            def f(cfg):
                banks[name] = pipe.DataBank(name)
                return banks[name]
            return f
        latest, _ = _run_pipeline(
            pkg, cfg, {"Source": mod.PlayerSource, "Split": lambda cfg, pipe=pipe: pipe.Split("Split"),
                       "SinkA": make_bank("SinkA"), "SinkB": make_bank("SinkB")},
            lambda: list(banks.values()), 10)
        out[pkg] = latest
    assert all(_equal(a, b) for a, b in zip(out["torch"], out["jax"]))
    assert all(d is not None for d in out["torch"])


def test_perception_facade_and_set_config(recording, tmp_path):
    verdicts = {}
    for pkg, make in (("jax", lambda: JPerception()),
                      ("torch", lambda: TPerception(device="cpu"))):
        p = make()
        cfgd = p.get_config()
        cfgd["input"]["data_path"] = recording
        cfgd["pipeline"] = [["Source", "Sink"]]
        cfgd["system"]["record"]["path"] = str(tmp_path / f"records_{pkg}")
        p.config_manager.set_config(cfgd)
        p.setup()
        p.start()
        time.sleep(0.3)
        status = p.get_status()
        assert status["status"] == "Running" and "Source" in status["modules"]
        assert "thread" in p.dump()
        v = []
        new = p.get_config()
        v.append(p.set_config(new))                           # Success
        new["output"]["protocol"]["UDP"].update(use=True, dest="1.2.3", port=19000)
        v.append(p.set_config(new))                           # rejected destination
        new["output"]["protocol"]["UDP"].update(dest="127.0.0.1", port=80)
        v.append(p.set_config(new))                           # rejected port
        new["output"]["protocol"]["UDP"].update(port=19001)
        v.append(p.set_config(new))                           # Success
        new["pipeline"] = [["Source", "Split"], ["Split", "Sink"]]
        v.append(p.set_config(new))                           # Reset: rebuilt and restarted
        v.append(p.get_status()["status"])
        new["board"]["name"] = "other"
        v.append(p.set_config(new))                           # Reboot
        p.pause()
        v.append(p.get_status()["status"])
        p.release()
        v.append(p.get_status()["status"])
        verdicts[pkg] = v
    assert verdicts["torch"] == verdicts["jax"] == [
        "Success", "Invalid UDP destination address", "Invalid UDP destination port",
        "Success", "Reset", "Running", "Reboot", "Paused", "Initializing"]


def test_perception_needs_a_device(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TPerception()
    cfg = trt.ConfigManager().config
    for make in (tmod.SlamModule, tmod.DetectModule):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(cfg)


def test_online_sources_raise():
    """Online, ``SourceManager`` opens the configured sensors as the
    reference's does, and a sensor that cannot be opened raises: here a
    LiDAR whose UDP port another socket holds (the native receiver's bind
    fails)."""
    import socket
    from lsd_tpu_torch.runtime.source_manager import SourceManager
    holder = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    holder.bind(("0.0.0.0", 0))
    cfg = trt.ConfigManager().config
    cfg.input.mode = "online"
    cfg.lidar = [dict(name="0-VLP-16", port=holder.getsockname()[1], decoder="VLP-16")]
    try:
        src = SourceManager(cfg)
        assert src.player is None and not src.offline
        with pytest.raises(OSError, match="failed to open UDP port"):
            src.setup(cfg)
    finally:
        holder.close()


def test_eval_dump_lines_equal(tmp_path):
    rng = np.random.default_rng(7)
    poses = np.tile(np.eye(4), (8, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(8, 3)) * 10
    lines = {}
    for pkg, (rt, mod, _) in PKGS.items():
        sink = mod.EvalDumpSink(rt.ConfigManager().config, out_path=str(tmp_path / pkg / "dump.txt"))
        sink.process(dict(slam_pose=np.eye(4), ins_data=dict(latitude=37.0, Status=1)))  # disabled
        sink.start_dump()
        for k in range(8):
            ins = dict(latitude=37.0 + k * 1e-5, longitude=-122.0 + k * 2e-5, altitude=5.0 + k,
                       heading=90.0 + k, Status=[1, 42, 0, 52, 4, 42, 42, 0][k])
            sink.process(dict(frame_start_timestamp=1000 + k, slam_pose=poses[k], ins_data=ins))
        sink.process(dict(frame_start_timestamp=9, ins_data=dict(latitude=37.0, Status=1)))
        sink.release()
        lines[pkg] = open(tmp_path / pkg / "dump.txt", "rb").read()
    assert lines["torch"] == lines["jax"] and len(lines["torch"].splitlines()) == 6


STATUS_SEQ = ([(0.0, 42), (0.5, 42), (1.0, 42), (1.2, 52), (3.0, 42), (3.5, 42), (4.6, 42),
               (5.0, 4), (8.0, 52), (14.0, 52), (15.0, 52), (15.5, 0), (16.0, 0), (16.8, 0),
               (17.0, 42), (18.5, 42), (19.0, 1), (30.0, 1)])


def test_ins_status_priorities():
    got = {}
    for pkg, cls in (("jax", JIns), ("torch", TIns)):
        sm = cls()
        seq = []
        for t, status in STATUS_SEQ:
            lat = 0.0 if status == 0 else 42.0
            seq.append((sm.update(t, status, lat, lat), sm.state_name))
        got[pkg] = seq
    assert got["torch"] == got["jax"]
    prios = [p for p, _ in got["torch"]]
    assert set(prios) == {-1, 0, 1, 2}


NETWORK_CASES = [
    {},
    dict(board=dict(network=[dict(IP="10.0.0.5", mask="255.255.255.0", gateway="10.0.0.1")])),
    dict(board=dict(network=[dict(IP="1.2.3", mask="255.0.0.0", gateway="1.2.3.4")])),
    dict(board=dict(network=[dict(IP="10.0.0.5", mask="255.0.255.0", gateway="10.0.0.1")])),
    dict(board=dict(network=[dict(IP="10.0.0.5", mask="255.255.255.0", gateway="x")])),
    dict(board=dict(network=[dict(DHCP=True)])),
    dict(output=dict(protocol=dict(UDP=dict(use=True, dest="127.0.0.1", port=19000)))),
    dict(output=dict(protocol=dict(UDP=dict(use=True, destination="10.1.1.1", port=2000)))),
    dict(output=dict(protocol=dict(UDP=dict(use=True, dest="127.0.0.1", port="x")))),
    dict(output=dict(protocol=dict(UDP=dict(use=True, dest="127.0.0.1", port=50000)))),
    dict(output=dict(point_cloud=dict(use=True, destination="300.1.1.1"))),
    dict(output=dict(point_cloud=dict(use=True, destination="192.168.1.2"))),
]


@pytest.mark.parametrize("case", range(len(NETWORK_CASES)))
def test_network_validation_verdicts(case):
    assert tnet(NETWORK_CASES[case]) == jnet(NETWORK_CASES[case])


def test_bus_publish_and_receive(monkeypatch):
    """The port's bus delivers to its own subscriber and to the reference's,
    with the reference's datagram layout."""
    import lsd_tpu.comms.bus as jbus
    import lsd_tpu_torch.comms.bus as tbus
    from lsd_tpu_torch.comms.messages import odometry_msg
    # one registry for both packages: the reference's
    monkeypatch.setattr(tbus, "_registry_dir", jbus._registry_dir)
    got = {"jax": [], "torch": []}
    subs = [jbus.MessageBus(bus="tparity").subscribe(lambda ch, p: got["jax"].append((ch, p))),
            tbus.MessageBus(bus="tparity").subscribe(lambda ch, p: got["torch"].append((ch, p)))]
    pub = tbus.MessageBus(bus="tparity")
    time.sleep(0.1)
    msgs = [odometry_msg(k, np.eye(4)) for k in range(5)]
    for m in msgs:
        pub.publish("slam.odometry", m)
        time.sleep(0.01)
    deadline = time.time() + 3
    while time.time() < deadline and min(map(len, got.values())) < 5:
        time.sleep(0.02)
    for s in subs:
        s.close()
    assert got["jax"] == got["torch"] == [("slam.odometry", m) for m in msgs]


def test_cli_replay_integrates_a_reference_recording(tmp_path):
    from lsd_tpu.sim import CircleSim, SimConfig
    sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=6, points_per_scan=1024, seed=3))
    rec = JRecorder(str(tmp_path / "rec"))
    for k, (P, S, M, I, IM, _) in enumerate(sim.generate(capacity=1024, imu_capacity=16)):
        ts = 1_000_000 + k * 100_000
        n = int(M.sum())
        imu = np.asarray(I[: int(IM.sum())], np.float64)
        imu[:, 0] = ts + imu[:, 0] * 1e6
        rec.write(dict(frame_start_timestamp=ts, frame_timestamp_monotonic=ts,
                       points={"0-Custom": np.concatenate([P[:n], np.zeros((n, 1), np.float32)], 1)},
                       points_attr={"0-Custom": dict(timestamp=ts, points_attr=np.stack(
                           [S[:n], np.zeros(n, np.float32)], 1))},
                       image={}, image_param={}, lidar_valid=True, ins_valid=False, ins_data={},
                       imu_data=imu, motion_valid=False, timestep=100000))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"system:\n  record:\n    path: {tmp_path / 'records'}\n")
    cmd = [sys.executable, "-m", "lsd_tpu_torch", "replay", "--data", rec.log_dir, "--slam",
           "--duration", "6", "--config", str(cfg)]
    # the replay's module publishes on the core bus: a temporary directory
    # of its own keeps it off the registry that other processes share
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    out = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()[-1]
    assert "integrated=6 " in last, out.stdout
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(cmd + ["--duration", "0"], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
