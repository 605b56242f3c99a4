"""Pipeline runtime: modules, bounded queues, backpressure, health (a copy
of ``lsd_tpu/runtime/pipeline.py`` for the port; pure Python and threads).

Re-derivation of the reference's core runtime (module/manager_template.py
ManagerTemplate.run_loop/connect, module/module_manager.py ModuleManager
init/setup/check_status, module/common/data_splitter.py + data_merger.py):

- each Module runs a producer thread pulling ``get_data()`` from itself,
  applying backpressure via the downstream peer's ``try_enqueue`` (frames
  drop when the consumer is full, except offline mode which blocks so no
  frame is lost — slam_manager.py:72-84 semantics),
- Split fans one stream to many peers (all-peers backpressure), Merge
  joins keyed streams,
- a checker thread tracks per-module FPS/liveness and aggregate status.
"""
from __future__ import annotations

import enum
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

from ..utils.log import get_logger
from ..utils.period import PeriodCalculator


class PipelineStatus(enum.Enum):
    INITIALIZING = "Initializing"
    RUNNING = "Running"
    PAUSED = "Paused"
    STOPPED = "Stopped"
    ERROR = "Error"


class Module:
    """Base pipeline stage (ref ManagerTemplate)."""

    def __init__(self, name: str, queue_size: int = 3, blocking: bool = False):
        self.name = name
        self.queue: "queue.Queue[Dict]" = queue.Queue(maxsize=queue_size)
        self.peers: List["Module"] = []
        self.blocking = blocking          # offline mode: never drop
        self.fps = PeriodCalculator()
        self.drops = 0
        self.frames = 0
        self.last_latency_ms = 0.0
        self.latency_warn_ms = 100.0
        self._lat_warns = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.logger = get_logger(f"pipeline.{name}")

    # -- wiring ---------------------------------------------------------
    def connect(self, peer: "Module") -> None:
        self.peers.append(peer)

    # -- to override ----------------------------------------------------
    def setup(self, cfg) -> None:
        pass

    def release(self) -> None:
        pass

    def get_data(self) -> Optional[Dict]:
        """Produce the next frame (source) or transform the input frame."""
        try:
            data = self.queue.get(timeout=0.5)
        except queue.Empty:
            return None
        return self.process(data)

    def process(self, data: Dict) -> Optional[Dict]:
        return data

    # -- queue plumbing -------------------------------------------------
    def try_enqueue(self) -> bool:
        return not self.queue.full()

    def enqueue(self, data: Dict) -> None:
        if self.blocking:
            self.queue.put(data)
        else:
            try:
                self.queue.put_nowait(data)
            except queue.Full:
                self.drops += 1

    # -- loop -----------------------------------------------------------
    def start_loop(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run_loop, name=self.name,
                                        daemon=True)
        self._thread.start()

    def stop_loop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _run_loop(self) -> None:
        while not self._stop.is_set():
            t0 = time.monotonic()
            data = self.get_data()
            if not data:
                continue
            # per-stage latency warning (ref infer_base.py:93-99,
            # slam_template.py:59-65: warn when a stage exceeds 100 ms)
            self.last_latency_ms = (time.monotonic() - t0) * 1000.0
            if self.last_latency_ms > self.latency_warn_ms:
                self._lat_warns += 1
                if self._lat_warns % 10 == 1:
                    self.logger.warning("%s stage took %.0f ms", self.name,
                                        self.last_latency_ms)
            self.frames += 1
            self.fps.tick()
            for peer in self.peers:
                if peer.blocking or peer.try_enqueue():
                    peer.enqueue(data)
                else:
                    peer.drops += 1

    # -- health ---------------------------------------------------------
    def status(self) -> Dict:
        return dict(name=self.name, fps=round(self.fps.fps, 2),
                    frames=self.frames, drops=self.drops,
                    latency_ms=round(self.last_latency_ms, 1),
                    alive=self._thread.is_alive() if self._thread else False)


class Split(Module):
    """Fan-out stage (ref module/common/data_splitter.py): forwarding is
    already fan-out in Module._run_loop; Split only adds all-peers
    backpressure — the frame is forwarded only when every peer has room."""

    def _run_loop(self) -> None:
        while not self._stop.is_set():
            data = self.get_data()
            if not data:
                continue
            if all(p.blocking or p.try_enqueue() for p in self.peers):
                self.frames += 1
                self.fps.tick()
                for p in self.peers:
                    p.enqueue(data)
            else:
                self.drops += 1


class Merge(Module):
    """Keyed fan-in (ref module/common/data_merger.py): collect one frame
    from each input key before forwarding the merged dict."""

    def __init__(self, name: str, keys: List[str], queue_size: int = 3):
        super().__init__(name, queue_size=queue_size * max(len(keys), 1))
        self.keys = keys
        self.pending: Dict[str, Dict] = {}

    def process(self, data: Dict) -> Optional[Dict]:
        src = data.get("_source", "")
        self.pending[src] = data
        if all(k in self.pending for k in self.keys):
            merged: Dict = {}
            for k in self.keys:
                merged.update(self.pending.pop(k))
            return merged
        return None


class DataBank(Module):
    """Terminal cache of the latest frame (ref module/common/data_bank.py)."""

    def __init__(self, name: str = "DataBank"):
        super().__init__(name, queue_size=1)
        self.latest: Optional[Dict] = None
        self._lock = threading.Lock()
        from .interface import register_interface
        register_interface("databank.get_latest", self.get_latest)

    def process(self, data: Dict) -> Optional[Dict]:
        with self._lock:
            self.latest = data
        return data

    def get_latest(self) -> Optional[Dict]:
        with self._lock:
            return self.latest


class ModuleManager:
    """Builds + supervises the pipeline graph (ref module_manager.py)."""

    def __init__(self, registry: Dict[str, Callable[..., Module]]):
        self.registry = registry
        self.modules: Dict[str, Module] = {}
        self.status = PipelineStatus.INITIALIZING
        self.logger = get_logger("pipeline.manager")
        self._checker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def build(self, pipeline: List[List[str]], cfg) -> None:
        """pipeline: list of chains, e.g. [["Source", "SLAM", "Sink"]]."""
        names = {n for chain in pipeline for n in chain}
        for n in names:
            if n not in self.registry:
                raise KeyError(f"unknown module: {n}")
            if n not in self.modules:
                self.modules[n] = self.registry[n](cfg)
        for chain in pipeline:
            for a, b in zip(chain, chain[1:]):
                self.modules[a].connect(self.modules[b])
        for m in self.modules.values():
            m.setup(cfg)

    def start(self) -> None:
        for m in self.modules.values():
            m.start_loop()
        self.status = PipelineStatus.RUNNING
        self._stop.clear()
        self._checker = threading.Thread(
            target=self._check_loop,
            args=(getattr(self, "check_period", 5.0),),
            name="Checker", daemon=True)
        self._checker.start()

    def stop(self) -> None:
        self._stop.set()
        for m in self.modules.values():
            m.stop_loop()
            m.release()
        self.status = PipelineStatus.STOPPED

    MAX_RESTARTS = 3

    def _check_loop(self, period: float = 5.0) -> None:
        """Health checker (ref module_manager.py check_status:101-137):
        liveness + RESTART of dead module threads (bounded; escalates the
        pipeline to Error after MAX_RESTARTS), a CPU/RSS resource sample
        (ref module_manager.py:122-137 psutil monitor), and a status file
        heartbeat written every tick so external watchdogs can detect a
        hung boot (boot watchdog semantics)."""
        import json
        import os
        import tempfile
        status_path = os.environ.get("LSD_TPU_STATUS_FILE",
                                     os.path.join(tempfile.gettempdir(),
                                                  "lsd_tpu_status.json"))
        self._restarts: Dict[str, int] = getattr(self, "_restarts", {})
        while not self._stop.wait(period):
            for m in self.modules.values():
                st = m.status()
                if st["alive"] or self.status != PipelineStatus.RUNNING:
                    continue
                n = self._restarts.get(m.name, 0)
                if n < self.MAX_RESTARTS:
                    self._restarts[m.name] = n + 1
                    self.logger.warning(
                        "module %s thread died; restarting (%d/%d)",
                        m.name, n + 1, self.MAX_RESTARTS)
                    try:
                        m.start_loop()
                    except Exception:
                        self.logger.exception("restart of %s failed", m.name)
                else:
                    self.logger.error(
                        "module %s died %d times; pipeline -> Error",
                        m.name, n)
                    self.status = PipelineStatus.ERROR
            self._sample_resources()
            try:
                with open(status_path, "w") as f:
                    json.dump(self.get_status(), f)
            except OSError:
                pass

    def _sample_resources(self) -> None:
        """Process CPU%/RSS without psutil: /proc deltas."""
        import os
        try:
            with open("/proc/self/statm") as f:
                rss_pages = int(f.read().split()[1])
            rss_mb = rss_pages * os.sysconf("SC_PAGE_SIZE") / 1e6
            t = os.times()
            cpu_s = t.user + t.system
            now = time.monotonic()
            prev = getattr(self, "_cpu_prev", None)
            pct = 0.0
            if prev is not None and now > prev[1]:
                pct = 100.0 * (cpu_s - prev[0]) / (now - prev[1])
            self._cpu_prev = (cpu_s, now)
            self.resources = dict(rss_mb=round(rss_mb, 1),
                                  cpu_pct=round(pct, 1),
                                  threads=threading.active_count())
        except OSError:
            self.resources = {}

    def get_status(self) -> Dict:
        return dict(status=self.status.value,
                    modules={n: m.status() for n, m in self.modules.items()},
                    resources=getattr(self, "resources", {}),
                    restarts=dict(getattr(self, "_restarts", {})))
