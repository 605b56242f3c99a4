"""Perception facade: boots config + modules, runtime control surface
(counterpart of ``lsd_tpu/runtime/perception.py``).

Re-derivation of module/perception.py:17-100 — the object the RPC layer
talks to: setup/release/start/pause/get_config/set_config/get_status/call.
The modules that touch the card (``SLAM``, ``Detect``) are built on the
facade's ``device``: the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import functools
import sys
import traceback
from typing import Any, Dict, Optional

from ..utils.device import DeviceLike, resolve_device
from ..utils.log import get_logger, set_logger_level
from ..utils.network import network_validation
from ..utils.system import init_backtrace_handle, set_thread_priority
from .config import CheckResult, ConfigManager
from .interface import call_interface, register_interface
from .modules import DetectModule, SinkModule, SlamModule
from .pipeline import ModuleManager, PipelineStatus, Split
from .source_manager import SourceManager


def default_registry(device: DeviceLike = None) -> Dict:
    """The reference's ``DEFAULT_REGISTRY``, its device modules bound to
    ``device``."""
    return {
        "Source": SourceManager,
        "SLAM": functools.partial(SlamModule, device=device),
        "Detect": functools.partial(DetectModule, device=device),
        "Sink": SinkModule,
        "Split": lambda cfg: Split("Split"),
    }


class Perception:
    def __init__(self, config_path: Optional[str] = None,
                 registry: Optional[Dict] = None, device: DeviceLike = None):
        self.logger = get_logger("perception")
        self.device = resolve_device(device)
        # fatal-signal tracebacks + best-effort priority, like the
        # reference boot (perception.py:19 init_backtrace_handle +
        # set_thread_priority)
        init_backtrace_handle()
        set_thread_priority()
        self.config_manager = ConfigManager(config_path)
        self.registry = registry or default_registry(self.device)
        self.module_manager: Optional[ModuleManager] = None
        register_interface("perception.set_logger_level", set_logger_level)

    # lifecycle ---------------------------------------------------------
    def setup(self) -> None:
        cfg = self.config_manager.config
        self.module_manager = ModuleManager(self.registry)
        self.module_manager.build(cfg.pipeline, cfg)

    def start(self) -> None:
        if self.module_manager is None:
            self.setup()
        self.module_manager.start()

    def pause(self) -> None:
        if self.module_manager:
            self.module_manager.status = PipelineStatus.PAUSED
            call_interface("player.pause")

    def release(self) -> None:
        if self.module_manager:
            self.module_manager.stop()
            self.module_manager = None

    # config ------------------------------------------------------------
    def get_config(self) -> Dict:
        return self.config_manager.config.to_dict()

    def set_config(self, new: Dict) -> str:
        # reject invalid network / output destinations before anything
        # applies (ref config_manager.py:11 network_validation gate)
        ok, msg = network_validation(new if isinstance(new, dict) else {})
        if not ok:
            return msg
        result = self.config_manager.set_config(new)
        if result == CheckResult.RESET and self.module_manager is not None:
            self.release()
            self.setup()
            self.start()
        return result.value

    # status ------------------------------------------------------------
    def get_status(self) -> Dict:
        if self.module_manager is None:
            return dict(status=PipelineStatus.INITIALIZING.value, modules={})
        return self.module_manager.get_status()

    # in-proc RPC -------------------------------------------------------
    def call(self, name: str, *args, **kwargs) -> Any:
        return call_interface(name, *args, **kwargs)

    def dump(self) -> str:
        """Thread stack dump (ref module_manager.py dump_threads_stack)."""
        out = []
        for tid, frame in sys._current_frames().items():
            out.append(f"--- thread {tid} ---")
            out.append("".join(traceback.format_stack(frame)))
        return "\n".join(out)
