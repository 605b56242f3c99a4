"""Process-local string -> callable registry (a copy of
``lsd_tpu/runtime/interface.py`` for the port).

Re-derivation of module/export_interface.py:1-13 — the universal in-process
RPC used by the web layer (``perception.call``)."""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict

_registry: Dict[str, Callable] = {}
_lock = threading.Lock()


def register_interface(name: str, fn: Callable) -> None:
    with _lock:
        _registry[name] = fn


def call_interface(name: str, *args, **kwargs) -> Any:
    with _lock:
        fn = _registry.get(name)
    if fn is None:
        raise KeyError(f"interface not registered: {name}")
    return fn(*args, **kwargs)


def has_interface(name: str) -> bool:
    with _lock:
        return name in _registry


def clear_interfaces() -> None:
    with _lock:
        _registry.clear()
