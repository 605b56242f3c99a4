"""TViz backend: wildcard bus subscriber with per-channel queues + JSON
(a copy of ``lsd_tpu/comms/message_server.py`` for the port).

Re-derivation of web_backend/message_server.py: subscribe to every channel,
sniff message types by trial decode, keep bounded per-channel deques, and
format messages to JSON-able dicts for the web charts/3D views.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from .bus import MessageBus
from .messages import decode_typed, sniff_type


class MessageServer:
    def __init__(self, bus: Optional[MessageBus] = None, depth: int = 50):
        self.bus = bus or MessageBus.core()
        self.depth = depth
        self.channels: Dict[str, collections.deque] = {}
        self.types: Dict[str, str] = {}
        self._lock = threading.Lock()
        self.enabled = True
        self.sub = self.bus.subscribe(self._on_msg)

    def set_enabled(self, on: bool) -> None:
        """Start/stop buffering (ref /v1/start-message-subscribe,
        /v1/stop-message-subscribe)."""
        self.enabled = bool(on)

    def _on_msg(self, channel: str, payload: bytes) -> None:
        if not self.enabled:
            return
        t = sniff_type(payload)
        if t is None:
            return
        with self._lock:
            self.types[channel] = t
            q = self.channels.setdefault(channel, collections.deque(maxlen=self.depth))
            q.append(payload)

    # query surface (the /v1/message-* routes call these) ---------------
    def get_meta(self) -> Dict[str, str]:
        with self._lock:
            return dict(self.types)

    def get_latest(self, channel: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            q = self.channels.get(channel)
            if not q:
                return None
            payload = q[-1]
        name, msg = decode_typed(payload)
        return self.format(name, msg)

    def get_series(self, channel: str, field_path: str) -> List[float]:
        """Chart support: extract a numeric field across the queue
        (e.g. 'twist.linear.x')."""
        with self._lock:
            items = list(self.channels.get(channel, []))
        out = []
        for payload in items:
            _, msg = decode_typed(payload)
            v: Any = msg
            for part in field_path.split("."):
                if not isinstance(v, dict) or part not in v:
                    v = None
                    break
                v = v[part]
            if isinstance(v, (int, float)):
                out.append(float(v))
        return out

    @staticmethod
    def format(name: str, msg: Dict) -> Dict[str, Any]:
        if name == "PointCloud":
            pts = np.frombuffer(msg.get("data", b""), np.float32).reshape(-1, 4)
            return dict(type=name, header=msg.get("header", {}),
                        num_points=int(msg.get("num_points", 0)),
                        points=pts[:, :3].tolist()[:5000])
        return dict(type=name, **msg)

    def close(self) -> None:
        self.sub.close()
