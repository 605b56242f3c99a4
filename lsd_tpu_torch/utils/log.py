"""A copy of ``lsd_tpu/utils/log.py`` for the port.

Logging setup (ref: util/log.py:12-29 — colorlog with process/thread ids;
we use stdlib logging with the same record fields, no extra deps).

A bounded in-memory ring of recent records backs the web UI's Dev log
view (the reference ships journal/log panes in web_ui components/dev/Log)."""
from __future__ import annotations

import collections
import logging
import os
import sys
import threading

_FMT = "%(asctime)s %(levelname).1s [%(process)d:%(threadName)s] %(name)s: %(message)s"
_configured = False
_ring: collections.deque = collections.deque(maxlen=500)
_ring_lock = threading.Lock()


class _RingHandler(logging.Handler):
    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = self.format(record)
        except Exception:
            return
        with _ring_lock:
            _ring.append(line)


def get_recent_logs(n: int = 200) -> list:
    """Most recent formatted log lines (oldest first)."""
    with _ring_lock:
        items = list(_ring)
    return items[-n:]


def get_logger(name: str = "lsd_tpu", level: str = "INFO") -> logging.Logger:
    global _configured
    if not _configured:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT))
        rh = _RingHandler()
        rh.setFormatter(logging.Formatter(_FMT))
        root = logging.getLogger("lsd_tpu")
        root.addHandler(h)
        root.addHandler(rh)
        # optional on-disk log (backs the dev page's log-file browser /
        # /v1/log-file-list, like the reference's /var/log files)
        log_dir = os.environ.get("LSD_TPU_LOG_DIR")
        if log_dir:
            try:
                os.makedirs(log_dir, exist_ok=True)
                fh = logging.FileHandler(
                    os.path.join(log_dir, "lsd_tpu.log"))
                fh.setFormatter(logging.Formatter(_FMT))
                root.addHandler(fh)
            except OSError:
                pass
        root.setLevel(os.environ.get("LSD_TPU_LOG_LEVEL", level))
        root.propagate = False
        _configured = True
    return logging.getLogger(name if name.startswith("lsd_tpu") else f"lsd_tpu.{name}")


def set_logger_level(level: str) -> None:
    logging.getLogger("lsd_tpu").setLevel(level.upper())
