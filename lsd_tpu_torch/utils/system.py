"""Process-level system utilities
(a copy of ``lsd_tpu/utils/system.py`` for the port).

Re-derivation of the reference's SystemUtils + common_util roles
(sensor_driver/common_lib/cpp_utils/SystemUtils.cpp backtrace handler +
thread priority, installed at boot in module/perception.py:19;
util/common_util.py journal capture used by the recorder):

- ``init_backtrace_handle`` — dump Python tracebacks of all threads on
  SIGSEGV/SIGABRT/SIGFPE (stdlib faulthandler; the crash-diagnosis role
  of the C++ backtrace handler)
- ``set_thread_priority`` — best-effort niceness/affinity tweaks
- ``capture_journal`` — snapshot dmesg/journal tails into a recording
  directory for post-mortem (ref frame_sink.py:90-94)
"""
from __future__ import annotations

import os
import subprocess
import sys
from typing import Optional


def init_backtrace_handle(log_path: Optional[str] = None) -> None:
    """Install fatal-signal traceback dumping (idempotent)."""
    import faulthandler
    stream = sys.stderr
    if log_path:
        try:
            stream = open(log_path, "a")
        except OSError:
            stream = sys.stderr
    if not faulthandler.is_enabled():
        faulthandler.enable(file=stream, all_threads=True)


def set_thread_priority(nice_delta: int = -5,
                        cpu_affinity=None) -> bool:
    """Raise process priority / pin CPUs, best-effort (the reference
    raises the perception process's scheduling class; unprivileged
    containers typically refuse — return False then)."""
    ok = True
    try:
        os.nice(nice_delta)
    except (OSError, PermissionError):
        ok = False
    if cpu_affinity is not None:
        try:
            os.sched_setaffinity(0, set(int(c) for c in cpu_affinity))
        except (OSError, AttributeError, ValueError):
            ok = False
    return ok


def capture_journal(out_dir: str, lines: int = 200) -> Optional[str]:
    """Write kernel/system log tails next to a recording (best-effort;
    returns the file path or None)."""
    path = os.path.join(out_dir, "journal.txt")
    chunks = []
    for cmd in (["dmesg", "--ctime"], ["journalctl", "-n", str(lines),
                                       "--no-pager"]):
        try:
            out = subprocess.run(cmd, capture_output=True, timeout=5,
                                 text=True).stdout
            if out:
                chunks.append(f"===== {' '.join(cmd)} =====\n"
                              + "\n".join(out.splitlines()[-lines:]))
        except (OSError, subprocess.TimeoutExpired):
            continue
    if not chunks:
        return None
    try:
        with open(path, "w") as f:
            f.write("\n\n".join(chunks) + "\n")
    except OSError:
        return None
    return path
