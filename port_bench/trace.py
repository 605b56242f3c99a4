"""What a ``torch.profiler`` trace of a stretch of the window says.

``Trace`` holds the stretch's events as plain arrays (host operators,
runtime calls and spans; device kernels, copies and sets), and answers
the questions the per-layer readers ask: span time, launches, device time
by kernel, the union of device intervals, and the idle gaps with what the
host was doing in them.  All times are seconds.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import numpy as np

STRETCH = "bench/stretch"
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")


def _events(prof):
    """(name, on device?, user annotation?, start s, end s) of every event."""
    res = prof.profiler.kineto_results
    out = []
    for e in res.events():
        dev = e.device_type().name != "CPU"
        out.append((e.name(), dev, bool(e.is_user_annotation()), e.start_ns() * 1e-9,
                    e.end_ns() * 1e-9))
    return out


class Trace:
    def __init__(self, events, items: int):
        """``events`` as ``_events`` gives them; ``items`` the scans or
        frames of the stretch, which the span ``STRETCH`` encloses."""
        self.items = items
        host = [e for e in events if not e[1]]
        stretch = [e for e in host if e[0] == STRETCH]
        if not stretch:
            raise ValueError(f"the trace holds no {STRETCH!r} span")
        self.t0, self.t1 = stretch[0][3], stretch[0][4]
        self.window_s = self.t1 - self.t0
        self.host_names = [e[0] for e in host]
        self.host_annot = np.asarray([e[2] for e in host], bool)
        self.host_t = np.asarray([(e[3], e[4]) for e in host], float).reshape(-1, 2)
        dev = [e for e in events if e[1] and not e[2] and e[4] > self.t0 and e[3] < self.t1]
        self.dev_names = [e[0] for e in dev]
        self.dev_t = np.clip(np.asarray([(e[3], e[4]) for e in dev], float).reshape(-1, 2),
                             self.t0, self.t1)

    @classmethod
    def from_profiler(cls, prof, items: int) -> "Trace":
        return cls(_events(prof), items)

    # -- host side ------------------------------------------------------
    def spans(self, name: str) -> np.ndarray:
        """(k, 2) start and end of each span ``name`` inside the stretch."""
        sel = [i for i, n in enumerate(self.host_names) if n == name and self.host_annot[i]]
        t = self.host_t[sel]
        return t[(t[:, 0] >= self.t0) & (t[:, 1] <= self.t1)]

    def span_s(self, name: str) -> float:
        t = self.spans(name)
        return float((t[:, 1] - t[:, 0]).sum())

    def launches(self) -> int:
        """Kernel launches the host made inside the stretch."""
        t = self.host_t
        inside = (t[:, 0] >= self.t0) & (t[:, 0] <= self.t1)
        return int(sum(1 for i in np.flatnonzero(inside)
                       if self.host_names[i].startswith(LAUNCH_PREFIXES)))

    # -- device side ----------------------------------------------------
    def kernel_s(self, contains: str) -> Tuple[float, int]:
        """(device seconds, count) of the kernels whose name holds ``contains``."""
        sel = [i for i, n in enumerate(self.dev_names) if contains in n]
        t = self.dev_t[sel]
        return float((t[:, 1] - t[:, 0]).sum()), len(sel)

    def busy(self) -> np.ndarray:
        """The union of the device's intervals, (k, 2), sorted."""
        if not len(self.dev_t):
            return np.zeros((0, 2))
        t = self.dev_t[np.argsort(self.dev_t[:, 0])]
        out: List[List[float]] = [list(t[0])]
        for s, e in t[1:]:
            if s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return np.asarray(out)

    def busy_s(self) -> float:
        b = self.busy()
        return float((b[:, 1] - b[:, 0]).sum())

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        tot: Dict[str, float] = collections.defaultdict(float)
        for n, (s, e) in zip(self.dev_names, self.dev_t):
            tot[n] += e - s
        return sorted(tot.items(), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10, min_s: float = 20e-6) -> List[Tuple[str, float]]:
        """The device's idle time inside the stretch, summed by the innermost
        host event that covers each gap's middle (gaps of ``min_s`` or
        more; a gap with no host event is "host")."""
        b = self.busy()
        edges = np.concatenate([[self.t0], b.ravel(), [self.t1]]).reshape(-1, 2)
        gaps = edges[(edges[:, 1] - edges[:, 0]) >= min_s]
        # host events nest: sweep the gaps' middles in order with a stack
        # of the events open at that time; its top is the innermost
        order = [i for i in np.argsort(self.host_t[:, 0], kind="stable")
                 if self.host_names[i] != STRETCH]
        tot: Dict[str, float] = collections.defaultdict(float)
        stack: List[int] = []
        k = 0
        for s, e in gaps[np.argsort(gaps[:, 0])]:
            mid = 0.5 * (s + e)
            while k < len(order) and self.host_t[order[k], 0] <= mid:
                stack.append(order[k])
                k += 1
            while stack and self.host_t[stack[-1], 1] < mid:
                stack.pop()
            tot[self.host_names[stack[-1]] if stack else "host"] += e - s
        return sorted(tot.items(), key=lambda kv: -kv[1])[:top]
