"""INS quality state machine
(a copy of ``lsd_tpu/sensors/ins_status.py`` for the port).

Re-derivation of the reference's preprocessInsData priority/stable-time
logic (slam/src/slam.cpp:194-268): each raw INS status code maps to a
configured trust priority; downgrades take effect IMMEDIATELY, upgrades
only after the higher status has been held for its configured
stable_time; losing fixes for >= 1 s invalidates the state.  The SLAM
layer uses the accepted priority to gate GNSS factors and velocity
observations.

Default table mirrors the reference's cfg slam.ins_float/ins_fix idea:

    status 42 (RTK fixed)    -> priority 2, stable 1 s
    status 52 (RTK float)    -> priority 1, stable 5 s
    any other nonzero status -> priority 0, stable 10 s
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class InsStatusEntry:
    status: int          # raw status code; -1 matches any nonzero status
    priority: int
    stable_time: float   # seconds the status must hold before trusted
    name: str = ""


DEFAULT_TABLE = [
    InsStatusEntry(status=42, priority=2, stable_time=1.0, name="rtk_fix"),
    InsStatusEntry(status=52, priority=1, stable_time=5.0, name="rtk_float"),
    InsStatusEntry(status=-1, priority=0, stable_time=10.0, name="single"),
]


class InsStatusMachine:
    def __init__(self, table=None):
        self.table = list(table if table is not None else DEFAULT_TABLE)
        self.by_priority: Dict[int, InsStatusEntry] = {
            e.priority: e for e in self.table}
        self.last_priority = -1
        self.last_time: Optional[float] = None

    def _match(self, status: int) -> Optional[InsStatusEntry]:
        for e in self.table:
            if e.status == status:
                return e
        for e in self.table:
            if e.status == -1:
                return e
        return None

    @property
    def state_name(self) -> str:
        e = self.by_priority.get(self.last_priority)
        return e.name if e else "invalid"

    def update(self, t_sec: float, status: int, latitude: float = 1.0,
               longitude: float = 1.0) -> int:
        """Feed one fix; returns the ACCEPTED priority (-1 = reject).

        Mirrors slam.cpp exactly: invalid fixes (status 0 at ~0 lat/lon)
        downgrade to invalid after >= 1 s without valid data; equal
        priority refreshes the clock; lower priority applies at once;
        higher priority applies only after stable_time has elapsed since
        the last state change/refresh.
        """
        if status == 0 and abs(latitude) < 1e-4 and abs(longitude) < 1e-4:
            if self.last_priority != -1 and self.last_time is not None \
                    and t_sec - self.last_time >= 1.0:
                self.last_priority = -1
            return -1

        m = self._match(status)
        prio = m.priority if m else -1
        if prio == self.last_priority:
            self.last_time = t_sec
            return prio
        if prio < self.last_priority:
            self.last_priority = prio          # downgrade immediately
            self.last_time = t_sec
            return prio
        # upgrade: require stability
        if self.last_time is None:
            self.last_time = t_sec
            return self.last_priority
        keep = t_sec - self.last_time
        if m is not None and keep >= m.stable_time:
            self.last_priority = prio
            self.last_time = t_sec
            return prio
        return self.last_priority
