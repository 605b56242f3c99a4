"""LIO replay: ``slam/lio.py:lio_step`` driven one scan per call in a closed
loop, each pose fetched to the host, as an offline replay or an
evaluation runs.

The traffic is one lap of a circle (``gen/circle.py``), made at set-up
from the seed and uploaded once, replayed lap after lap without a break:
the filter's state carries on across laps.  The output check follows the
program from its start: the reference replays the same scans from the
same start pose and compares every pose and covariance of the first
``n_check`` scans (the warm-up and a stretch of the window, its length
drawn from the seed) and the surfel map after the last of them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..compare import lio_gaps
from ..counts import lio_step as lio_counts
from ..counts import p2p as p2p_counts
from ..gen import circle


def checked_scans(tr: dict, seed: int) -> int:
    """How many scans from the start the check compares: the warm-up and a
    stretch of the window whose length is drawn from the seed."""
    lo, hi = tr["check_scans"]
    return int(tr["warm_scans"]) + int(np.random.default_rng(seed).integers(lo, hi + 1))


def control(cell, seed: int, device) -> dict:
    """The check's numbers with the reference in the program's place,
    computed with TF32 matmuls (the precision below the configuration's),
    against the reference: the control, which has to fail."""
    from ..reference import lio_ref
    lap, start = circle.lap(cell.traffic, seed, cell.config["points_per_scan"],
                            cell.config["imu_slots"])
    n = checked_scans(cell.traffic, seed)
    low = lio_ref.replay(cell.config["lio"], lap, start, n, device, tf32=True)
    return lio_gaps(*low, *lio_ref.replay(cell.config["lio"], lap, start, n, device))


class Driver:
    unit = "scans"

    def __init__(self, cell, seed: int, device):
        from lsd_tpu_torch.geometry import so3
        from lsd_tpu_torch.slam.lio import LioConfig, lio_init, lio_step
        from lsd_tpu_torch.slam.state import init_state

        self.conf, self.tr, self.limits, self.device = cell.config, cell.traffic, cell.limits, device
        self.lio_step = lio_step
        self.cfg = LioConfig(**self.conf["lio"])
        self.host_lap, self.start = circle.lap(self.tr, seed, self.conf["points_per_scan"],
                                               self.conf["imu_slots"])
        self.lap = [torch.as_tensor(a, device=device) for a in self.host_lap]
        self.lap_len = int(self.lap[0].shape[0])
        R, p, v = self.start
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        nav = init_state(device=device)._replace(pos=f(p), quat=so3.matrix_to_quat(f(R)),
                                                 vel=f(v))
        self.st = lio_init(self.cfg, nav)
        warm = int(self.tr["warm_scans"])
        self.n_check = checked_scans(self.tr, seed)
        self.poses = np.zeros((self.n_check, 4, 4))
        self.covs = torch.zeros((self.n_check, 24, 24), device=device)
        self.map_at_check = None
        self.k = 0
        self.failed = 0
        for _ in range(warm):
            self.step()
        self.attempted_outside_window = warm

    def step(self) -> float:
        K = self.lap[0].shape[0]
        scan = [a[self.k % K] for a in self.lap]
        t0 = time.perf_counter()
        self.st, info = self.lio_step(self.cfg, self.st, *scan)
        pose = info["pose"].cpu().numpy()
        lat = time.perf_counter() - t0
        if self.k < self.n_check:
            self.poses[self.k] = pose
            self.covs[self.k].copy_(self.st.P)
            if self.k == self.n_check - 1:
                m = self.st.map
                self.map_at_check = tuple(t.clone() for t in (m.keys, m.coords, m.moments))
        self.k += 1
        return lat

    def finish(self) -> None:
        while self.k < self.n_check:
            self.step()
            self.attempted_outside_window += 1

    def counts(self) -> dict:
        c = self.cfg
        return dict(b1_bytes=p2p_counts.b1_bytes(c.ds_capacity),
                    b1_flops=p2p_counts.b1_flops(c.ds_capacity),
                    b1_calls_per_scan=c.max_iters,
                    step_bytes=lio_counts.step_bytes(c.ds_capacity, c.max_iters,
                                                     self.conf["points_per_scan"]),
                    step_flops=lio_counts.step_flops(c.ds_capacity, c.max_iters))

    def release(self) -> None:
        self.covs = self.covs.double().cpu().numpy()
        self.map_at_check = tuple(t.cpu().numpy() for t in self.map_at_check)
        self.st = self.lap = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False):
        from ..reference import lio_ref
        return lio_ref.replay(self.conf["lio"], self.host_lap, self.start, self.n_check,
                              self.device, tf32=tf32)

    def describe(self) -> str:
        used = int(np.sum(self.map_at_check[0] >= 0))
        return (f"{self.n_check} scans checked from the start (lap of {self.lap_len}); "
                f"map {used} of {self.cfg.map_capacity} slots in use")

    def check(self):
        gaps = lio_gaps(self.poses, self.covs, self.map_at_check, *self.reference())
        return [(k, v, float(self.limits[k])) for k, v in gaps.items()]
