"""The LIO step on CUDA tensors, replayed as CUDA graphs.

``slam/lio.py:lio_step`` comes here for CUDA tensors.  Run eagerly, the
step (``_lio_step_eager``) is ~2,900 launches of small kernels a scan, and
the card waits for the host most of the time.  Here the step is cut at its
two host decisions into segments, each captured once as a CUDA graph and
replayed inside the span that names it in the eager body:

- ``lio_step/front/propagate``, ``/undistort``, ``/downsample``, ``/match``;
- the iterations' set-up (the prior's inverse, the update mask, the
  velocity weight; the iterate and the plane anchor set to the propagated
  state), outside any span, as in the eager body;
- one Gauss-Newton iteration, replayed ``max_iters`` times inside
  ``lio_step/iterate``; it ends by computing on the device whether the next
  iteration must match its planes again;
- ``lio_step/iterate/research``: the plane match at the current iterate,
  replayed when the host reads that flag as true;
- ``lio_step/covariance``, with the step's ``info``;
- the scan's insert in ``lio_step/map_update``, with the trim flag.

The host reads the re-search flag after every iteration but the last (when
``research_thresh > 0``) and the trim flag once a scan: at most
``max_iters`` syncs a scan.  The trim runs eagerly on the scans that take
it.  Every segment composes the pieces of ``slam/lio.py`` that the eager
body composes, so the two compute the same thing.

Keys.  A key is what the inputs show: the ``LioConfig``, the map's type,
the shapes and dtypes of the map's and the scan's tensors, whether a
velocity observation and its flag are given, the device, and whether
deterministic algorithms are on (they change the kernels).  The first call
for a key runs the eager body on the capture stream: it builds the
kernels, creates cuBLAS's and cuSOLVER's handles and warms the allocator.
The second captures and replays, every later call replays.  cuBLAS and
cuSOLVER keep handles per thread, so a thread that has not run the eager
body for a key runs it once before it captures.  ``MAX_KEYS`` keys are
kept, the least recently used dropped.  A capture that fails raises.

Memory.  A key holds static copies of its inputs, into which each call
copies the state and scan it is given (the state passed in is only read),
and the segments' outputs, held for the key's life: a later capture cannot
reuse their memory, so a segment can be replayed while an earlier one's
results wait to be read.  The values carried across segments (the iterate,
the plane set and its anchor, the last iteration's information) are
outputs of an earlier segment that later ones overwrite with ``copy_``.
The returned state and info are fresh copies; a key's calls are serialised
by its lock.

Counters.  ``counters`` holds plain integers: captures (one a key),
replays and eager steps (one a step each, the CPU's included) and trims.
The kernels count their own launches where they run
(``p2p_reduce.launches`` and the like), a replayed graph's included.
"""
from __future__ import annotations

import collections
import os
import threading
from typing import Optional

import torch

from ..utils.spans import span
from . import lio as L
from .state import ERR_DIM, NavState

MAX_KEYS = 8
counters = dict(captures=0, replays=0, eager=0, trims=0)

_runners: "collections.OrderedDict[tuple, _Step]" = collections.OrderedDict()
_runners_lock = threading.Lock()
_streams = {}


def _capture_stream(dev: torch.device) -> Optional[torch.cuda.Stream]:
    """The side stream that warms and captures a device's keys."""
    if dev.type != "cuda":
        return None
    if dev.index not in _streams:
        _streams[dev.index] = torch.cuda.Stream(device=dev)
    return _streams[dev.index]


class _Graph:
    """One segment captured as a CUDA graph: ``out`` is what ``fn``
    returned while it was captured, and each ``replay()`` writes it anew.
    The graph keeps ``fn``, and with it every tensor that ``fn`` reads:
    the replays read their memory."""

    def __init__(self, fn, pool, stream):
        self.fn = fn
        # the profiler's teardown of CUPTI at the end of a trace can abort a
        # process that has captured graphs (torch.profiler keeps it for
        # torch.compile's graphs for this reason)
        os.environ["TEARDOWN_CUPTI"] = "0"
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.out = fn()

    def replay(self) -> None:
        self.graph.replay()


def _key(cfg, st, scan, vel_obs, vel_obs_valid) -> tuple:
    """What the inputs show of the step's graphs."""
    return (cfg, type(st.map), tuple((t.shape, t.dtype) for t in (*st.map, *scan)),
            vel_obs is None, vel_obs_valid is None, st.P.device,
            torch.are_deterministic_algorithms_enabled())


def _runner(key) -> "_Step":
    with _runners_lock:
        runner = _runners.get(key)
        if runner is None:
            runner = _runners[key] = _Step()
            while len(_runners) > MAX_KEYS:
                _runners.popitem(last=False)
        else:
            _runners.move_to_end(key)
        return runner


def _flat_inputs(st, scan, vel_obs, vel_obs_valid) -> list:
    return [*st.nav, st.P, *st.map, st.map_center, st.initialized, st.step_count, *scan,
            *[t for t in (vel_obs, vel_obs_valid) if t is not None]]


def _fresh(x):
    """``x`` with every tensor copied."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _fresh(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_fresh(v) for v in x])
    return type(x)(_fresh(v) for v in x)


class _Step:
    """One key's static inputs and captured segments."""

    def __init__(self):
        self.lock = threading.Lock()
        self.warmed = set()       # threads that ran the eager body for this key
        self.inputs = None        # static inputs, once captured

    def capture(self, cfg, st, scan, vel_obs, vel_obs_valid) -> None:
        dev = st.P.device
        pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
        stream = _capture_stream(dev)

        def seg(fn):
            return _Graph(fn, pool, stream)

        inputs = [t.clone(memory_format=torch.contiguous_format)
                  for t in _flat_inputs(st, scan, vel_obs, vel_obs_valid)]
        it = iter(inputs)
        nav = NavState(*[next(it) for _ in NavState._fields])
        P = next(it)
        m = type(st.map)(*[next(it) for _ in st.map])
        center, initialized, step_count = next(it), next(it), next(it)
        points, stamps, mask, imu, imu_mask = [next(it) for _ in scan]
        vel_obs, vel_obs_valid = L._velocity_observation(
            dev, next(it) if vel_obs is not None else None,
            next(it) if vel_obs_valid is not None else None)

        self.propagate = seg(lambda: L.propagate(nav, P, imu, imu_mask, cfg.imu_noise,
                                                 cfg.acc_scale))
        nav_prop, P_prop, track = self.propagate.out
        self.undistort = seg(lambda: L.undistort(points[:, :3], stamps, mask, nav_prop, track))
        pts_und = self.undistort.out
        self.downsample = seg(lambda: L._downsample(cfg, pts_und, mask))
        ds_pts, ds_mask = self.downsample.out
        self.match = seg(lambda: L._match_planes(cfg, nav_prop, ds_pts, ds_mask, m))
        planes = self.match.out
        front = L.ScanFront(nav_prop, P_prop, track, pts_und, ds_pts, ds_mask, planes)

        def setup():
            upd_mask, vw = L._iteration_weights(cfg, vel_obs_valid)
            return (L._prior_information(P_prop), upd_mask, vw,
                    NavState(*[t.clone() for t in nav_prop]),
                    (nav_prop.pos.clone(), nav_prop.quat.clone()),
                    torch.zeros((ERR_DIM, ERR_DIM), dtype=torch.float32, device=dev),
                    torch.zeros(4, dtype=torch.float32, device=dev))
        self.setup = seg(setup)
        P_inv, upd_mask, vw, nav_i, anchor, HtH, stats = self.setup.out

        def iteration():
            out = L._gn_step(cfg, nav_i, nav_prop, ds_pts, ds_mask, planes, P_inv, upd_mask,
                             vw, vel_obs)
            for dst, src in zip((*nav_i, HtH, stats), (*out[0], *out[1:])):
                dst.copy_(src)
            return L._research_due(cfg, nav_i, anchor) if cfg.research_thresh > 0 else None
        self.iteration = seg(iteration)

        def research():
            found = L._match_planes(cfg, nav_i, ds_pts, ds_mask, m)
            for dst, src in zip((*planes, *anchor), (*found, nav_i.pos, nav_i.quat)):
                dst.copy_(src)
        self.research = seg(research)

        def covariance():
            nav_new, P_new = L._covariance(initialized, front, nav_i, HtH, P_inv)
            return (nav_new, P_new, L._step_info(front, stats, nav_new), step_count + 1,
                    torch.ones((), dtype=torch.bool, device=dev))
        self.covariance = seg(covariance)
        nav_new = self.covariance.out[0]
        self.insert = seg(lambda: L._insert_scan(cfg, m, center, front, mask, nav_new))
        self.inputs = inputs

    def replay(self, cfg, st, scan, vel_obs, vel_obs_valid):
        for dst, src in zip(self.inputs, _flat_inputs(st, scan, vel_obs, vel_obs_valid)):
            dst.copy_(src)
        with span("lio_step/front"):
            with span("lio_step/front/propagate"):
                self.propagate.replay()
            with span("lio_step/front/undistort"):
                self.undistort.replay()
            with span("lio_step/front/downsample"):
                self.downsample.replay()
            with span("lio_step/front/match"):
                self.match.replay()
        self.setup.replay()
        with span("lio_step/iterate"):
            for it in range(cfg.max_iters):
                if (cfg.research_thresh > 0 and it > 0
                        and bool(self.iteration.out)):                     # host sync
                    with span("lio_step/iterate/research"):
                        self.research.replay()
                self.iteration.replay()
        with span("lio_step/covariance"):
            self.covariance.replay()
        with span("lio_step/map_update"):
            self.insert.replay()
            # the copies are queued before the host waits for the flag
            nav, P, info, step_count, initialized = _fresh(self.covariance.out)
            new_map, moved, center = self.insert.out
            # the map's voxel size is the one passed in, as in the eager body
            new_map = type(new_map)(*[_fresh(t) if f != "voxel_size" else st.map.voxel_size
                                      for f, t in zip(new_map._fields, new_map)])
            center = center.clone()
            if bool(moved):                                                # host sync
                new_map = L._trim(cfg, new_map, nav.pos)
                counters["trims"] += 1
        info["vel"] = nav.vel
        return L.LioState(nav=nav, P=P, map=new_map, map_center=center,
                          initialized=initialized, step_count=step_count), info


def _warm(fn, dev: torch.device):
    """``fn()`` on the capture stream, where the capture will run."""
    stream = _capture_stream(dev)
    if stream is None:
        return fn()
    # the side stream reuses memory only the eager body frees: wait for
    # what the current stream still does with memory it gave back
    torch.cuda.synchronize(dev)
    with torch.cuda.stream(stream):
        out = fn()
    torch.cuda.current_stream(dev).wait_stream(stream)
    return out


def step(cfg, st, points, stamps, mask, imu, imu_mask, vel_obs=None, vel_obs_valid=None):
    """``lio_step`` through the key's graphs: (state, info)."""
    scan = (points, stamps, mask, imu, imu_mask)
    runner = _runner(_key(cfg, st, scan, vel_obs, vel_obs_valid))
    with runner.lock:
        if runner.inputs is None:
            me = threading.get_ident()
            if me not in runner.warmed:
                runner.warmed.add(me)
                counters["eager"] += 1
                return _warm(lambda: L._lio_step_eager(cfg, st, *scan, vel_obs, vel_obs_valid),
                             st.P.device)
            runner.capture(cfg, st, scan, vel_obs, vel_obs_valid)
            counters["captures"] += 1
        counters["replays"] += 1
        return runner.replay(cfg, st, scan, vel_obs, vel_obs_valid)
