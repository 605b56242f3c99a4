"""Carry state between the JAX package and the port.

SLAM has no weights: what the two packages must share to continue one run
is state: the LIO filter state (navigation state, covariance, local map of
either type, map centre and flags), the ScanContext database, a padded
pose graph, the localizer's UKF state and its NDT map.  Both directions go
through numpy.

- ``*_from_numpy(tree, device)`` takes the JAX object after
  ``jax.device_get`` (numpy leaves, fields read by name, so this module
  needs nothing of the JAX package) or the dict ``*_to_numpy`` returns,
  and builds the port's object on ``device``.
- ``*_to_numpy(obj)`` returns (nested) dicts of numpy arrays with the
  reference's field names and layout, so the reference's NamedTuples
  rebuild from them by keyword: ``LioState(nav=NavState(**d["nav"]),
  map=SurfelMap(**d["map"]), ...)``, ``ScanContextDB(**d)``,
  ``PoseGraphData(nodes=GraphNodes(**d["nodes"]), ...)``, ``UkfState(**d)``,
  ``NdtMap(**d)``.  The surfel coords and moments are tuples of 3 and 10
  (C,) arrays there.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .ops.hashmap import VoxelHashMap
from .ops.surfel import SurfelMap
from .slam import posegraph as pg
from .slam.lio import LioState
from .slam.registration import NdtMap
from .slam.scancontext import ScanContextDB
from .slam.state import NavState
from .slam.ukf import UkfState
from .utils.device import DeviceLike, resolve_device


def _field(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _has(obj, name) -> bool:
    return name in obj if isinstance(obj, Mapping) else hasattr(obj, name)


def _uploader(device: DeviceLike):
    dev = resolve_device(device)

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)
    return t


def _a(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def lio_state_from_numpy(tree, device: DeviceLike = None) -> LioState:
    """The port's ``LioState`` on ``device`` from a numpy state tree; the
    map is a surfel map if it has ``moments``, else a raw-point map."""
    t = _uploader(device)
    nav = _field(tree, "nav")
    m = _field(tree, "map")
    if _has(m, "moments"):
        new_map = SurfelMap(
            keys=t(_field(m, "keys"), torch.int32),
            coords=t(np.stack(_field(m, "coords")), torch.int32),
            moments=t(np.stack(_field(m, "moments"))),
            voxel_size=t(_field(m, "voxel_size")))
    else:
        new_map = VoxelHashMap(
            keys=t(_field(m, "keys"), torch.int32),
            coords=t(_field(m, "coords"), torch.int32),
            points=t(_field(m, "points")),
            counts=t(_field(m, "counts"), torch.int32),
            voxel_size=t(_field(m, "voxel_size")))
    return LioState(
        nav=NavState(*[t(_field(nav, f)) for f in NavState._fields]),
        P=t(_field(tree, "P")),
        map=new_map,
        map_center=t(_field(tree, "map_center")),
        initialized=t(_field(tree, "initialized"), torch.bool),
        step_count=t(_field(tree, "step_count"), torch.int32),
    )


def lio_state_to_numpy(st: LioState) -> dict:
    """Nested dicts of numpy arrays in the reference's layout."""
    a = _a
    if isinstance(st.map, SurfelMap):
        m = dict(keys=a(st.map.keys),
                 coords=tuple(a(c) for c in st.map.coords),
                 moments=tuple(a(c) for c in st.map.moments),
                 voxel_size=a(st.map.voxel_size))
    else:
        m = {f: a(v) for f, v in zip(VoxelHashMap._fields, st.map)}
    return dict(
        nav={f: a(v) for f, v in zip(NavState._fields, st.nav)},
        P=a(st.P),
        map=m,
        map_center=a(st.map_center),
        initialized=a(st.initialized),
        step_count=a(st.step_count),
    )


_SC_DTYPES = dict(desc=torch.float32, ring_key=torch.float32, count=torch.int32,
                  mask=torch.bool)


def sc_db_from_numpy(tree, device: DeviceLike = None) -> ScanContextDB:
    t = _uploader(device)
    return ScanContextDB(**{f: t(_field(tree, f), d) for f, d in _SC_DTYPES.items()})


def sc_db_to_numpy(db: ScanContextDB) -> dict:
    return {f: _a(v) for f, v in zip(ScanContextDB._fields, db)}


_GRAPH_PARTS = dict(nodes=pg.GraphNodes, se3=pg.Se3Edges, gps=pg.GpsPriors,
                    floor=pg.FloorPriors, orient=pg.OrientPriors)


def _graph_dtype(field: str) -> torch.dtype:
    if field == "idx":
        return torch.int32
    return torch.bool if field in ("mask", "fixed") else torch.float32


def graph_from_numpy(tree, device: DeviceLike = None) -> pg.PoseGraphData:
    t = _uploader(device)
    return pg.PoseGraphData(**{
        part: cls(*[t(_field(_field(tree, part), f), _graph_dtype(f)) for f in cls._fields])
        for part, cls in _GRAPH_PARTS.items()})


def graph_to_numpy(graph: pg.PoseGraphData) -> dict:
    return {part: {f: _a(v) for f, v in zip(cls._fields, getattr(graph, part))}
            for part, cls in _GRAPH_PARTS.items()}


def ukf_state_from_numpy(tree, device: DeviceLike = None) -> UkfState:
    t = _uploader(device)
    return UkfState(x=t(_field(tree, "x")), P=t(_field(tree, "P")))


def ukf_state_to_numpy(st: UkfState) -> dict:
    return dict(x=_a(st.x), P=_a(st.P))


_NDT_DTYPES = dict(keys=torch.int32, mean=torch.float32, cov_inv=torch.float32,
                   counts=torch.int32, voxel_size=torch.float32)


def ndt_map_from_numpy(tree, device: DeviceLike = None) -> NdtMap:
    t = _uploader(device)
    return NdtMap(**{f: t(_field(tree, f), d) for f, d in _NDT_DTYPES.items()})


def ndt_map_to_numpy(m: NdtMap) -> dict:
    return {f: _a(v) for f, v in zip(NdtMap._fields, m)}
