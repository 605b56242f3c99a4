"""Carry LIO filter state between the JAX package and the port.

SLAM has no weights: what the two packages must share to continue one run
is the filter state (navigation state, covariance, surfel map, map centre
and flags).  Both directions go through numpy.

- ``lio_state_from_numpy(tree, device)`` takes a JAX ``LioState`` after
  ``jax.device_get`` (numpy leaves, fields read by name, so this module
  needs nothing of the JAX package) or the dict ``lio_state_to_numpy``
  returns, and builds the port's ``LioState``.
- ``lio_state_to_numpy(st)`` returns nested dicts of numpy arrays with the
  reference's field names and layout: the surfel coords and moments as
  tuples of 3 and 10 (C,) arrays, so ``LioState(nav=NavState(**d["nav"]),
  map=SurfelMap(**d["map"]), ...)`` rebuilds the JAX state.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .ops.surfel import SurfelMap
from .slam.lio import LioState
from .slam.state import NavState
from .utils.device import DeviceLike, resolve_device


def _field(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def lio_state_from_numpy(tree, device: DeviceLike = None) -> LioState:
    """The port's ``LioState`` on ``device`` from a numpy state tree."""
    dev = resolve_device(device)

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    nav = _field(tree, "nav")
    m = _field(tree, "map")
    if not ("moments" in m if isinstance(m, Mapping) else hasattr(m, "moments")):
        raise NotImplementedError("only the surfel map is ported; the raw-point "
                                  "map is ROADMAP queue A item 7")
    return LioState(
        nav=NavState(*[t(_field(nav, f)) for f in NavState._fields]),
        P=t(_field(tree, "P")),
        map=SurfelMap(
            keys=t(_field(m, "keys"), torch.int32),
            coords=t(np.stack(_field(m, "coords")), torch.int32),
            moments=t(np.stack(_field(m, "moments"))),
            voxel_size=t(_field(m, "voxel_size")),
        ),
        map_center=t(_field(tree, "map_center")),
        initialized=t(_field(tree, "initialized"), torch.bool),
        step_count=t(_field(tree, "step_count"), torch.int32),
    )


def lio_state_to_numpy(st: LioState) -> dict:
    """Nested dicts of numpy arrays in the reference's layout."""
    def a(x):
        return x.detach().cpu().numpy()

    return dict(
        nav={f: a(v) for f, v in zip(NavState._fields, st.nav)},
        P=a(st.P),
        map=dict(keys=a(st.map.keys),
                 coords=tuple(a(c) for c in st.map.coords),
                 moments=tuple(a(c) for c in st.map.moments),
                 voxel_size=a(st.map.voxel_size)),
        map_center=a(st.map_center),
        initialized=a(st.initialized),
        step_count=a(st.step_count),
    )
