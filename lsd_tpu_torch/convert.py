"""Carry state and weights between the JAX package and the port.

SLAM has no weights: what the two packages must share to continue one run
is state: the LIO filter state (navigation state, covariance, local map of
either type, map centre and flags), the ScanContext database, a padded
pose graph, the localizer's UKF state and its NDT map.  Both directions go
through numpy.  The detector has weights: ``detector_params_from_flax``
turns a flax parameter tree (a shipped checkpoint as
``models/params_io.load_params`` reads it) into the ``state_dict`` of the
port's ``CenterPointDetector``, ``detector_params_to_flax`` the other way;
``camera_params_*`` do the same for the camera models (Mono3D, Yolo2D),
whose modules carry the flax tree's names, and ``load_camera_params``
loads a checkpoint into one after checking every shape.  A trainer's
optimizer state moves with ``optimizer_state_{from,to}_optax``, its
moments through the same leaf mapping as the weights.

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

from .models.detector import CenterPointDetector
from .models.params_io import tree_to_state_dict
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


# --------------------------------------------------------------------------
# detector weights.  Layouts: flax Dense (in, out) -> Linear (out, in); Conv
# HWIO -> Conv2d OIHW; ConvTranspose HWIO -> ConvTranspose2d (I, O, kH, kW)
# with both spatial axes flipped (flax does not flip a transposed conv's
# kernel, PyTorch's placement is that of a flipped one); norm "scale" ->
# "weight".  The backbone's up-path modules are numbered by type in flax
# (Conv_n for the stages already at the output stride, which come first,
# then ConvTranspose_n) and by stage in ``backbone.ups``.

_TOP = {"PillarVFE_0": "vfe", "VoxelHeightEncoder_0": "encoder", "BEVBackbone_0": "backbone",
        "CenterHead_0": "head"}
_VFE = {"Dense_0": "linear", "LayerNorm_0": "norm", "Conv_0": "conv", "GroupNorm_0": "norm"}
_BLOCK = {"Conv_0": "conv0", "Conv_1": "conv1", "Conv_2": "shortcut", "GroupNorm_0": "norm0",
          "GroupNorm_1": "norm1"}


def _torch_module(path, n_conv_ups: int) -> str:
    """The port's module name for a flax module path (a tuple of names)."""
    top, *rest = path
    out = [_TOP[top]]
    if top == "BEVBackbone_0":
        if rest[0].startswith("ResBlock_"):
            out += ["blocks", rest[0].split("_")[1], _BLOCK[rest[1]]]
        elif rest[0].startswith("ConvTranspose_"):
            out += ["ups", str(n_conv_ups + int(rest[0].split("_")[1]))]
        else:
            out += ["ups", rest[0].split("_")[1]]
    elif top == "CenterHead_0":
        out += (["shared"] if rest[0] == "Conv_0"
                else ["heads", *rest[0].rsplit("_", 1)])     # hm_conv1 -> heads.hm.conv1
    else:
        out.append(_VFE[rest[0]])
    return ".".join(out)


def _flax_module(name: str, n_conv_ups: int):
    """The flax module path for one of the port's module names."""
    parts = name.split(".")
    flax_top = {v: k for k, v in _TOP.items()}[parts[0]]
    if parts[0] == "backbone":
        if parts[1] == "blocks":
            return (flax_top, f"ResBlock_{parts[2]}", {v: k for k, v in _BLOCK.items()}[parts[3]])
        i = int(parts[2])
        return (flax_top, f"Conv_{i}" if i < n_conv_ups else f"ConvTranspose_{i - n_conv_ups}")
    if parts[0] == "head":
        return (flax_top, "Conv_0" if parts[1] == "shared" else f"{parts[2]}_{parts[3]}")
    kind = {"linear": "Dense_0", "conv": "Conv_0"}.get(parts[1])
    norm = "LayerNorm_0" if parts[0] == "vfe" else "GroupNorm_0"
    return (flax_top, kind or norm)


def detector_params_from_flax(tree) -> "dict[str, torch.Tensor]":
    """The ``state_dict`` of the port's ``CenterPointDetector`` (float32, on
    the CPU) from a flax parameter tree: ``{"params": {...}}`` or the inner
    dict."""
    params = tree.get("params", tree)
    if "dsvt" in params:             # kept by its PyTorch names (params_io)
        return tree_to_state_dict(params)
    bb = params.get("BEVBackbone_0", {})
    n_conv_ups = sum(k.startswith("Conv_") for k in bb)
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            a = np.asarray(v, np.float32)
            kind = path[-1]
            if k == "kernel" and kind.startswith("Dense"):
                a = a.T
            elif k == "kernel" and kind.startswith("ConvTranspose"):
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            elif k == "kernel":
                a = a.transpose(3, 2, 0, 1)
            leaf = {"kernel": "weight", "scale": "weight"}.get(k, k)
            out[_torch_module(path, n_conv_ups) + "." + leaf] = torch.tensor(
                np.ascontiguousarray(a))
    walk(params, ())
    return out


def detector_params_to_flax(model: CenterPointDetector, tensors=None) -> dict:
    """``{"params": {...}}`` of numpy float32 arrays for the reference's
    ``CenterPointDetector`` with the weights of the port's ``model``, or
    with ``tensors`` (a mapping of its parameter names to tensors of their
    shapes, such as an optimizer's moments) in their place."""
    tensors = dict(model.named_parameters()) if tensors is None else tensors
    n_conv_ups = sum(isinstance(m, torch.nn.Conv2d) for m in model.backbone.ups)
    params: dict = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                                torch.nn.LayerNorm, torch.nn.GroupNorm)):
            continue
        w = _a(tensors[name + ".weight"])
        if isinstance(mod, torch.nn.Linear):
            leaf = dict(kernel=w.T)
        elif isinstance(mod, torch.nn.ConvTranspose2d):
            leaf = dict(kernel=w.transpose(2, 3, 0, 1)[::-1, ::-1])
        elif isinstance(mod, torch.nn.Conv2d):
            leaf = dict(kernel=w.transpose(2, 3, 1, 0))
        else:
            leaf = dict(scale=w)
        leaf["bias"] = _a(tensors[name + ".bias"])
        node = params
        for part in _flax_module(name, n_conv_ups):
            node = node.setdefault(part, {})
        node.update({k: np.ascontiguousarray(v, np.float32) for k, v in leaf.items()})
    return {"params": params}


# --------------------------------------------------------------------------
# camera model weights (Mono3D, Yolo2D).  The port's modules carry the flax
# tree's names (ConvBlock_k.Conv_0, ResBlock_k.ConvBlock_j, Conv_k), so a
# leaf moves by name: Conv HWIO -> Conv2d OIHW, norm "scale" -> "weight".
# What a checkpoint holds (class count, widths) comes from its own shapes.


def camera_params_from_flax(tree) -> "dict[str, torch.Tensor]":
    """The ``state_dict`` (float32, on the CPU) of the port's ``Mono3D`` or
    ``Yolo2D`` from a flax parameter tree: ``{"params": {...}}`` or the
    inner dict."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            a = np.asarray(v, np.float32)
            if k == "kernel":
                a = a.transpose(3, 2, 0, 1)
            leaf = {"kernel": "weight", "scale": "weight"}.get(k, k)
            out[".".join(path + (leaf,))] = torch.tensor(np.ascontiguousarray(a))
    walk(tree.get("params", tree), ())
    return out


def camera_params_to_flax(model: torch.nn.Module, tensors=None) -> dict:
    """``{"params": {...}}`` of numpy float32 arrays for the reference's
    ``Mono3D`` or ``Yolo2D`` with the weights of the port's ``model``, or
    with ``tensors`` (a mapping of its parameter names to tensors of their
    shapes) in their place."""
    params: dict = {}
    for name, t in (model.state_dict() if tensors is None else tensors).items():
        *path, leaf = name.split(".")
        a = _a(t)
        if a.ndim == 4:
            leaf, a = "kernel", a.transpose(2, 3, 1, 0)
        elif leaf == "weight":
            leaf = "scale"
        node = params
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(a, np.float32)
    return {"params": params}


def load_camera_params(model: torch.nn.Module, tree) -> None:
    """Load a flax tree into ``model``; a checkpoint that does not describe
    the model (another class count or width, a missing or extra leaf)
    raises ``ValueError`` naming the leaf and both shapes."""
    state = camera_params_from_flax(tree)
    want = model.state_dict()
    for name in sorted(set(state) | set(want)):
        got_shape = tuple(state[name].shape) if name in state else None
        want_shape = tuple(want[name].shape) if name in want else None
        if got_shape != want_shape:
            raise ValueError(
                f"the checkpoint does not fit {type(model).__name__}({model.cfg}): "
                f"{name} is {got_shape} in the checkpoint and {want_shape} in the model")
    model.load_state_dict(state)


# --------------------------------------------------------------------------
# optimizer state.  optax's state of the trainers' chain
# ``chain(clip_by_global_norm, adamw(schedule))`` is
# ``(EmptyState(), (ScaleByAdamState(count, mu, nu), EmptyState(),
# ScaleByScheduleState(count)))``, ``mu`` and ``nu`` trees of the model's
# parameter layout; the port's is ``training.optim.ClippedAdamW.state_dict()``.


def _params_from_flax(model: torch.nn.Module, tree) -> "dict[str, torch.Tensor]":
    if isinstance(model, CenterPointDetector):
        return detector_params_from_flax(tree)
    return camera_params_from_flax(tree)


def _params_to_flax(model: torch.nn.Module, tensors) -> dict:
    if isinstance(model, CenterPointDetector):
        return detector_params_to_flax(model, tensors)
    return camera_params_to_flax(model, tensors)


def optimizer_state_from_optax(tree, model: torch.nn.Module) -> dict:
    """``ClippedAdamW.state_dict()`` (moments float32, on the CPU) from
    optax's state of the chain for ``model`` (a ``CenterPointDetector``,
    ``Mono3D`` or ``Yolo2D``): the state after ``jax.device_get`` (fields
    read by name) or the tuple ``optimizer_state_to_optax`` returns."""
    _, (adam, _, schedule) = tree
    return dict(count=int(_field(adam, "count")), schedule_count=int(_field(schedule, "count")),
                mu=_params_from_flax(model, _field(adam, "mu")),
                nu=_params_from_flax(model, _field(adam, "nu")))


def optimizer_state_to_optax(state: dict, model: torch.nn.Module) -> tuple:
    """optax's state layout of ``ClippedAdamW.state_dict()`` for ``model``:
    ``({}, ({"count", "mu", "nu"}, {}, {"count"}))`` with numpy leaves,
    counts int32; the reference's state rebuilds from it by keyword:
    ``(EmptyState(), (ScaleByAdamState(**a), EmptyState(),
    ScaleByScheduleState(**s)))``."""
    adam = dict(count=np.int32(state["count"]), mu=_params_to_flax(model, state["mu"]),
                nu=_params_to_flax(model, state["nu"]))
    return ({}, (adam, {}, dict(count=np.int32(state["schedule_count"]))))
