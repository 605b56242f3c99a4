"""Rank groups for the port's multi-device programs (counterpart of
``lsd_tpu/parallel/mesh.py``).

The reference's mesh is one process driving many devices, and its
programs are ``shard_map``s whose ``psum``s XLA lowers to collectives.
Here a mesh is one process per device in a ``torch.distributed`` group:
each rank runs the same program once (SPMD) and ``psum`` is an
``all_reduce`` over the group.  The collectives always go through the
group, at world size 1 too.

- ``Mesh``: the calling rank's view of the group (axis name, rank, size,
  group, device);
- ``make_mesh``: the mesh over an initialised group;
- ``run_ranks``: the launcher, the port's counterpart of
  ``jax.devices()[:n]``.  It spawns one process per rank, starts the group
  in each (NCCL on cards, one card per rank; gloo on the CPU), runs a
  function there and returns the ranks' results.  Every wait has a
  deadline, and when one rank fails the others are killed and its
  traceback is raised;
- ``single_rank``: a world-size-1 group in the calling process;
- ``broadcast_object`` and ``check_replicated``: for programs whose
  ranks must start from the same inputs (one process builds them, or every
  rank checks that it holds what the others do).
"""
from __future__ import annotations

import contextlib
import datetime
import hashlib
import multiprocessing as mp
import queue as queue_mod
import time
import traceback
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import DeviceLike

HOST = "127.0.0.1"
# after a rank fails, how long the launcher still collects the failures of
# the others (a peer of a dead rank fails in its next collective)
_GRACE_S = 2.0


class Mesh(NamedTuple):
    axis: str               # the reference's mesh axis name ("dp")
    rank: int               # this process's rank in ``group``; -1 outside it
    size: int               # ranks in ``group``
    group: Any              # the torch.distributed process group
    device: torch.device    # where this rank's tensors live


def _default_device(backend: str) -> torch.device:
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              device: DeviceLike = None) -> Mesh:
    """The mesh over the first ``n_devices`` ranks (default: all) of the
    initialised default group.  Every rank of the default group must call
    it: a sub-group is made collectively, and a rank outside it gets
    ``rank == -1``.  ``device`` defaults to this rank's card under NCCL
    and to the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no torch.distributed group is initialised "
                           "(start the ranks with run_ranks or single_rank)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: {n} devices asked for, the group has {world} ranks")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank() if dist.get_rank() < n else -1
    dev = torch.device(device) if device is not None else _default_device(dist.get_backend())
    return Mesh(axis=axis, rank=rank, size=n, group=group, device=dev)


def rank_rows(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous share of ``n`` rows (the reference's
    ``P(axis)`` split); ``n`` must divide evenly."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split evenly over {mesh.size} ranks")
    n_loc = n // mesh.size
    return slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)


def psum(mesh: Mesh, *tensors: torch.Tensor):
    """Sum each of ``tensors`` (one dtype, on ``mesh.device``) over the
    mesh's ranks through one ``all_reduce``; returns the sums in order."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    parts = flat.split([t.numel() for t in tensors])
    return tuple(p.view(t.shape) for p, t in zip(parts, tensors))


def broadcast_object(mesh: Mesh, obj: Any) -> Any:
    """Rank 0's ``obj`` (pickled) on every rank of the mesh; the other
    ranks pass anything.  The mesh's ranks are the first ``mesh.size`` of
    the default group, so its rank 0 is global rank 0."""
    box = [obj if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


def check_replicated(mesh: Mesh, what: str, tree) -> None:
    """Raise on every rank unless all ranks of the mesh hold the same
    tensors in ``tree`` (nested tuples), by shape, dtype and bytes: one
    ``all_reduce`` (MAX) of a digest and its negation.  An SPMD program
    whose ranks disagree on an input would otherwise hang in a collective
    of mismatched size, or sum partials of different problems."""
    h = hashlib.blake2b(digest_size=7)
    for t in _tensors(tree):
        a = t.detach().cpu().contiguous().numpy()
        h.update(repr((str(a.dtype), a.shape)).encode())
        h.update(a.tobytes())
    d = int.from_bytes(h.digest(), "little")
    x = torch.tensor([d, -d], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group)
    if int(x[0]) != -int(x[1]):
        raise ValueError(f"{what}: the {mesh.size} ranks hold different inputs")


def _init_group(backend: str, store, rank: int, world_size: int, timeout_s: float) -> None:
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)


@contextlib.contextmanager
def single_rank(backend: str = "nccl", device: DeviceLike = None, timeout_s: float = 60.0):
    """A group of one rank in this process, for the length of the ``with``;
    yields its mesh.  NCCL (the default) runs it on card 0."""
    store = dist.TCPStore(HOST, 0, is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    _init_group(backend, store, 0, 1, timeout_s)
    try:
        yield make_mesh(device=device)
    finally:
        dist.destroy_process_group()


def _rank_main(fn, rank, world_size, backend, port, args, results, init_timeout_s,
               timeout_s, threads):
    """Body of one spawned rank: start the group, run ``fn(mesh, *args)``,
    post (rank, "up"), then (rank, "ok", result) or (rank, "error", traceback)."""
    try:
        torch.set_num_threads(threads)
        store = dist.TCPStore(HOST, port, is_master=False,
                              timeout=datetime.timedelta(seconds=init_timeout_s))
        _init_group(backend, store, rank, world_size, timeout_s)
        results.put((rank, "up", None))
        out = fn(make_mesh(), *args)
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


def run_ranks(fn: Callable, world_size: int, args: Sequence = (), backend: str = "nccl",
              init_timeout_s: float = 60.0, timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world_size`` new processes, one rank
    each, and return their results in rank order.

    ``fn`` and ``args`` go to the ranks by pickle (``fn`` by its import
    path: define it at the top level of a module that the ranks may
    import), and so do the results: return numpy arrays or plain values.
    NCCL puts rank r on card r and needs that many cards; gloo runs the
    ranks on the CPU unless ``fn`` places its tensors elsewhere.

    Every rank must have started its group within ``init_timeout_s`` of the
    start, and all must have returned within ``timeout_s`` (also the
    group's own timeout for a collective).  When a rank raises or dies, or
    a deadline passes, the ranks still running are killed and the error is
    raised here, with the failing rank's traceback.

    The ranks split this process's torch intra-op threads, not the
    machine's cores: ``max(1, torch.get_num_threads() // world_size)``
    each.  At torch's default that is the cores; a process given fewer
    keeps its ranks within them."""
    if world_size < 1:
        raise ValueError(f"run_ranks: world size {world_size}")
    if backend == "nccl" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"run_ranks: {world_size} NCCL ranks need {world_size} cards, "
                           f"this host has {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = dist.TCPStore(HOST, 0, is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=init_timeout_s))
    threads = max(1, torch.get_num_threads() // world_size)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, store.port, tuple(args), results,
                               init_timeout_s, timeout_s, threads))
             for r in range(world_size)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    up, done, failed, gone = set(), {}, {}, {}
    first_failure = None
    try:
        while len(done) + len(failed) < world_size:
            now = time.monotonic()
            if first_failure is not None and now - first_failure > _GRACE_S:
                break
            try:
                rank, kind, payload = results.get(timeout=0.2)
            except queue_mod.Empty:
                if first_failure is None and len(up) < world_size and now - t0 > init_timeout_s:
                    raise TimeoutError(
                        f"run_ranks: ranks {sorted(set(range(world_size)) - up)} did not "
                        f"start their {backend} group within {init_timeout_s:.0f} s") from None
                if first_failure is None and now - t0 > timeout_s:
                    raise TimeoutError(
                        f"run_ranks: ranks {sorted(set(range(world_size)) - set(done))} did "
                        f"not finish within {timeout_s:.0f} s") from None
                for r, p in enumerate(procs):
                    if r in done or r in failed or p.exitcode is None:
                        continue
                    # what a rank posted before it exited may still be in
                    # the pipe: it counts as gone a moment later
                    gone.setdefault(r, now)
                    if now - gone[r] > 1.0:
                        failed[r] = f"exited with code {p.exitcode} without a result"
                        first_failure = first_failure or now
                continue
            if kind == "error":
                failed[rank] = payload
                first_failure = first_failure or time.monotonic()
            elif kind == "up":
                up.add(rank)
            else:
                done[rank] = payload
        if failed:
            raise RuntimeError(f"run_ranks: {len(failed)} of {world_size} ranks failed\n" + "".join(
                f"--- rank {r} of {world_size}: {failed[r]}\n" for r in sorted(failed)))
        for p in procs:
            p.join(timeout=30)
        return [done[r] for r in range(world_size)]
    finally:
        _stop(procs)
        results.close()
        del store
