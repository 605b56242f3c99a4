"""The LIO step's graph runner (``slam/lio_graph.py``) and the degeneracy
gate's plain twin, on the CPU.

``_gate_degenerate_plain`` is held against numpy's float64 ``eigh`` of the
same float32 block: with 0 to 3 pose eigenvalues under ``degen_thresh``,
the projection within 1e-5 (float32 eigenvectors of a block whose
eigenvalues lie at most 200 apart, split by a gap of 10 or more:
~1.2e-7 * 200 / 10) and the counts equal; with one eigenvalue a float32
step (9.5e-7) above or below the threshold in an exactly representable
block, the decision as numpy's.

``lio_step`` on CPU tensors runs the eager body.  The runner itself needs a
card to capture; here a stand-in for ``_Graph`` runs each segment's Python
again at each replay and copies the result into what the capture returned,
so the runner's static inputs, carried buffers, host decisions, fresh
outputs, keys and cache are exercised as on the card: its steps equal the
eager body's bitwise (the same operations in the same order), on either map,
with a plane re-search in every iteration and with a map trim on every scan.
"""
import numpy as np
import pytest
import torch

from lsd_tpu_torch.sim import CircleSim, SimConfig
from lsd_tpu_torch.slam import lio as L
from lsd_tpu_torch.slam import lio_graph
from lsd_tpu_torch.tools.profile_lio import nav_at_start


# ---- the degeneracy gate's plain twin ---------------------------------------

def _gate_reference(cfg, A32):
    """(Pi, n_degenerate, n_weak) from numpy's float64 eigh of the block."""
    A = A32.astype(np.float64)
    lam, V = np.linalg.eigh(A)
    keep = lam >= np.float32(cfg.degen_thresh)
    mu = np.linalg.eigvalsh(A[3:6, 3:6])
    return ((V * keep) @ V.T, int(6 - keep.sum()),
            int(np.sum(mu < np.float32(cfg.degen_rel_frac) * mu[-1])))


def _spd(lam, seed):
    Q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(6, 6)))
    return ((Q * lam) @ Q.T).astype(np.float32)


def _hth(A32):
    H = torch.zeros(24, 24)
    H[:6, :6] = torch.as_tensor(A32)
    H[6:, 6:] = torch.eye(18) * 3.0
    return H


@pytest.mark.parametrize("n_small", [0, 1, 2, 3])
def test_gate_plain_matches_float64_eigh(n_small):
    cfg = L.LioConfig()
    lam = np.array([0.5, 2.0, 4.5, 40.0, 120.0, 200.0])
    lam[n_small:3] = [60.0, 90.0, 150.0][n_small:3]
    for seed in range(3):
        A = _spd(lam, seed)
        E, nd, nw = L._gate_degenerate_plain(cfg, _hth(A))
        Pi, nd_ref, nw_ref = _gate_reference(cfg, A)
        assert int(nd) == nd_ref == n_small
        assert int(nw) == nw_ref
        assert float(np.abs(E[:6, :6].numpy() - Pi).max()) <= 1e-5
        rest = E.clone()
        rest[:6, :6] = torch.eye(6)
        assert torch.equal(rest, torch.eye(24))


@pytest.mark.parametrize("side", [-1, 1])
def test_gate_plain_decides_at_the_threshold_as_float64(side):
    """An eigenvalue one float32 step from ``degen_thresh`` on either side,
    in a permuted diagonal block (exact in float32)."""
    cfg = L.LioConfig()
    at = np.nextafter(np.float32(cfg.degen_thresh), np.float32(side * np.inf))
    assert abs(float(at) - cfg.degen_thresh) <= 1e-6
    lam = np.array([1.0, at, 30.0, 50.0, 70.0, 90.0], np.float32)
    perm = np.array([3, 0, 5, 1, 4, 2])
    A = np.zeros((6, 6), np.float32)
    A[perm, perm] = lam
    E, nd, nw = L._gate_degenerate_plain(cfg, _hth(A))
    Pi, nd_ref, nw_ref = _gate_reference(cfg, A)
    assert int(nd) == nd_ref == (2 if side < 0 else 1)
    assert int(nw) == nw_ref
    assert float(np.abs(E[:6, :6].numpy() - Pi).max()) <= 1e-6


# ---- the runner, with a stand-in for the capture ----------------------------

class _Replayed:
    """``lio_graph._Graph`` on the CPU: ``replay()`` runs the segment's
    Python again and writes the result into what the capture returned."""

    def __init__(self, fn, pool, stream):
        self.fn, self.out = fn, fn()

    def replay(self):
        _write(self.out, self.fn())


def _write(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _write(dst[k], src[k])
    elif isinstance(dst, tuple):
        for a, b in zip(dst, src):
            _write(a, b)


@pytest.fixture
def replayed(monkeypatch):
    monkeypatch.setattr(lio_graph, "_Graph", _Replayed)
    monkeypatch.setattr(lio_graph, "_runners", type(lio_graph._runners)())
    monkeypatch.setattr(lio_graph, "counters", dict.fromkeys(lio_graph.counters, 0))
    return lio_graph


N_SCANS = 7
SMALL = dict(ds_capacity=1024, map_capacity=2 ** 13)
CASES = {
    "surfel": SMALL,
    "points": dict(ds_capacity=2048, map_capacity=2 ** 13, map_type="points",
                   scan_voxel=0.1, map_voxel=1.5, map_points_per_voxel=16),
    "research_every_iteration": dict(SMALL, research_thresh=1e-9, max_iters=4),
    "trim_every_scan": dict(SMALL, recenter_thresh=0.05, map_radius=6.0),
}


@pytest.fixture(scope="module")
def drive():
    sim = CircleSim(SimConfig(n_scans=N_SCANS, points_per_scan=2048, point_noise=0.01, seed=5))
    scans = [tuple(torch.as_tensor(a) for a in d[:5])
             for d in sim.generate(capacity=2048, imu_capacity=16)]
    return nav_at_start(sim, "cpu"), scans


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    return [t for v in x for t in _leaves(v)]


def _run(step, cfg, nav0, scans):
    st, out = L.lio_init(cfg, nav0), []
    for scan in scans:
        st, info = step(cfg, st, *scan)
        out.append((st, info))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_runner_steps_equal_the_eager_body(replayed, drive, case, monkeypatch):
    cfg = L.LioConfig(**CASES[case])
    nav0, scans = drive
    matches = []
    match = L._match_planes
    monkeypatch.setattr(L, "_match_planes", lambda *a: matches.append(1) or match(*a))
    want = _run(L._lio_step_eager, cfg, nav0, scans)
    eager_matches, matches[:] = len(matches), []
    got = _run(replayed.step, cfg, nav0, scans)
    for k, ((st_g, info_g), (st_w, info_w)) in enumerate(zip(got, want)):
        for a, b in zip(_leaves((st_g, info_g)), _leaves((st_w, info_w))):
            assert torch.equal(a, b), f"scan {k}"
    assert replayed.counters == dict(captures=1, replays=N_SCANS - 1, eager=1,
                                     trims=(N_SCANS - 1 if case == "trim_every_scan" else 0))
    # the capture matches twice (front, re-search); each replayed re-search
    # matches once more, as the eager body does
    assert len(matches) == eager_matches + 2
    if case == "research_every_iteration":          # most iterations after the first
        assert eager_matches - N_SCANS > (cfg.max_iters - 1) * N_SCANS // 2


def test_lio_step_on_cpu_runs_the_eager_body(drive, monkeypatch):
    monkeypatch.setattr(lio_graph, "counters", dict.fromkeys(lio_graph.counters, 0))
    cfg = L.LioConfig(**SMALL)
    nav0, scans = drive
    got = _run(L.lio_step, cfg, nav0, scans[:3])
    want = _run(L._lio_step_eager, cfg, nav0, scans[:3])
    for a, b in zip(_leaves(got), _leaves(want)):
        assert torch.equal(a, b)
    assert lio_graph.counters == dict(captures=0, replays=0, eager=3, trims=0)


def test_runner_returns_fresh_state_and_leaves_its_input(replayed, drive):
    cfg = L.LioConfig(**SMALL)
    nav0, scans = drive
    st = L.lio_init(cfg, nav0)
    for scan in scans[:2]:                  # warm-up, capture
        st, _ = replayed.step(cfg, st, *scan)
    st_in = st
    before = [t.clone() for t in _leaves(st_in)]
    st_out, info = replayed.step(cfg, st_in, *scans[2])
    kept = [t.clone() for t in _leaves((st_out, info))]
    st = st_out
    for scan in scans[3:6]:
        st, _ = replayed.step(cfg, st, *scan)
    for a, b in zip(_leaves(st_in), before):
        assert torch.equal(a, b)
    for a, b in zip(_leaves((st_out, info)), kept):
        assert torch.equal(a, b)
    assert not torch.equal(st.nav.pos, st_out.nav.pos)


def test_runner_raises_when_a_capture_fails(replayed, drive, monkeypatch):
    class Refused(_Replayed):
        def __init__(self, fn, pool, stream):
            raise RuntimeError("operation not permitted when stream is capturing")

    cfg = L.LioConfig(**SMALL)
    nav0, scans = drive
    st, _ = replayed.step(cfg, L.lio_init(cfg, nav0), *scans[0])
    monkeypatch.setattr(lio_graph, "_Graph", Refused)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            replayed.step(cfg, st, *scans[1])
    assert replayed.counters == dict(captures=0, replays=0, eager=1, trims=0)


def test_runner_key_reads_each_field(drive):
    nav0, scans = drive
    cfg = L.LioConfig(**SMALL)
    st = L.lio_init(cfg, nav0)
    scan = scans[0]
    base = lio_graph._key(cfg, st, scan, None, None)
    assert lio_graph._key(cfg, st, tuple(t.clone() for t in scan), None, None) == base
    shorter = (scan[0][:1000], scan[1][:1000], scan[2][:1000], *scan[3:])
    points_st = L.lio_init(L.LioConfig(**CASES["points"]), nav0)
    other = [
        lio_graph._key(cfg._replace(max_iters=2), st, scan, None, None),
        lio_graph._key(cfg, st, shorter, None, None),
        lio_graph._key(cfg, st, (*scan[:3], scan[3][:8], scan[4][:8]), None, None),
        lio_graph._key(cfg, st, (scan[0].double(), *scan[1:]), None, None),
        lio_graph._key(cfg, L.lio_init(cfg._replace(map_capacity=2 ** 12), nav0), scan,
                       None, None),
        lio_graph._key(cfg, points_st, scan, None, None),
        lio_graph._key(cfg, st, scan, torch.zeros(3), None),
        lio_graph._key(cfg, st, scan, torch.zeros(3), torch.ones((), dtype=torch.bool)),
        lio_graph._key(cfg, st._replace(P=st.P.to("meta")), scan, None, None),
    ]
    torch.use_deterministic_algorithms(True)
    try:
        other.append(lio_graph._key(cfg, st, scan, None, None))
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(set(other)) == len(other) and base not in other


def test_runner_cache_is_bounded(replayed, drive):
    nav0, scans = drive
    for k in range(lio_graph.MAX_KEYS + 3):
        cfg = L.LioConfig(**SMALL)._replace(max_iters=1 + k % 2, plane_thresh=0.1 + 0.01 * k)
        st = L.lio_init(cfg, nav0)
        for scan in scans[:2]:
            st, _ = replayed.step(cfg, st, *scan)
        assert len(replayed._runners) == min(k + 1, lio_graph.MAX_KEYS)
    assert replayed.counters["captures"] == lio_graph.MAX_KEYS + 3


SYNCS = ("aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
         "aten::unique_consecutive", "aten::_unique2")


@pytest.mark.parametrize("case", ["surfel", "points"])
def test_segments_make_no_host_sync_or_upload(replayed, drive, case, monkeypatch):
    """What a CUDA graph cannot hold: no operator of a captured segment
    reads a value back to the host or makes a tensor from host arrays, and
    no index is a mask (a hidden ``nonzero``).  A Python number assigned
    into a slice is lifted to a 0-d tensor here and filled on the card:
    it stays."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func._schema.name
            masks = [a for a in (args[1] if name.startswith("aten::index") and len(args) > 1
                                 and isinstance(args[1], (list, tuple)) else ())
                     if isinstance(a, torch.Tensor) and a.dtype == torch.bool]
            upload = name == "aten::lift_fresh" and args[0].dim() > 0
            if name in SYNCS or masks or upload:
                seen.append(name)
            return func(*args, **(kwargs or {}))

    class Captured(_Replayed):
        def __init__(self, fn, pool, stream):
            with Watch():
                super().__init__(fn, pool, stream)

    monkeypatch.setattr(lio_graph, "_Graph", Captured)
    cfg = L.LioConfig(**CASES[case])._replace(research_thresh=1e-9, recenter_thresh=0.05)
    nav0, scans = drive
    _run(replayed.step, cfg, nav0, scans[:3])
    assert replayed.counters["captures"] == 1
    assert seen == []
