"""Port parity: the NDT half of ``slam/registration.py``.

``ndt_build`` and ``ndt_align`` of ``lsd_tpu_torch`` on the CPU against
``lsd_tpu``'s on the same simulated scan.  Tolerances:
- ``ndt_build``: ``keys``, ``counts`` and every point's slot equal;
  ``mean`` atol 1e-5 (a float sum in another order; measured 0);
  ``cov_inv`` relative 1e-3 of each voxel's largest entry (the covariance
  ``s2/n - mean mean^T`` cancels in float32 and the eigen-decompositions
  differ; measured 1.5e-6 on the CPU), and through what it is used for: the
  squared Mahalanobis distance of test points within rtol 1e-3;
- ``ndt_align``: ``q`` and ``t`` atol 1e-3 after 50 exact iterations from a
  0.5 m offset (measured 1.2e-4), 1e-5 on the tracking settings;
  ``matched_frac`` within 2 points of the scan; ``score`` rtol 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.geometry import so3 as jso3
from lsd_tpu.sim import CircleSim, SimConfig
from lsd_tpu.slam import registration as J
from lsd_tpu_torch import convert
from lsd_tpu_torch.slam import registration as T

CAP = 8192


@pytest.fixture(scope="module")
def scan():
    sim = CircleSim(SimConfig(n_scans=2, points_per_scan=CAP, seed=11))
    pts, _ = sim.scan(0.0)
    P = np.zeros((CAP, 3), np.float32)
    M = np.zeros(CAP, bool)
    n = min(len(pts), CAP)
    P[:n], M[:n] = pts[:n, :3], True
    M[::7] = False                      # masked points must claim nothing
    return P, M


def _build(scan, voxel, cap):
    P, M = scan
    jm = J.ndt_build(jnp.asarray(P), jnp.asarray(M), voxel_size=voxel, capacity=cap)
    tm = T.ndt_build(torch.tensor(P), torch.tensor(M), voxel, cap)
    return jm, tm


def _ref_slots(P, voxel, cap):
    """Every point's slot in the reference's table: its voxel's probe
    sequence, read back from the reference's keys before the count gate."""
    from lsd_tpu.ops.hashmap import _content_key, _slot_hash
    coords = jnp.floor(jnp.asarray(P) / voxel).astype(jnp.int32)
    h0, ck = np.asarray(_slot_hash(coords, cap)), np.asarray(_content_key(coords))
    return h0, ck


# the crowded table (1,024 slots for ~2,200 voxels) makes points lose their
# claim rounds and end without a slot, in both packages alike
@pytest.mark.parametrize("voxel,cap,min_occupied", [(1.5, 2 ** 14, 500), (1.0, 2 ** 14, 300),
                                                    (1.0, 2 ** 10, 100)])
def test_build_keys_counts_and_slots_equal(scan, voxel, cap, min_occupied):
    P, M = scan
    jm, tm = _build(scan, voxel, cap)
    np.testing.assert_array_equal(tm.keys.numpy(), np.asarray(jm.keys))
    np.testing.assert_array_equal(tm.counts.numpy(), np.asarray(jm.counts))
    assert int((tm.keys >= 0).sum()) > min_occupied
    assert tm.keys.dtype == torch.int32 and tm.counts.dtype == torch.int32
    assert float(tm.voxel_size) == float(jm.voxel_size) and tm.capacity == cap
    # slots: the port's, before the count gate, against the reference's
    # table rebuilt the same way
    keys, slot = T._ndt_slots(torch.tensor(P), torch.tensor(M),
                              torch.tensor(voxel, dtype=torch.float32), cap)
    h0, ck = _ref_slots(P, voxel, cap)
    slot = slot.numpy()
    placed = slot >= 0
    assert not placed[~M].any()
    assert (keys.numpy()[slot[placed]] == ck[placed]).all()
    assert (((slot[placed] - h0[placed]) % cap) < 8).all()
    # the counts are the slots' histogram, and they equal the reference's
    hist = np.bincount(slot[placed], minlength=cap)
    np.testing.assert_array_equal(hist, np.asarray(jm.counts))
    if cap == 2 ** 10:
        assert (M & ~placed).sum() > 100          # the crowded case drops points
    else:
        assert placed[M].all()


@pytest.mark.parametrize("voxel,cap", [(1.5, 2 ** 14), (1.0, 2 ** 14)])
def test_build_mean_and_cov_inv(scan, voxel, cap):
    jm, tm = _build(scan, voxel, cap)
    sel = np.asarray(jm.counts) > 0
    np.testing.assert_allclose(tm.mean.numpy(), np.asarray(jm.mean), rtol=0, atol=1e-5)
    a, b = np.asarray(jm.cov_inv)[sel], tm.cov_inv.numpy()[sel]
    rel = np.abs(a - b).max(axis=(1, 2)) / np.abs(a).max(axis=(1, 2))
    assert rel.max() < 1e-3, rel.max()
    # through its use: squared Mahalanobis distances of points near the means
    rng = np.random.default_rng(0)
    d = rng.normal(0, 0.3, (int(sel.sum()), 3)).astype(np.float32)
    md_j = np.einsum("ni,nij,nj->n", d, a, d)
    md_t = np.einsum("ni,nij,nj->n", d, b, d)
    np.testing.assert_allclose(md_t, md_j, rtol=1e-3)
    # the eigenvalue floor (0.1 voxel)^2 bounds the inverse covariance
    assert np.abs(b).max() <= 1.0 / (0.1 * voxel) ** 2 * (1 + 1e-4)
    # symmetric, and empty voxels carry the floor's inverse on the diagonal
    np.testing.assert_allclose(b, b.transpose(0, 2, 1), atol=1e-2)
    empty = tm.cov_inv.numpy()[~sel]
    np.testing.assert_allclose(empty, np.broadcast_to(np.eye(3) / (0.1 * voxel) ** 2, empty.shape),
                               rtol=1e-5)


def _perturbed(scan, scale=1.0):
    P, _ = scan
    dq = jso3.quat_from_rotvec(jnp.asarray([0, 0, 0.04 * scale]))
    dt = jnp.asarray([0.4, -0.3, 0.05]) * scale
    src = np.asarray(jso3.quat_rotate(jso3.quat_conj(dq)[None], jnp.asarray(P) - dt))
    return src, np.asarray(dq), np.asarray(dt)


def _align_both(jm, tm, src, M, **kw):
    jq, jt, ji = J.ndt_align(jm, jnp.asarray(src), jnp.asarray(M),
                             jnp.asarray([1.0, 0, 0, 0]), jnp.zeros(3), **kw)
    tq, tt, ti = T.ndt_align(tm, torch.tensor(src), torch.tensor(M),
                             torch.tensor([1.0, 0, 0, 0]), torch.zeros(3), **kw)
    return (np.asarray(jq), np.asarray(jt), ji), (tq.numpy(), tt.numpy(), ti)


def test_align_recovers_the_perturbation_and_matches(scan):
    """The reference's own test: 0.4 m / -0.3 m / 0.04 rad off, 50 exact
    iterations on a 1.5 m map; the closed-form Jacobian against the
    reference's forward-mode one, through the function's outputs."""
    _, M = scan
    jm, tm = _build(scan, 1.5, 2 ** 14)
    src, dq, dt = _perturbed(scan)
    (jq, jt, ji), (tq, tt, ti) = _align_both(jm, tm, src, M, iters=50)
    assert np.linalg.norm(tt - dt) < 0.1 and 1 - abs(float(tq @ dq)) < 1e-3
    assert float(ti["matched_frac"]) > 0.5
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-3)
    assert abs(float(ti["matched_frac"]) - float(ji["matched_frac"])) <= 2.0 / M.sum()
    np.testing.assert_allclose(float(ti["score"]), float(ji["score"]), rtol=1e-3)
    np.testing.assert_allclose(float(ti["last_delta"]), float(ji["last_delta"]), atol=1e-3)


@pytest.mark.parametrize("kw", [dict(iters=15, searches=4), dict(iters=15, searches=15),
                                dict(iters=6, searches=1), dict(iters=4, searches=9)])
def test_align_on_the_tracking_settings_matches(scan, kw):
    """``searches`` below, at and above ``iters``; the frozen association
    between searches."""
    _, M = scan
    jm, tm = _build(scan, 1.0, 2 ** 14)
    src, _, dt = _perturbed(scan, scale=0.4)          # a tracking-sized offset
    (jq, jt, ji), (tq, tt, ti) = _align_both(jm, tm, src, M, **kw)
    assert np.linalg.norm(tt - dt) < np.linalg.norm(dt)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-5)
    assert abs(float(ti["matched_frac"]) - float(ji["matched_frac"])) <= 2.0 / M.sum()
    np.testing.assert_allclose(float(ti["last_delta"]), float(ji["last_delta"]), atol=1e-5)
    assert tq.dtype == np.float32 and set(ti) == set(ji)


def test_align_on_an_empty_map_and_an_all_masked_scan_stays_finite(scan):
    P, M = scan
    jm, tm = _build((P, np.zeros_like(M)), 1.0, 2 ** 12)
    assert int((tm.keys >= 0).sum()) == 0 == int((np.asarray(jm.keys) >= 0).sum())
    q, t, info = T.ndt_align(tm, torch.tensor(P), torch.tensor(M),
                             torch.tensor([1.0, 0, 0, 0]), torch.zeros(3), iters=3)
    assert torch.equal(q, torch.tensor([1.0, 0, 0, 0])) and float(t.abs().max()) == 0.0
    assert float(info["matched_frac"]) == pytest.approx(1.0 / M.sum())   # the reference's floor
    _, tm = _build(scan, 1.0, 2 ** 14)
    q, t, info = T.ndt_align(tm, torch.tensor(P), torch.zeros(CAP, dtype=torch.bool),
                             torch.tensor([1.0, 0, 0, 0]), torch.zeros(3), iters=3)
    assert torch.isfinite(q).all() and float(t.abs().max()) == 0.0


def test_map_round_trips_through_convert(scan):
    """The port aligns on the reference's map, and the reference on the
    port's, as on their own."""
    _, M = scan
    jm, tm = _build(scan, 1.5, 2 ** 14)
    src, _, _ = _perturbed(scan)
    from_jax = convert.ndt_map_from_numpy(jax.device_get(jm), device="cpu")
    for a, b in zip(from_jax, tm):
        assert a.dtype == b.dtype and a.shape == b.shape
    to_jax = J.NdtMap(**{k: jnp.asarray(v) for k, v in convert.ndt_map_to_numpy(tm).items()})
    kw = dict(iters=15, searches=4)
    (jq, jt, _), (tq, tt, _) = _align_both(to_jax, from_jax, src, M, **kw)
    (jq0, jt0, _), (tq0, tt0, _) = _align_both(jm, tm, src, M, **kw)
    for a, b in ((tq, tq0), (tt, tt0), (jq, jq0), (jt, jt0)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_eigh_sym3_against_float64():
    """The Jacobi eigen-solver behind ``ndt_build``: random, planar, zero and
    already-diagonal symmetric 3x3 matrices.  Eigenvalues within 1e-6 of the
    largest one of the float64 decomposition, V orthonormal within 2e-6, and
    V diag(lam) V^T back at the matrix within 1e-6 of its norm."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(5000, 3, 3))
    a = a @ a.transpose(0, 2, 1) * rng.uniform(1e-4, 1, (5000, 1, 1))
    a[::5, :, 2] *= 1e-3
    a[::5, 2, :] *= 1e-3                                  # thin in one direction
    a[1::7] = 0.0                                         # empty voxels
    a[2::11] = np.diag([0.3, 0.3, 0.01])                  # equal diagonal entries, no rotation needed
    a[3::13] = np.asarray([[0.2, 0.1, 0.0], [0.1, 0.2, 0.0], [0.0, 0.0, 0.05]])   # tau = 0
    a = (0.5 * (a + a.transpose(0, 2, 1))).astype(np.float32)
    lam, V = T._eigh_sym3(torch.tensor(a))
    ref = np.linalg.eigvalsh(a.astype(np.float64))
    scale = np.maximum(np.abs(ref).max(axis=1, keepdims=True), 1e-12)
    assert (np.abs(np.sort(lam.numpy(), axis=1) - ref) / scale).max() < 1e-6
    eye = torch.eye(3).expand(5000, 3, 3)
    assert float((V.transpose(-1, -2) @ V - eye).abs().max()) < 2e-6
    rec = (V * lam[:, None, :]) @ V.transpose(-1, -2)
    assert float(((rec - torch.tensor(a)).abs().amax(dim=(1, 2)) / torch.tensor(scale[:, 0])).max()) < 2e-6
    assert torch.isfinite(lam).all() and torch.isfinite(V).all()
