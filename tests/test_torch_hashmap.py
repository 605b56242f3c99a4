"""Port parity: the raw-point voxel hash map and the plane fit of
lsd_tpu_torch against lsd_tpu on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, each with its reason:
- keys, coords, counts (and so the slot each voxel's first point took) and
  the stored points: equal (slot placement decides map parity; inserts
  copy points, they do not sum them);
- kNN neighbours: compared where ``valid`` only (rows with fewer than k
  candidates tie on inf and hold arbitrary points there), atol 1e-5;
- ``fit_planes``: ``ok`` equal, normals and offsets atol 1e-5 on 95 % of
  rows (1e-3 on all), on neighbours within ~1.5 m of the origin, where the
  float32 normal equations A n = -1 are well conditioned.  Far from the origin they are
  not (condition number ~6e4 at 20 m: the plane offset enters A^T A
  squared), and either package's float32 solve is ~1e-2 from the float64
  solution of the same system, each with its own LAPACK's rounding.  There
  ``ok`` is equal, normals agree within 5e-2, and the distance of the
  query to its plane, which is what the filter uses, within 1e-2 m with a
  median below 1e-4 m (ROADMAP queue C).  A float64 numpy fit of the same
  neighbours is the witness on every run: the reference itself is more
  than 1e-3 from it on 5 % of rows, and the port is no further from it
  than the reference is (median and 95th percentile within a quarter).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.ops import hashmap as jhash
from lsd_tpu.ops import planefit as jplane
from lsd_tpu_torch.ops import hashmap as thash
from lsd_tpu_torch.ops import planefit as tplane

CAP, K = 2 ** 13, 8


def _scan(seed, n=2048, spread=20.0, frac_masked=0.1):
    """Points on a ground plane and a wall, so voxels fill and planes fit."""
    rng = np.random.default_rng(seed)
    g = np.stack([rng.uniform(-spread, spread, n // 2), rng.uniform(-spread, spread, n // 2),
                  rng.normal(0, 0.01, n // 2)], 1)
    w = np.stack([rng.uniform(-spread, spread, n - n // 2), np.full(n - n // 2, 7.3)
                  + rng.normal(0, 0.01, n - n // 2), rng.uniform(0, 4, n - n // 2)], 1)
    pts = np.concatenate([g, w]).astype(np.float32)
    rng.shuffle(pts)
    mask = rng.random(n) > frac_masked
    return pts, mask


def _both_maps(voxel=0.5, scans=3, cap=CAP, spread=20.0):
    jm = jhash.hashmap_create(cap, K, voxel)
    tm = thash.hashmap_create(cap, K, voxel, device="cpu")
    for s in range(scans):
        pts, mask = _scan(s, spread=spread)
        jm = jhash.hashmap_insert(jm, jnp.asarray(pts), jnp.asarray(mask))
        tm = thash.hashmap_insert(tm, torch.as_tensor(pts), torch.as_tensor(mask))
    return jm, tm


def _assert_maps_equal(jm, tm):
    np.testing.assert_array_equal(tm.keys.numpy(), np.asarray(jm.keys))
    np.testing.assert_array_equal(tm.counts.numpy(), np.asarray(jm.counts))
    used = np.asarray(jm.keys) >= 0
    # rows of slots never written keep their zeros in both
    np.testing.assert_array_equal(tm.coords.numpy(), np.asarray(jm.coords))
    np.testing.assert_array_equal(tm.points.numpy(), np.asarray(jm.points))
    assert used.sum() > 100


@pytest.mark.parametrize("voxel,spread,cap", [(0.5, 20.0, CAP), (1.0, 20.0, CAP),
                                              (0.5, 6.0, CAP), (0.5, 20.0, 2 ** 11)])
def test_hashmap_insert_bit_exact(voxel, spread, cap):
    """Several scans into one map; the small spread fills voxels past K
    points, the small capacity crowds the table so probing goes deep and
    some voxels find no slot."""
    jm, tm = _both_maps(voxel, scans=3, cap=cap, spread=spread)
    _assert_maps_equal(jm, tm)


def test_hashmap_insert_all_masked_and_wrapping_coords():
    jm = jhash.hashmap_create(2 ** 10, K, 0.5)
    tm = thash.hashmap_create(2 ** 10, K, 0.5, device="cpu")
    pts, _ = _scan(5, n=256)
    none = np.zeros(256, bool)
    jm2 = jhash.hashmap_insert(jm, jnp.asarray(pts), jnp.asarray(none))
    tm2 = thash.hashmap_insert(tm, torch.as_tensor(pts), torch.as_tensor(none))
    assert int((tm2.keys >= 0).sum()) == 0
    np.testing.assert_array_equal(tm2.keys.numpy(), np.asarray(jm2.keys))
    # coords beyond +-1024 voxels make the reference's int32 sort key wrap
    far = (pts * 80.0).astype(np.float32)
    some = np.ones(256, bool)
    jm3 = jhash.hashmap_insert(jm, jnp.asarray(far), jnp.asarray(some))
    tm3 = thash.hashmap_insert(tm, torch.as_tensor(far), torch.as_tensor(some))
    assert float(np.abs(far).max()) / 0.5 > 2048
    np.testing.assert_array_equal(tm3.keys.numpy(), np.asarray(jm3.keys))
    np.testing.assert_array_equal(tm3.coords.numpy(), np.asarray(jm3.coords))
    np.testing.assert_array_equal(tm3.counts.numpy(), np.asarray(jm3.counts))
    np.testing.assert_array_equal(tm3.points.numpy(), np.asarray(jm3.points))


def test_hashmap_trim_bit_exact():
    jm, tm = _both_maps()
    c = np.asarray([3.0, -2.0, 0.5], np.float32)
    jt = jhash.hashmap_trim(jm, jnp.asarray(c), 8.0)
    tt = thash.hashmap_trim(tm, torch.as_tensor(c), 8.0)
    np.testing.assert_array_equal(tt.keys.numpy(), np.asarray(jt.keys))
    np.testing.assert_array_equal(tt.counts.numpy(), np.asarray(jt.counts))
    assert 0 < int((tt.keys >= 0).sum()) < int((tm.keys >= 0).sum())


@pytest.mark.parametrize("neighborhood", [7, 19, 27])
def test_neighbor_offsets_equal(neighborhood):
    np.testing.assert_array_equal(thash._neighbor_offsets(neighborhood),
                                  jhash._neighbor_offsets(neighborhood))


def test_neighbor_offsets_rejects_other_sizes():
    with pytest.raises(ValueError):
        thash._neighbor_offsets(9)


def _fit_planes_f64(neighbors, valid):
    """``fit_planes``' normal equations solved in float64: (normals, d)."""
    nb, w = neighbors.astype(np.float64), valid.astype(np.float64)
    AtA = np.einsum("nki,nkj,nk->nij", nb, nb, w) + 1e-4 * np.eye(3)
    n_raw = np.linalg.solve(AtA, -np.einsum("nki,nk->ni", nb, w)[..., None])[..., 0]
    norm = np.maximum(np.linalg.norm(n_raw, axis=-1), 1e-9)
    return n_raw / norm[:, None], 1.0 / norm


@pytest.mark.parametrize("neighborhood", [7, 19, 27])
def test_hashmap_knn_and_fit_planes_match(neighborhood):
    jm, tm = _both_maps()
    q, qmask = _scan(11, n=1024)
    jn, jv = jhash.hashmap_knn(jm, jnp.asarray(q), jnp.asarray(qmask), k=5,
                               neighborhood=neighborhood)
    tn, tv = thash.hashmap_knn(tm, torch.as_tensor(q), torch.as_tensor(qmask), k=5,
                               neighborhood=neighborhood)
    jv = np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert jv.sum() > 1000
    np.testing.assert_allclose(tn.numpy()[jv], np.asarray(jn)[jv], atol=1e-5)

    # the plane fit at map range: ill-conditioned in float32 (see the
    # module docstring).  What the filter uses is the query's distance to
    # its plane, and that agrees far better than (n, d) do
    jnrm, jd, jok = [np.asarray(a) for a in jplane.fit_planes(jn, jnp.asarray(jv), 0.1)]
    tnrm, td, tok = [a.numpy() for a in tplane.fit_planes(tn, tv, 0.1)]
    np.testing.assert_array_equal(tok, jok)
    assert jok.sum() > 200
    np.testing.assert_allclose(tnrm, jnrm, atol=5e-2)
    rj = np.einsum("ni,ni->n", q, jnrm) + jd
    rt = np.einsum("ni,ni->n", q, tnrm) + td
    np.testing.assert_allclose(rt, rj, atol=1e-2)
    assert np.median(np.abs(rt - rj)[jok]) < 1e-4

    # the witness: both float32 fits against the float64 fit of the same
    # neighbours, on the rows that pass.  The reference is itself far from it
    # (so no float32 solve can meet 1e-5 here), and the port is no further
    n64, d64 = _fit_planes_f64(tn.numpy(), tv.numpy())
    r64 = np.einsum("ni,ni->n", q.astype(np.float64), n64) + d64
    err = lambda nrm, d: np.maximum(np.abs(nrm - n64).max(1), np.abs(d - d64))[jok]
    ej, et = err(jnrm, jd), err(tnrm, td)
    assert np.percentile(ej, 95) > 1e-3
    assert np.median(et) <= 1.25 * np.median(ej)
    assert np.percentile(et, 95) <= 1.25 * np.percentile(ej, 95)
    rej, ret = np.abs(rj - r64)[jok], np.abs(rt - r64)[jok]
    assert np.median(ret) <= 1.25 * np.median(rej) and ret.max() <= 1e-2


def test_fit_planes_matches_where_well_conditioned():
    """Random planes through neighbours within ~1.5 m of the origin."""
    rng = np.random.default_rng(4)
    n = 2048
    normal = rng.normal(size=(n, 1, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    centre = normal * rng.uniform(0.5, 1.0, size=(n, 1, 1))
    off = rng.uniform(-0.5, 0.5, size=(n, 5, 3))
    off -= np.sum(off * normal, -1, keepdims=True) * normal       # in the plane
    noise = rng.normal(0, 0.01, size=(n, 5, 1)) * normal
    noise[: n // 8] *= 12.0                                         # some fail the inlier test
    nb = (centre + off + noise).astype(np.float32)
    valid = rng.random((n, 5)) > 0.15
    jnrm, jd, jok = jplane.fit_planes(jnp.asarray(nb), jnp.asarray(valid), 0.1)
    tnrm, td, tok = tplane.fit_planes(torch.as_tensor(nb), torch.as_tensor(valid), 0.1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    # 1e-5 on 95 % of rows; a row whose valid neighbours happen to lie
    # almost on a line is as ill-conditioned as a far one, hence 1e-3
    dn = np.abs(tnrm.numpy() - np.asarray(jnrm)).max(1)
    dd = np.abs(td.numpy() - np.asarray(jd))
    assert np.mean(np.maximum(dn, dd) <= 1e-5) >= 0.95
    assert dn.max() <= 1e-3 and dd.max() <= 1e-3
    # the rows past 1e-5 are the float32 solve's, not the port's: against the
    # float64 fit the port is no further off than the reference
    n64, d64 = _fit_planes_f64(nb, valid)
    ok = tok.numpy()
    err = lambda nrm, d: np.maximum(np.abs(np.asarray(nrm) - n64).max(1),
                                    np.abs(np.asarray(d) - d64))[ok]
    ej, et = err(jnrm, jd), err(tnrm.numpy(), td.numpy())
    assert np.median(et) <= 1.25 * np.median(ej)
    assert np.percentile(et, 99) <= 1.25 * np.percentile(ej, 99)
    assert 0.5 * n < int(tok.sum()) < n


def test_fit_planes_degenerate_rows_are_sanitized():
    """Too few neighbours, collinear neighbours and non-finite neighbours
    give ok = False and zero planes in both, with nothing raised."""
    nb = np.zeros((4, 5, 3), np.float32)
    nb[0] = [[1, 0, 0], [2, 0, 0], [3, 0, 0], [4, 0, 0], [5, 0, 0]]      # a line
    nb[1] = np.random.default_rng(0).normal(size=(5, 3))                  # no plane
    nb[2, :, 2] = 1.5                                                     # fewer than 3
    nb[2, :, :2] = np.random.default_rng(1).normal(size=(5, 2))
    nb[3] = np.inf
    valid = np.ones((4, 5), bool)
    valid[2, 2:] = False
    jn, jd, jok = jplane.fit_planes(jnp.asarray(nb), jnp.asarray(valid), 0.1)
    tn, td, tok = tplane.fit_planes(torch.as_tensor(nb), torch.as_tensor(valid), 0.1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert not tok.any()
    assert float(tn.abs().max()) == 0.0 and float(td.abs().max()) == 0.0
    assert bool(torch.isfinite(tn).all())


def test_point_to_plane_matches():
    rng = np.random.default_rng(3)
    p, n, d = rng.normal(size=(64, 3)), rng.normal(size=(64, 3)), rng.normal(size=64)
    f = lambda a: np.asarray(a, np.float32)
    np.testing.assert_allclose(
        tplane.point_to_plane(*[torch.as_tensor(f(a)) for a in (p, n, d)]).numpy(),
        np.asarray(jplane.point_to_plane(*[jnp.asarray(f(a)) for a in (p, n, d)])), atol=1e-5)


def test_hashmap_create_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        thash.hashmap_create(1000, device="cpu")
