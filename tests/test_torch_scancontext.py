"""Port parity: ScanContext descriptors, database and query of
lsd_tpu_torch against lsd_tpu on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, each with its reason:
- descriptor: within 1e-5 in at least 99.5 % of cells (``atan2`` and
  ``sqrt`` may differ by an ulp between the two libraries, which moves a
  point on a ring or sector edge into the next cell); ring keys atol 0.02
  (one moved cell of 60 changes a ring's occupancy mean by 1/60);
- database after adds: the same descriptors in the same slots, count and
  mask equal;
- ``sc_query`` on one database carried across by ``convert.py``: same
  index and shift (yaw is the shift times 6 degrees), distance atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.slam import scancontext as jsc
from lsd_tpu_torch import convert
from lsd_tpu_torch.slam import scancontext as tsc


def _cloud(seed, n=2048, yaw=0.0, shift=(0.0, 0.0)):
    """A place: ground plus a few walls, seen at a yaw and an offset."""
    rng = np.random.default_rng(seed)
    g = np.stack([rng.uniform(-60, 60, n // 2), rng.uniform(-60, 60, n // 2),
                  rng.normal(-1.8, 0.02, n // 2)], 1)
    walls = []
    for _ in range(6):
        c = rng.uniform(-40, 40, 2)
        a = rng.uniform(0, np.pi)
        u = rng.uniform(-6, 6, n // 12)
        walls.append(np.stack([c[0] + u * np.cos(a), c[1] + u * np.sin(a),
                               rng.uniform(-1.8, rng.uniform(1, 6), n // 12)], 1))
    pts = np.concatenate([g] + walls)
    pts = np.concatenate([pts, np.zeros((n - len(pts), 3))])
    pts[:, :2] -= shift
    c, s = np.cos(-yaw), np.sin(-yaw)
    pts[:, :2] = pts[:, :2] @ np.array([[c, -s], [s, c]]).T
    mask = np.arange(n) < n - 100
    return pts.astype(np.float32), mask


def _desc_pair(seed, **kw):
    pts, mask = _cloud(seed, **kw)
    return (jsc.make_descriptor(jnp.asarray(pts), jnp.asarray(mask)),
            tsc.make_descriptor(torch.as_tensor(pts), torch.as_tensor(mask)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_descriptor_and_ring_key_match(seed):
    jd, td = _desc_pair(seed, yaw=0.3 * seed)
    jd, tdn = np.asarray(jd), td.numpy()
    assert tdn.shape == (tsc.NUM_RING, tsc.NUM_SECTOR) == jd.shape
    assert (jd > 0).mean() > 0.3
    assert np.mean(np.abs(jd - tdn) <= 1e-5) >= 0.995
    np.testing.assert_allclose(tsc.ring_key(td).numpy(), np.asarray(jsc.ring_key(jnp.asarray(jd))),
                               atol=0.02)
    # the ring key itself, on one descriptor, is exact arithmetic
    np.testing.assert_allclose(tsc.ring_key(torch.as_tensor(jd)).numpy(),
                               np.asarray(jsc.ring_key(jnp.asarray(jd))), atol=1e-7)


def test_descriptor_masks_far_points_and_negative_heights():
    pts = np.array([[100.0, 0, 5], [10.0, 0, -3.0], [0, 10.0, 1.0], [5, 5, 2.0]], np.float32)
    mask = np.array([True, True, True, False])
    jd = np.asarray(jsc.make_descriptor(jnp.asarray(pts), jnp.asarray(mask)))
    td = tsc.make_descriptor(torch.as_tensor(pts), torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(td, jd, atol=1e-6)
    assert (td > 0).sum() == 1 and td.max() == pytest.approx(3.0)


def _filled_dbs(n=24, capacity=32):
    jdb = jsc.sc_db_create(capacity)
    tdb = tsc.sc_db_create(capacity, device="cpu")
    descs = []
    for k in range(n):
        d = np.asarray(_desc_pair(100 + k)[0])
        descs.append(d)
        jdb = jsc.sc_db_add(jdb, jnp.asarray(d))
        tdb = tsc.sc_db_add(tdb, torch.as_tensor(d))
    return jdb, tdb, descs


def _assert_db_equal(jdb, tdb):
    np.testing.assert_array_equal(tdb.desc.numpy(), np.asarray(jdb.desc))
    np.testing.assert_allclose(tdb.ring_key.numpy(), np.asarray(jdb.ring_key), atol=1e-7)
    np.testing.assert_array_equal(tdb.mask.numpy(), np.asarray(jdb.mask))
    assert int(tdb.count) == int(jdb.count)


def test_db_add_and_wraparound_match():
    jdb, tdb, _ = _filled_dbs(n=24, capacity=32)
    _assert_db_equal(jdb, tdb)
    assert int(tdb.mask.sum()) == 24
    jdb, tdb, _ = _filled_dbs(n=11, capacity=8)      # wraps: slot = count % capacity
    _assert_db_equal(jdb, tdb)
    assert int(tdb.count) == 11 and bool(tdb.mask.all())


def test_db_add_batch_matches():
    _, _, descs = _filled_dbs(n=10)
    stack = np.stack(descs)
    mask = np.array([1, 1, 0, 1, 0, 0, 1, 1, 1, 0], bool)
    jdb = jsc.sc_db_add_batch(jsc.sc_db_create(16), jnp.asarray(stack), jnp.asarray(mask))
    tdb = tsc.sc_db_add_batch(tsc.sc_db_create(16, device="cpu"), torch.as_tensor(stack),
                              torch.as_tensor(mask))
    _assert_db_equal(jdb, tdb)
    np.testing.assert_array_equal(tdb.desc[2].numpy(), stack[3])
    # a second batch appends behind the first
    jdb = jsc.sc_db_add_batch(jdb, jnp.asarray(stack), jnp.asarray(mask))
    tdb = tsc.sc_db_add_batch(tdb, torch.as_tensor(stack), torch.as_tensor(mask))
    _assert_db_equal(jdb, tdb)
    assert int(tdb.count) == 12


def test_db_carried_across_by_convert():
    jdb, tdb, _ = _filled_dbs(n=5, capacity=8)
    got = convert.sc_db_from_numpy(jax.device_get(jdb), "cpu")
    for a, b in zip(got, tdb):                       # ring keys: a mean, to an ulp
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7, rtol=0)
    back = jsc.ScanContextDB(**{k: jnp.asarray(v) for k, v in convert.sc_db_to_numpy(got).items()})
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jdb)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("revisit,yaw", [(103, 0.0), (107, 0.7), (110, -1.3), (115, 2.9)])
def test_query_finds_the_revisited_place(revisit, yaw):
    jdb, _, _ = _filled_dbs(n=24)
    tdb = convert.sc_db_from_numpy(jax.device_get(jdb), "cpu")
    pts, mask = _cloud(revisit, yaw=yaw, shift=(0.4, -0.3))
    q = np.asarray(jsc.make_descriptor(jnp.asarray(pts), jnp.asarray(mask)))
    ji, jdist, jyaw = jsc.sc_query(jdb, jnp.asarray(q), num_candidates=10, exclude_recent=5)
    ti, tdist, tyaw = tsc.sc_query(tdb, torch.as_tensor(q), num_candidates=10, exclude_recent=5)
    assert int(ti) == int(ji) == revisit - 100
    assert float(tdist) == pytest.approx(float(jdist), abs=1e-4)
    assert float(tdist) < 0.3
    step = 2 * np.pi / tsc.NUM_SECTOR
    assert round(float(tyaw) / step) == round(float(jyaw) / step)       # same shift
    assert float(tyaw) == pytest.approx(float(jyaw), abs=1e-5)


def test_query_excludes_recent_and_empty_db_gives_minus_one():
    jdb, tdb, descs = _filled_dbs(n=8)
    # every entry is recent: no candidate qualifies
    q = descs[7]
    for recent, want in ((50, -1), (0, 7)):
        ji, jdist, _ = jsc.sc_query(jdb, jnp.asarray(q), exclude_recent=recent)
        ti, tdist, _ = tsc.sc_query(tdb, torch.as_tensor(q), exclude_recent=recent)
        assert int(ti) == int(ji) == want
        assert np.isinf(float(tdist)) == np.isinf(float(jdist)) == (want < 0)
    ti, tdist, tyaw = tsc.sc_query(tsc.sc_db_create(8, device="cpu"), torch.as_tensor(q))
    assert int(ti) == -1 and np.isinf(float(tdist))


def test_shifted_distance_single_and_batched_match():
    _, _, descs = _filled_dbs(n=6)
    q = descs[0]
    d = np.stack(descs[1:])
    jd, js = jsc._shifted_distance(jnp.asarray(q), jnp.asarray(d))
    td, ts = tsc._shifted_distance(torch.as_tensor(q), torch.as_tensor(d))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd1, js1 = jsc._shifted_distance(jnp.asarray(q), jnp.asarray(np.roll(q, 7, axis=-1)))
    td1, ts1 = tsc._shifted_distance(torch.as_tensor(q), torch.as_tensor(np.roll(q, 7, axis=-1)))
    assert int(ts1) == int(js1) == 7
    assert float(td1) == pytest.approx(float(jd1), abs=1e-5) and float(td1) < 1e-5
