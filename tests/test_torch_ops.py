"""Port parity: ops/hashmap, ops/voxelize and ops/surfel of lsd_tpu_torch
against lsd_tpu on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, each with its reason:
- hash primitives, voxel keys, surfel keys and coords: bit-exact (slot
  placement decides map parity);
- downsampled points: masks exact, means atol 1e-5 (sums of up to a few
  dozen float32 points in another order);
- surfel moments: rtol 1e-5 with atol 1e-5 (scatter-add order; sums that
  cancel to ~0 need the absolute floor);
- plane normals: up to sign, atol 1e-4 (a closed-form eigenvector of a
  float32 covariance); offsets and thickness atol 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.ops import hashmap as jhash
from lsd_tpu.ops import surfel as jsurf
from lsd_tpu.ops import voxelize as jvox
from lsd_tpu_torch.ops import hashmap as thash
from lsd_tpu_torch.ops import surfel as tsurf
from lsd_tpu_torch.ops import voxelize as tvox


def _coords(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    c = rng.integers(-3000, 3000, size=(n, 3)).astype(np.int32)
    c[:4] = [[0, 0, 0], [-1, -1, -1], [2 ** 31 - 1, -2 ** 31, 7],
             [-2 ** 31, 2 ** 31 - 1, -5]]
    return c


@pytest.mark.parametrize("seed", [0, 1])
def test_hash_primitives_bit_exact(seed):
    c = _coords(seed)
    jc, tc = jnp.asarray(c), torch.as_tensor(c)
    h = np.random.default_rng(seed).integers(0, 2 ** 32, size=4096, dtype=np.uint64)
    np.testing.assert_array_equal(
        thash._fmix32(torch.as_tensor(h.astype(np.int64))).numpy(),
        np.asarray(jhash._fmix32(jnp.asarray(h.astype(np.uint32)))).astype(np.int64))
    for seed_const in (0x9E3779B9, 0x85EBCA77):
        np.testing.assert_array_equal(
            thash._hash_coords(tc, seed_const).numpy(),
            np.asarray(jhash._hash_coords(jc, seed_const)).astype(np.int64))
    for cap in (2 ** 13, 2 ** 18):
        np.testing.assert_array_equal(thash._slot_hash(tc, cap).numpy(),
                                      np.asarray(jhash._slot_hash(jc, cap)))
    np.testing.assert_array_equal(thash._content_key(tc).numpy(),
                                  np.asarray(jhash._content_key(jc)))


def test_probe_find_bit_exact():
    cap = 2 ** 10
    c = _coords(2, n=600)
    keys = np.full(cap, -1, np.int32)
    slot = np.asarray(jhash._slot_hash(jnp.asarray(c), cap))
    ck = np.asarray(jhash._content_key(jnp.asarray(c)))
    for i in range(0, 600, 2):                    # every other voxel, linear probing
        s = slot[i]
        while keys[s] >= 0:
            s = (s + 1) & (cap - 1)
        keys[s] = ck[i]
    for probes in (2, 8):
        np.testing.assert_array_equal(
            thash._probe_find(torch.as_tensor(keys), torch.as_tensor(c), cap, probes).numpy(),
            np.asarray(jhash._probe_find(jnp.asarray(keys), jnp.asarray(c), cap, probes)))


def _cloud(seed=0, n=3000, scale=20.0):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    pts[:300] = pts[300:600] + rng.normal(size=(300, 3)).astype(np.float32) * 0.05
    mask = rng.random(n) > 0.1
    return pts, mask


def test_voxel_keys_bit_exact():
    pts, mask = _cloud(1, scale=600.0)          # some points off the 2048 grid
    np.testing.assert_array_equal(
        tvox.voxel_keys(torch.as_tensor(pts), torch.as_tensor(mask), 0.4).numpy(),
        np.asarray(jvox.voxel_keys(jnp.asarray(pts), jnp.asarray(mask), 0.4)))


@pytest.mark.parametrize("capacity", [512, 4096])
def test_voxel_downsample_matches_reference(capacity):
    pts, mask = _cloud(3)
    jp, jm = jvox.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), 0.5, capacity)
    tp, tm = tvox.voxel_downsample(torch.as_tensor(pts), torch.as_tensor(mask), 0.5, capacity)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5, rtol=0)


def _surfel_scene(seed=0, n=3000):
    """Points on a few planes (so moments are structured), world scale."""
    rng = np.random.default_rng(seed)
    u, v = rng.uniform(-6, 6, size=(2, n))
    k = rng.integers(0, 3, n)
    pts = np.where((k == 0)[:, None], np.stack([u, v, np.zeros(n)], 1),
                   np.where((k == 1)[:, None], np.stack([u, np.full(n, 4.0), v + 3], 1),
                            np.stack([np.full(n, -5.0), u, v + 3], 1)))
    pts = (pts + rng.normal(size=pts.shape) * 0.01 + [12.0, -7.0, 0.0]).astype(np.float32)
    mask = rng.random(n) > 0.05
    return pts, mask


def _to_torch_map(jm):
    return tsurf.SurfelMap(
        keys=torch.as_tensor(np.array(jm.keys)),
        coords=torch.as_tensor(np.stack(jm.coords)),
        moments=torch.as_tensor(np.stack(jm.moments)),
        voxel_size=torch.as_tensor(np.array(jm.voxel_size)))


def _assert_maps_match(jm, tm):
    np.testing.assert_array_equal(tm.keys.numpy(), np.asarray(jm.keys))
    np.testing.assert_array_equal(tm.coords.numpy(), np.stack(jm.coords))
    np.testing.assert_allclose(tm.moments.numpy(), np.stack(jm.moments), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cap", [2 ** 10, 2 ** 13])
def test_surfel_insert_matches_reference(cap):
    # 2**10 slots for ~1000 voxels: the claim rounds race and some points
    # find no slot, which both packages must settle alike
    jm = jsurf.surfel_create(cap, 0.5)
    tm = tsurf.surfel_create(cap, 0.5, device="cpu")
    for seed in (0, 1):
        pts, mask = _surfel_scene(seed)
        jm = jsurf.surfel_insert(jm, jnp.asarray(pts), jnp.asarray(mask))
        tm = tsurf.surfel_insert(tm, torch.as_tensor(pts), torch.as_tensor(mask))
        _assert_maps_match(jm, tm)


def test_surfel_trim_matches_reference():
    pts, mask = _surfel_scene(2)
    jm = jsurf.surfel_insert(jsurf.surfel_create(2 ** 13, 0.5), jnp.asarray(pts), jnp.asarray(mask))
    tm = _to_torch_map(jm)
    center = np.array([10.0, -6.0, 1.0], np.float32)
    _assert_maps_match(jsurf.surfel_trim(jm, jnp.asarray(center), 4.0),
                       tsurf.surfel_trim(tm, torch.as_tensor(center), 4.0))


def test_smallest_eigvec_matches_reference():
    rng = np.random.default_rng(4)
    B = rng.normal(size=(256, 3, 3))
    A = (B @ B.transpose(0, 2, 1) * rng.uniform(1e-4, 1.0, size=(256, 1, 1))).astype(np.float32)
    jv, jl0, jl1 = jsurf._smallest_eigvec_3x3(jnp.asarray(A))
    tv, tl0, tl1 = tsurf._smallest_eigvec_3x3(torch.as_tensor(A))
    sign = np.sign(np.sum(np.asarray(jv) * tv.numpy(), -1, keepdims=True))
    np.testing.assert_allclose(tv.numpy() * sign, np.asarray(jv), atol=1e-4)
    np.testing.assert_allclose(tl0.numpy(), np.asarray(jl0), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), rtol=1e-4, atol=1e-6)


def test_surfel_match_matches_reference():
    pts, mask = _surfel_scene(5, n=6000)
    jm = jsurf.surfel_insert(jsurf.surfel_create(2 ** 13, 0.5), jnp.asarray(pts), jnp.asarray(mask))
    tm = _to_torch_map(jm)
    q, qmask = _surfel_scene(6, n=2000)
    jn, jd, jok, jrms = jsurf.surfel_match(jm, jnp.asarray(q), jnp.asarray(qmask), 0.1)
    tn, td, tok, trms = tsurf.surfel_match(tm, torch.as_tensor(q), torch.as_tensor(qmask), 0.1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.sum() > 1000
    sign = np.where(np.sum(np.asarray(jn) * tn.numpy(), -1) < 0, -1.0, 1.0)
    np.testing.assert_allclose(tn.numpy() * sign[:, None], np.asarray(jn), atol=1e-4)
    np.testing.assert_allclose(td.numpy() * sign, np.asarray(jd), atol=1e-4)
    np.testing.assert_allclose(trms.numpy(), np.asarray(jrms), atol=1e-4)
    merged_j = jsurf.surfel_neighborhood_moments(jm, jnp.asarray(q))
    merged_t = tsurf.surfel_neighborhood_moments(tm, torch.as_tensor(q))
    np.testing.assert_allclose(merged_t.numpy(), np.asarray(merged_j), rtol=1e-5, atol=1e-4)


def test_surfel_create_rejects_bad_capacity():
    with pytest.raises(ValueError):
        tsurf.surfel_create(1000, 0.5, device="cpu")
