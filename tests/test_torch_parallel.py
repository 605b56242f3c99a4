"""Port parity for ``lsd_tpu_torch.parallel``: the mesh, the launcher and
the point-sharded LIO update, on gloo groups of CPU ranks.

The reference runs its ``shard_map`` programs on a virtual mesh of CPU
devices in one process; the port runs one process per rank.  One group of
4 gloo ranks (``run_ranks``, spawned once for the module) computes what the
tests compare; the rank functions live in ``tests/torch_ranks.py``, which
imports no JAX.  Tolerances:
- ``_measurement_system`` against the reference's: atol 1e-5 on the
  Jacobian rows and residuals (float32 of another operation order), the
  gate and the weights equal;
- the fused reduction's gate (``ops/p2p.py``) against
  ``_measurement_system``'s ``valid``, non-finite planes included: equal
  counts, the information matrix within rtol 1e-5 of its largest entry;
- neighbourhood moments with a neighbour mask against the reference's:
  atol 1e-4 (sums of up to a few hundred float32 terms); without one,
  bit-equal to an all-true mask;
- ``sharded_lio_update`` on 4 ranks against the reference's on a 4-device
  mesh, on ``tests/test_parallel.py``'s scan: position within 1e-4 m,
  ``|q . q'| > 1 - 1e-6`` (the two sum the ranks' partials in other
  orders).
"""
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.geometry import so3 as jso3
from lsd_tpu.ops import surfel as jsurfel
from lsd_tpu.ops import voxel_downsample as jvoxel_downsample
from lsd_tpu.parallel import make_mesh as jmake_mesh
from lsd_tpu.parallel import sharded_lio_update as jsharded_lio_update
from lsd_tpu.sim import CircleSim, SimConfig
from lsd_tpu.slam import lio as jlio
from lsd_tpu.slam.imu import propagate as jpropagate
from lsd_tpu.slam.imu import undistort as jundistort
from lsd_tpu.slam.state import init_state as jinit
from lsd_tpu_torch import convert
from lsd_tpu_torch.ops import surfel as tsurfel
from lsd_tpu_torch.ops.p2p import p2p_reduce_plain
from lsd_tpu_torch.parallel import make_mesh, run_ranks
from lsd_tpu_torch.slam import lio as tlio
from lsd_tpu_torch.slam.state import NavState

from tests import torch_ranks

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
JCFG = jlio.LioConfig(ds_capacity=4096, map_capacity=2 ** 15, scan_voxel=0.4, map_voxel=0.4)
TCFG = tlio.LioConfig(ds_capacity=4096, map_capacity=2 ** 15, scan_voxel=0.4, map_voxel=0.4)


@pytest.fixture(scope="module")
def scan():
    """``tests/test_parallel.py``'s world and sizes, the map seeded with
    three scans and the fourth propagated, undistorted and downsampled by
    the reference.  (That test seeds one scan; on the second no residual
    passes the gate, in either package, and the update does not move.)"""
    sim = CircleSim(SimConfig(n_scans=4, points_per_scan=8192, seed=3))
    data = sim.generate(capacity=8192, imu_capacity=16)
    R, p = sim.pose(0.0)
    nav0 = jinit()._replace(pos=jnp.asarray(p, jnp.float32),
                            quat=jso3.matrix_to_quat(jnp.asarray(R, jnp.float32)),
                            vel=jnp.asarray(sim.velocity(0.0), jnp.float32))
    st = jlio.lio_init(JCFG, nav0)
    for d in data[:3]:
        st, _ = jlio.lio_step(JCFG, st, *[jnp.asarray(a) for a in d[:5]])
    P_, S_, M_, I_, IM_, _ = data[3]
    nav_prop, P_prop, track = jpropagate(st.nav, st.P, jnp.asarray(I_), jnp.asarray(IM_),
                                         JCFG.imu_noise, JCFG.acc_scale)
    und = jundistort(jnp.asarray(P_)[:, :3], jnp.asarray(S_), jnp.asarray(M_), nav_prop, track)
    ds_pts, ds_mask = jvoxel_downsample(und, jnp.asarray(M_), JCFG.scan_voxel, JCFG.ds_capacity)
    return dict(st=st, nav_prop=nav_prop, P_prop=P_prop,
                ds_pts=np.asarray(ds_pts[:, :3]), ds_mask=np.asarray(ds_mask))


def _tnav(jnav) -> NavState:
    return NavState(*[torch.tensor(np.asarray(getattr(jnav, f))) for f in NavState._fields])


@pytest.fixture(scope="module")
def world(scan):
    """One 4-rank gloo group: every rank's view of its mesh and its result
    of ``sharded_lio_update``."""
    st_tree = convert.lio_state_to_numpy(
        convert.lio_state_from_numpy(jax.tree.map(np.asarray, scan["st"]), "cpu"))
    nav_tree = {f: np.asarray(getattr(scan["nav_prop"], f)) for f in NavState._fields}
    return run_ranks(torch_ranks.mesh_and_update, WORLD, backend="gloo", args=(
        TCFG, st_tree, nav_tree, np.asarray(scan["P_prop"]), scan["ds_pts"], scan["ds_mask"]))


@pytest.mark.parametrize("est_extrinsic", [False, True])
def test_measurement_system_matches_reference(scan, est_extrinsic):
    """On the reference's planes: rows, residuals, gate and weights."""
    jcfg = JCFG._replace(est_extrinsic=est_extrinsic)
    pts, mask = jnp.asarray(scan["ds_pts"]), jnp.asarray(scan["ds_mask"])
    jplanes = jlio._match_planes(jcfg, scan["nav_prop"], pts, mask, scan["st"].map)
    jout = jlio._measurement_system(jcfg, scan["nav_prop"], pts, mask, scan["st"].map, jplanes)
    tout = tlio._measurement_system(
        TCFG._replace(est_extrinsic=est_extrinsic), _tnav(scan["nav_prop"]),
        torch.tensor(scan["ds_pts"]), torch.tensor(scan["ds_mask"]), None,
        tuple(torch.tensor(np.asarray(a)) for a in jplanes))
    H, r, valid, inv_var = (np.asarray(a) for a in jout)
    assert int(valid.sum()) > 500
    np.testing.assert_array_equal(tout[2].numpy(), valid)
    np.testing.assert_allclose(tout[0].numpy(), H, atol=1e-5)
    np.testing.assert_allclose(tout[1].numpy(), r, atol=1e-5)
    np.testing.assert_allclose(tout[3].numpy(), inv_var, rtol=1e-6)


def test_measurement_system_matches_planes(scan):
    """With ``planes=None`` each package matches its own planes at ``nav``:
    the plane normals agree up to sign within atol 1e-4
    (``tests/test_torch_ops.py``), so rows agree within 1e-4 times the
    lever arm, and at most a few points flip the gate."""
    pts, mask = scan["ds_pts"], scan["ds_mask"]
    H, r, valid, _ = (np.asarray(a) for a in jlio._measurement_system(
        JCFG, scan["nav_prop"], jnp.asarray(pts), jnp.asarray(mask), scan["st"].map))
    tst = convert.lio_state_from_numpy(jax.tree.map(np.asarray, scan["st"]), "cpu")
    tH, tr, tvalid, _ = (a.numpy() for a in tlio._measurement_system(
        TCFG, _tnav(scan["nav_prop"]), torch.as_tensor(pts), torch.as_tensor(mask), tst.map))
    both = valid & tvalid
    assert both.sum() > 500 and (valid != tvalid).sum() <= 0.01 * both.sum()
    sign = np.sign(np.sum(tH[both, :3] * H[both, :3], -1))
    lever = float(np.linalg.norm(pts[both], axis=-1).max())
    np.testing.assert_allclose(tH[both] * sign[:, None], H[both], atol=1e-4 * lever)
    np.testing.assert_allclose(tr[both] * sign, r[both], atol=1e-4 * lever)


@pytest.mark.parametrize("est_extrinsic", [False, True])
def test_p2p_gate_equals_measurement_system(scan, est_extrinsic):
    """The fused reduction keeps exactly the rows ``_measurement_system``
    calls valid, the non-finite ones dropped: planes with NaN or infinite
    normals and offsets, marked usable, are injected."""
    tst = convert.lio_state_from_numpy(jax.tree.map(np.asarray, scan["st"]), "cpu")
    cfg = TCFG._replace(est_extrinsic=est_extrinsic)
    nav = _tnav(scan["nav_prop"])
    pts, mask = torch.as_tensor(scan["ds_pts"]), torch.as_tensor(scan["ds_mask"])
    normals, d, ok, rms = tlio._match_planes(cfg, nav, pts, mask, tst.map)
    bad = torch.arange(0, pts.shape[0], 97)
    normals, d, ok = normals.clone(), d.clone(), ok.clone()
    normals[bad[::3]] = float("nan")
    normals[bad[1::3], 0] = float("inf")
    d[bad[2::3]] = float("nan")
    ok[bad] = True
    planes = (normals, d, ok, rms)
    H, r, valid, inv_var = tlio._measurement_system(cfg, nav, pts, mask, tst.map, planes)
    w = valid.to(torch.float32) * inv_var
    HtH, Htr, stats = p2p_reduce_plain(pts, normals, d, tlio.p2p_weight(cfg, mask, planes),
                                       nav.rot, nav.ext_rot, nav.ext_t, nav.pos, cfg.max_resid,
                                       est_extrinsic=est_extrinsic)
    assert torch.isfinite(HtH).all() and torch.isfinite(Htr).all()
    assert int(stats[0]) == int(valid.sum()) > 500
    want_H = H.T @ (H * w[:, None])
    want_r = (H * w[:, None]).T @ r
    scale = float(want_H.abs().max())
    np.testing.assert_allclose(HtH.numpy(), want_H.numpy(), atol=1e-5 * scale)
    np.testing.assert_allclose(Htr.numpy(), want_r.numpy(), atol=1e-5 * scale)


def test_neighbor_mask_moments(scan):
    jm = scan["st"].map
    tm = convert.lio_state_from_numpy(jax.tree.map(np.asarray, scan["st"]), "cpu").map
    rng = np.random.default_rng(4)
    q = scan["ds_pts"][scan["ds_mask"]][:1500] + rng.normal(0, 0.05, (1500, 3)).astype(np.float32)
    keep = rng.random((1500, 7)) < 0.6
    tq = torch.as_tensor(q)
    got = tsurfel.surfel_neighborhood_moments(tm, tq, neighbor_mask=torch.as_tensor(keep))
    want = jsurfel.surfel_neighborhood_moments(jm, jnp.asarray(q), neighbor_mask=jnp.asarray(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)
    full = tsurfel.surfel_neighborhood_moments(tm, tq)
    assert torch.equal(full, tsurfel.surfel_neighborhood_moments(
        tm, tq, neighbor_mask=torch.ones(1500, 7, dtype=torch.bool)))
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jsurfel.surfel_neighborhood_moments(jm, jnp.asarray(q))),
        atol=1e-4, rtol=1e-5)
    # the complement adds up to the whole neighbourhood
    rest = tsurfel.surfel_neighborhood_moments(tm, tq, neighbor_mask=torch.as_tensor(~keep))
    np.testing.assert_allclose((got + rest).numpy(), full.numpy(), atol=1e-4, rtol=1e-5)
    assert float(got[:, 0].sum()) > 0 and float(rest[:, 0].sum()) > 0


def test_mesh(world):
    for r, out in enumerate(world):
        assert (out["rank"], out["size"], out["axis"], out["device"]) == (r, WORLD, "dp", "cpu")
        assert out["sub_rank"] == (r if r < 2 else -1)
        assert "5 devices asked for, the group has 4 ranks" in out["too_many"]
        assert out["foreign"] == []             # no JAX and no reference module in a rank
        np.testing.assert_array_equal(out["psum"], np.full(3, 10.0))


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="no torch.distributed group"):
        make_mesh()


def test_sharded_lio_update_matches_reference(scan, world):
    jnav = jsharded_lio_update(JCFG, jmake_mesh(WORLD), scan["nav_prop"], scan["P_prop"],
                               scan["st"].map, jnp.asarray(scan["ds_pts"]),
                               jnp.asarray(scan["ds_mask"]))
    navs = [out["nav"] for out in world]
    for nav in navs[1:]:
        for f in NavState._fields:
            np.testing.assert_array_equal(nav[f], navs[0][f])
    assert np.linalg.norm(navs[0]["pos"] - np.asarray(jnav.pos)) < 1e-4
    assert abs(float(navs[0]["quat"] @ np.asarray(jnav.quat))) > 1 - 1e-6
    # the update moved the state: the test is not of a no-op
    assert np.linalg.norm(navs[0]["pos"] - np.asarray(scan["nav_prop"].pos)) > 1e-4


@pytest.mark.parametrize("how", ["kill", "raise"])
def test_failed_rank_stops_the_group(how):
    """A rank that dies or raises while the others sit in an all_reduce
    makes the launcher kill them and raise, long before the group's own
    timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 3: ") as exc:
        run_ranks(torch_ranks.die_in_collective, 3, args=(how,), backend="gloo",
                  init_timeout_s=60, timeout_s=120)
    assert time.monotonic() - t0 < 60
    if how == "raise":
        assert "rank 1 gives up" in str(exc.value)


def test_ranks_import_no_jax():
    """``import lsd_tpu_torch.parallel`` and the test ranks' module load
    neither JAX nor the reference package."""
    code = ("import sys; import lsd_tpu_torch.parallel; import tests.torch_ranks; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'lsd_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
