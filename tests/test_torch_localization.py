"""Port parity for the slice as a whole: ``localize_track_step`` and
``Localizer``.

The port's ``Mapper`` maps 60 simulated scans (4,096 points) of the 8 m
ring world and saves the map; both packages' ``Localizer`` load that
directory (the reference reads what the port wrote; the other direction is
in ``test_torch_rtkm.py``) and follow the same 16-scan drive, which starts at
rest and speeds up so that the side-running LIO converges: a pose hint
~1 m off, IMU-driven prediction during the LIO's 10 warm-up scans, then
odometry-driven prediction.  Tolerances:
- ``localize_track_step`` alone, same state, maps and scan in both
  packages, every prediction mode, gates open and shut: ``ok`` and
  ``gps_ok`` equal, state and pose atol 1e-4 (the matchers' own parity is
  1e-5 on these settings; the UKF's 2e-5), ``matched`` and ``fitness``
  within 2 points of the scan;
- the two ``Localizer``s: the same status on every scan, poses atol 5e-3 m
  (measured 4.5e-4: the NDT/ICP match of each scan starts from the previous
  one's rounding), the same recentres, both within 0.1 m of the
  simulator's truth; ``matched_frac`` within 0.1 (see the test);
- ``project_fix``: rtol 1e-9 before the float32 cast the reference makes,
  so equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.ops import surfel as jsurfel
from lsd_tpu.slam import localization as JL
from lsd_tpu.slam import registration as jreg
from lsd_tpu.slam import ukf as jukf
from lsd_tpu.slam.lio import LioConfig as JLioConfig
from lsd_tpu_torch import convert
from lsd_tpu_torch.sim import CircleSim, SimConfig
from lsd_tpu_torch.slam import localization as TL
from lsd_tpu_torch.slam.lio import LioConfig as TLioConfig
from lsd_tpu_torch.slam.mapper import Mapper, MapperConfig
from lsd_tpu_torch.tools.profile_lio import nav_at_start

N = 4096
LIO = dict(ds_capacity=2048, map_capacity=2 ** 14, scan_voxel=0.4, map_voxel=0.4)
LOC = dict(ndt_capacity=2 ** 13, track_capacity=2048)
WORLD = dict(radius=8.0, omega=0.8, points_per_scan=N, point_noise=0.01, seed=21)
T_START, N_DRIVE = 0.037, 16


def f(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a), dtype)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(map directory written by the port's Mapper, the drive's simulator
    and its scans)."""
    sim = CircleSim(SimConfig(n_scans=60, **WORLD))
    mapper = Mapper(MapperConfig(lio=TLioConfig(**LIO), keyframe_delta_trans=1.5,
                                 optimize_every=8, keyframe_cloud_cap=4096),
                    nav_at_start(sim, "cpu"))
    for k, d in enumerate(sim.generate(capacity=N, imu_capacity=16)):
        mapper.process_scan(*d[:5], stamp_us=int(k * 1e5))
    map_dir = str(tmp_path_factory.mktemp("maps") / "ring")
    mapper.save(map_dir)
    assert len(mapper.store) > 15
    # the same world (same seed and radius), driven from rest
    drive = CircleSim(SimConfig(n_scans=N_DRIVE, rest_time=0.4, ramp_time=2.0, **WORLD))
    assert np.array_equal(drive.world, sim.world)
    scans = drive.generate(capacity=N, imu_capacity=16, t_start=T_START)
    return map_dir, drive, scans


def _hint(drive):
    R, p = drive.pose(T_START)
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, p + np.asarray([0.8, -0.5, 0.1])
    return T


def _localizers(map_dir, **kw):
    jl = JL.Localizer(map_dir, JL.LocalizerConfig(lio=JLioConfig(max_iters=3, **LIO),
                                                  **LOC, **kw))
    tl = TL.Localizer(map_dir, TL.LocalizerConfig(lio=TLioConfig(max_iters=3, **LIO),
                                                  **LOC, **kw), device="cpu")
    return jl, tl


def _count_builds(loc):
    calls = []
    build = loc._build_local_map
    loc._build_local_map = lambda c: (calls.append(np.asarray(c).copy()), build(c))[1]
    return calls


@pytest.fixture(scope="module")
def runs(world):
    """Both localizers over the drive, production mode: (jl, tl, outputs of
    each, the port's has_odom per scan, recentres of each)."""
    map_dir, drive, scans = world
    jl, tl = _localizers(map_dir, update_map_every=0.5)   # 2 m of drive: recentre often
    jb, tb = _count_builds(jl), _count_builds(tl)
    jl.set_init_pose(_hint(drive))
    tl.set_init_pose(_hint(drive))
    jout, tout, has_odom = [], [], []
    for k, (P, S, M, I, IM, _) in enumerate(scans):
        t0 = T_START + k * 0.1
        smp = drive.imu_sample(t0)
        kw = dict(stamp_us=int(t0 * 1e6), imu_gyro=smp[1:4], imu_acc=smp[4:7] * 9.81,
                  stamps=S, imu=I, imu_mask=IM)
        jout.append(jl.process_scan(P, M, **kw))
        tout.append(tl.process_scan(P, M, **kw))
        has_odom.append(getattr(tl, "last_step_diag", {}).get("has_odom"))
    return jl, tl, jout, tout, has_odom, jb, tb


def test_config_fields_carry_over():
    jf = [x.name for x in dataclasses.fields(JL.LocalizerConfig)]
    tf = [x.name for x in dataclasses.fields(TL.LocalizerConfig)]
    assert jf == tf
    jc, tc = JL.LocalizerConfig(), TL.LocalizerConfig()
    for name in jf:
        assert tuple(getattr(jc, name)) == tuple(getattr(tc, name)) if name in ("lio", "ukf") \
            else getattr(jc, name) == getattr(tc, name), name


def test_public_methods_carry_over():
    public = lambda cls: {n for n in vars(cls) if not n.startswith("__")}
    assert public(JL.Localizer) <= public(TL.Localizer)


def test_both_load_the_map_alike(runs):
    jl, tl = runs[0], runs[1]
    assert len(tl.store) == len(jl.store) > 15
    for a, b in zip(tl.store.frames, jl.store.frames):
        assert a.stamp_us == b.stamp_us
        np.testing.assert_array_equal(a.pose, b.pose)
        np.testing.assert_array_equal(a.cloud, b.cloud)
    assert int(tl.sc_db.count) == int(jl.sc_db.count) == len(tl.store)
    np.testing.assert_allclose(tl.sc_db.desc.numpy(), np.asarray(jl.sc_db.desc), atol=1e-6)
    np.testing.assert_array_equal(tl.sc_db.mask.numpy(), np.asarray(jl.sc_db.mask))
    np.testing.assert_array_equal(tl.origin, jl.origin)


def test_localizers_track_alike(runs, world):
    _, _, scans = world
    jl, tl, jout, tout, has_odom, jb, tb = runs
    assert [o["status"] for o in tout] == [o["status"] for o in jout] \
        == ["initialized"] + ["tracking"] * (N_DRIVE - 1)
    for k, (a, b) in enumerate(zip(tout, jout)):
        np.testing.assert_allclose(a["pose"], b["pose"], rtol=0, atol=5e-3, err_msg=str(k))
        truth = scans[k][5][:3, 3]
        assert np.linalg.norm(a["pose"][:3, 3] - truth) < 0.1, k
        assert np.linalg.norm(b["pose"][:3, 3] - truth) < 0.1, k
    # the world's ground lies at z = 0, a boundary of the 1 m NDT voxels, so
    # a 1e-4 m difference in height moves a few per cent of the points
    # between a populated voxel and a thin one
    for a, b in zip(tout[1:], jout[1:]):
        assert abs(a["matched_frac"] - b["matched_frac"]) < 0.1 and a["matched_frac"] > 0.7
    # the side LIO's increments drive the prediction after its 10 warm-up scans
    assert has_odom == [None] + [False] * 9 + [True] * (N_DRIVE - 10)
    # the same recentres, at the same places
    assert len(tb) == len(jb) >= 2
    np.testing.assert_allclose(np.stack(tb), np.stack(jb), atol=5e-3)
    assert tl._misses == jl._misses == 0
    d = tl.last_step_diag
    assert d["track_ok"] and d["innov_t"] < 0.1 and not d["gps_ok"]


def test_side_lio_increments_match_and_are_gated(runs, world):
    """The warm-up window and the 1.5 m bound, as the reference's own test
    holds them; the two packages' side filters agree."""
    _, _, scans = world
    jl, tl = runs[0], runs[1]
    assert tl._lio_n == jl._lio_n == N_DRIVE
    np.testing.assert_allclose(tl._lio_prev, jl._lio_prev, atol=2e-3)
    cold = TL.Localizer.__new__(TL.Localizer)          # no map needed for the side LIO
    cold.cfg, cold.device, cold._lio_state = tl.cfg, tl.device, None
    outs = [cold._lio_increment(P, S, M, I, IM) for P, S, M, I, IM, _ in scans[:12]]
    assert all(o is None for o in outs[:10]) and all(o is not None for o in outs[10:])
    dq, dtr = outs[11]
    assert dq.shape == (4,) and dtr.shape == (3,) and dq.dtype == dtr.dtype == np.float32
    assert np.isfinite(dq).all() and np.isfinite(dtr).all()
    # a jump in the previous pose makes the apparent increment huge: withheld
    jump = np.eye(4)
    jump[:3, 3] = [25.0, 0.0, 0.0]
    cold._lio_prev = cold._lio_prev @ jump
    P, S, M, I, IM, _ = scans[12]
    assert cold._lio_increment(P, S, M, I, IM) is None
    assert cold._lio_increment(P, S, M, I, IM) is not None
    # no stamps or no IMU batch: no side filter
    assert cold._lio_increment(P, None, M, I, IM) is None
    assert cold._lio_increment(P, S, M, None, None) is None


def test_relocalization_without_a_hint_and_pose_queries_match(runs, world):
    map_dir, drive, scans = world
    jl, tl = _localizers(map_dir, use_lio_odometry=False)
    P, _, M = scans[0][:3]
    jT = jl._relocalize(P, M)
    tT = tl._relocalize(P, M)
    assert (jT is None) == (tT is None)
    assert tl.last_reloc["sc_index"] is not None and tl.last_reloc["sc_dist"] < 1.0
    if tT is not None:
        np.testing.assert_allclose(tT, jT, atol=5e-3)
    # too few map points around the candidate: no pose
    far = np.eye(4)
    far[:3, 3] = [500.0, 0.0, 0.0]
    tl.set_init_pose(far)
    assert tl._relocalize(P, M) is None and tl.last_reloc["fitness"] is None
    # the hint as [x, y, z, roll, pitch, yaw]
    R, p = drive.pose(T_START)
    rng6 = [*(p + [0.3, 0.2, 0.0]), 0.0, 0.0, float(np.arctan2(R[1, 0], R[0, 0]))]
    jl.set_init_pose_range(rng6)
    tl.set_init_pose_range(rng6)
    np.testing.assert_allclose(tl.init_hint, jl.init_hint, atol=1e-12)
    assert tl.get_estimate_pose(-20, -20, 20, 20) is None          # no scan seen yet
    jo = jl.process_scan(P, M, stamp_us=37000)
    to = tl.process_scan(P, M, stamp_us=37000)
    assert to["status"] == jo["status"] == "initialized"
    np.testing.assert_allclose(to["pose"], jo["pose"], atol=5e-3)
    je = jl.get_estimate_pose(-20, -20, 20, 20)
    te = tl.get_estimate_pose(-20, -20, 20, 20)
    assert (je is None) == (te is None) and tl.init_hint is not None
    if te is not None:
        np.testing.assert_allclose(te, je, atol=5e-3)
    assert tl.get_estimate_pose(400, 400, 500, 500) is None        # no keyframe there


def test_tracking_lost_after_misses_and_gnss_watchdog(world):
    """The host bookkeeping: a map that matches nothing counts misses up to
    ``lost_after_misses`` and reports lost; a fix 30 m off five times in a
    row reports lost; a relocalization that disagrees with the fix or the
    INS heading is refused."""
    map_dir, drive, scans = world
    _, tl = _localizers(map_dir, use_lio_odometry=False, lost_after_misses=3)
    P, _, M = scans[0][:3]
    R, p = drive.pose(T_START)
    yaw = float(np.arctan2(R[1, 0], R[0, 0]))
    tl.set_init_pose(_hint(drive))
    assert tl.process_scan(P, M, 37000, gps_xyz=p + [40.0, 0, 0])["status"] == "relocalizing"
    assert tl.process_scan(P, M, 37000, ins_yaw=yaw + 2.0)["status"] == "relocalizing"
    assert tl.process_scan(P, M, 37000, gps_xyz=p, ins_yaw=yaw)["status"] == "initialized"
    empty = np.zeros_like(M)
    status = [tl.process_scan(P, empty, 137000 + k * 100000)["status"] for k in range(3)]
    assert status == ["tracking", "tracking", "lost"] and not tl.initialized
    assert tl.process_scan(P, M, 437000)["status"] == "initialized"
    status = [tl.process_scan(P, M, 537000 + k * 100000, gps_xyz=p + [30.0, 0, 0])["status"]
              for k in range(5)]
    assert status == ["tracking"] * 4 + ["lost"]
    # the fix 30 m off was refused by the innovation gate, which widened
    assert tl._gps_rej == 5 and not tl.last_step_diag["gps_ok"]


# ---- localize_track_step alone -------------------------------------------


@pytest.fixture(scope="module")
def step_inputs(world):
    """One filter state, NDT map, surfel map and scan, in both packages."""
    map_dir, drive, scans = world
    _, tl = _localizers(map_dir, use_lio_odometry=False)
    tl.set_init_pose(_hint(drive))
    P, S, M = scans[0][:3]
    out = tl.process_scan(P, M, 37000)
    pad, msk = (a.numpy() for a in tl._local_cloud)
    jndt = jreg.ndt_build(j(pad), j(msk, bool), 1.0, LOC["ndt_capacity"])
    jicp = jsurfel.surfel_insert(jsurfel.surfel_create(2 ** 17, 0.5), j(pad), j(msk, bool))
    tndt = convert.ndt_map_from_numpy(jax.device_get(jndt), device="cpu")
    jst = jukf.ukf_init(j(out["pose"]))
    jst = jst._replace(x=jst.x.at[3:6].set(j([0.3, 0.1, 0.0])).at[16:19].set(j([0, 0, 0.05])))
    tst = convert.ukf_state_from_numpy(jax.device_get(jst), device="cpu")
    return (jst, jndt, jicp), (tst, tndt, tl.icp_map), (P, S, M), out["pose"]


SHORT = dict(ndt_iters=4, ndt_searches=2, icp_iters=2, icp_searches=1)


@pytest.mark.parametrize("mode,stamps,voxel,gps,gate_t", [
    ("const", False, 0.0, "none", 1.0),
    ("const", True, 0.4, "near", 1.0),
    ("imu", False, 0.4, "far", 1.0),
    ("imu", True, 0.0, "near", 1.0),
    ("odom", True, 0.4, "near", 1.0),        # gates open
    ("odom", True, 0.4, "far", 1e-4),        # gates shut: the match and the fix refused
    ("odom", False, 0.0, "none", 1e-4),
])
def test_track_step_matches(step_inputs, mode, stamps, voxel, gps, gate_t):
    (jst, jndt, jicp), (tst, tndt, ticp), (P, S, M), pose = step_inputs
    g, a = [0.01, -0.02, 0.1], [0.2, 0.1, 9.8]
    fix = pose[:3, 3] + ([0.3, -0.2, 1.0] if gps == "near" else [9.0, 0.0, 0.0])
    dq = np.asarray([np.cos(0.004), 0, 0, np.sin(0.004)], np.float32)
    statics = dict(has_imu=mode == "imu", has_odom=mode == "odom", track_voxel=voxel,
                   track_capacity=2048, **SHORT)
    jout = JL.localize_track_step(
        jst, jndt, jicp, j(P), j(M, bool), j(0.1), j(g), j(a), j(fix), j(gps != "none", bool),
        j(0.25), odom_dq=j(dq), odom_dt=j([0.03, 0.0, 0.0]), gate_t=j(gate_t),
        gate_ang=j(0.17), gps_gate=j(2.5), stamps=j(S) if stamps else None, **statics)
    tout = TL.localize_track_step(
        tst, tndt, ticp, f(P), f(M, torch.bool), f(0.1), f(g), f(a), f(fix),
        f(gps != "none", torch.bool), f(0.25), odom_dq=f(dq), odom_dt=f([0.03, 0.0, 0.0]),
        gate_t=f(gate_t), gate_ang=f(0.17), gps_gate=f(2.5),
        stamps=f(S) if stamps else None, **statics)
    (jn, jpose, jm, jf, jok, jgok, jdiag), (tn, tpose, tm, tf, tok, tgok, tdiag) = jout, tout
    assert bool(tok) == bool(jok) == (gate_t == 1.0)
    assert bool(tgok) == bool(jgok) == (gps == "near")
    np.testing.assert_allclose(tn.x.numpy(), np.asarray(jn.x), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tn.P.numpy(), np.asarray(jn.P), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), rtol=0, atol=1e-4)
    n_pts = 2048 if voxel else M.sum()
    assert abs(float(tm) - float(jm)) <= 2.0 / n_pts and float(tm) > 0.3
    assert abs(float(tf) - float(jf)) <= 2.0 / n_pts and float(tf) > 0.3
    # the innovation angle 2 acos(|q . q0|) resolves ~7e-4 rad in float32
    np.testing.assert_allclose(tdiag.numpy(), np.asarray(jdiag), rtol=1e-4, atol=1e-3)
    assert tpose.shape == (4, 4) and tdiag.shape == (3,) and tok.dtype == torch.bool


def test_track_step_default_gates_are_the_reference_s(step_inputs):
    """Gates left out: 1 m, 10 degrees, 2.5 m in both packages."""
    (jst, jndt, jicp), (tst, tndt, ticp), (P, S, M), pose = step_inputs
    fix = pose[:3, 3] + [2.0, 0.0, 0.0]
    z3, one = [0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0]
    kw = dict(has_odom=True, track_voxel=0.4, track_capacity=2048, **SHORT)
    jout = JL.localize_track_step(jst, jndt, jicp, j(P), j(M, bool), j(0.1), j(z3), j(z3), j(fix),
                                  j(True, bool), j(0.25), odom_dq=j(one), odom_dt=j(z3), **kw)
    tout = TL.localize_track_step(tst, tndt, ticp, f(P), f(M, torch.bool), f(0.1), f(z3), f(z3),
                                  f(fix), f(True, torch.bool), f(0.25), odom_dq=f(one),
                                  odom_dt=f(z3), **kw)
    assert bool(tout[4]) == bool(jout[4]) and bool(tout[5]) == bool(jout[5]) is True
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), rtol=0, atol=1e-4)


# ---- GNSS projection -------------------------------------------------------


def test_project_fix_and_utm_match(world):
    from lsd_tpu.geometry import utm as jutm
    from lsd_tpu_torch.geometry import utm as tutm
    map_dir = world[0]
    jl, tl = _localizers(map_dir, use_lio_odometry=False)
    assert tl.project_fix(42.0, -83.0) is not None or tl.origin is None or np.size(tl.origin) < 2
    for loc in (jl, tl):
        loc.origin = np.asarray([42.0, -83.0, 100.0])
        loc.origin_anchor = np.asarray([12.5, -3.0, 0.5])
    rng = np.random.default_rng(0)
    for _ in range(20):
        lat, lon, alt = 42.0 + rng.normal(0, 1e-3), -83.0 + rng.normal(0, 1e-3), rng.normal(100, 5)
        np.testing.assert_array_equal(tl.project_fix(lat, lon, alt), jl.project_fix(lat, lon, alt))
    xyz = tl.project_fix(42.00001, -83.0, 101.0) - np.asarray([12.5, -3.0, 0.5], np.float32)
    assert abs(xyz[1] - 1.11) < 0.1 and abs(xyz[0]) < 0.1 and abs(xyz[2] - 1.0) < 1e-5
    tl.origin = None
    assert tl.project_fix(42.0, -83.0) is None
    lats, lons = rng.uniform(-60, 60, 50), rng.uniform(-179, 179, 50)
    for lat, lon in zip(lats, lons):
        je, jn, jz = jutm.latlon_to_utm(lat, lon)
        te, tn, tz = tutm.latlon_to_utm(lat, lon)
        assert tz == jz
        np.testing.assert_allclose([te, tn], [je, jn], rtol=1e-9)
        np.testing.assert_allclose(tutm.utm_to_latlon(te, tn, tz), (lat, lon), rtol=1e-9, atol=1e-9)
        assert tutm.grid_convergence(-81.0, lat, lon) == jutm.grid_convergence(-81.0, lat, lon)
    jp, tp = jutm.UTMProjector(), tutm.UTMProjector()
    for lat, lon in ((42.0, -83.0), (42.001, -83.002), (41.99, -82.99)):
        np.testing.assert_allclose(tp.project(lat, lon), jp.project(lat, lon), rtol=1e-9, atol=1e-9)
    assert tp.zone == jp.zone and tp.lon0 == jp.lon0 and tp.origin == jp.origin
    np.testing.assert_allclose(tp.unproject(120.0, -45.0), jp.unproject(120.0, -45.0), rtol=1e-12)
