"""A ``Localizer`` initialised while the vehicle already cruises: what the
reference does there, and that the port does the same.

Both packages' ``Localizer`` load one map (the port's ``Mapper`` over 60
scans of 4,096 points of the 8 m ring world) and are initialised from a pose
hint ~1 m off at 6.4 m/s, the mapping run's speed.  Two modes of the
reference fail there, with every scan reported ``tracking``, and the port
reproduces both (``ROADMAP.md`` queue C):

- production mode (side LIO on): the side filter cold-starts at the identity
  with zero velocity, has not converged after its 10 warm-up scans, its
  increments pass the 1.5 m bound and carry the pose metres off the map;
- IMU-driven prediction with a tracking cloud that holds a fraction of the
  scan's voxels (512 here; 8,192 of a 32,768-point scan's in the default
  configuration): the UKF starts at zero velocity, which the IMU cannot
  correct, and the pose settles metres off the vehicle's.

Tolerances: statuses equal; poses of the two packages within 0.1 m in
production mode (measured 0.034) and 0.3 m in the second mode (measured
0.12: each scan's match starts from the previous one's rounding, and a
match on a slab of the sweep is poorly conditioned along the track); the
side filters' increments within 5e-3 m of each other.  A drive that
starts at rest tracks to 0.1 m: ``tests/test_torch_localization.py``.
"""
import numpy as np
import pytest

from lsd_tpu.slam import localization as JL
from lsd_tpu.slam.lio import LioConfig as JLioConfig
from lsd_tpu_torch.sim import CircleSim, SimConfig
from lsd_tpu_torch.slam import localization as TL
from lsd_tpu_torch.slam.lio import LioConfig as TLioConfig
from lsd_tpu_torch.slam.mapper import Mapper, MapperConfig
from lsd_tpu_torch.tools.profile_lio import nav_at_start

N = 4096
LIO = dict(ds_capacity=2048, map_capacity=2 ** 14, scan_voxel=0.4, map_voxel=0.4)
WORLD = dict(radius=8.0, omega=0.8, points_per_scan=N, point_noise=0.01, seed=21)
T_START = 1.037                      # off the mapped stamps, well into the cruise
SPEED = 8.0 * 0.8


@pytest.fixture(scope="module")
def world(tmp_path_factory, default_torch_threads):
    sim = CircleSim(SimConfig(n_scans=60, **WORLD))
    mapper = Mapper(MapperConfig(lio=TLioConfig(**LIO), keyframe_delta_trans=1.5,
                                 optimize_every=8, keyframe_cloud_cap=4096),
                    nav_at_start(sim, "cpu"))
    for k, d in enumerate(sim.generate(capacity=N, imu_capacity=16)):
        mapper.process_scan(*d[:5], stamp_us=int(k * 1e5))
    map_dir = str(tmp_path_factory.mktemp("maps") / "ring")
    mapper.save(map_dir)
    drive = CircleSim(SimConfig(n_scans=16, **WORLD))
    assert abs(np.linalg.norm(drive.velocity(T_START)) - SPEED) < 1e-6
    return map_dir, drive, drive.generate(capacity=N, imu_capacity=16, t_start=T_START)


def _run(world, side_lio, n_scans, **loc_kw):
    """Both localizers over the drive's first scans: (outputs of the
    reference, of the port, what each ``_lio_increment`` returned)."""
    map_dir, drive, scans = world
    jl = JL.Localizer(map_dir, JL.LocalizerConfig(lio=JLioConfig(max_iters=3, **LIO),
                                                  ndt_capacity=2 ** 13, **loc_kw))
    tl = TL.Localizer(map_dir, TL.LocalizerConfig(lio=TLioConfig(max_iters=3, **LIO),
                                                  ndt_capacity=2 ** 13, **loc_kw), device="cpu")
    R, p = drive.pose(T_START)
    hint = np.eye(4)
    hint[:3, :3], hint[:3, 3] = R, p + np.asarray([0.8, -0.5, 0.1])
    incs = {"j": [], "t": []}

    def recorded(inner, log):
        def call(*args):
            log.append(inner(*args))
            return log[-1]
        return call
    for name, loc in (("j", jl), ("t", tl)):
        loc.set_init_pose(hint)
        loc._lio_increment = recorded(loc._lio_increment, incs[name])
    jout, tout = [], []
    for k, (P, S, M, I, IM, _) in enumerate(scans[:n_scans]):
        t0 = T_START + k * 0.1
        smp = drive.imu_sample(t0)
        kw = dict(stamp_us=int(t0 * 1e6), imu_gyro=smp[1:4], imu_acc=smp[4:7] * 9.81)
        if side_lio:
            kw.update(stamps=S, imu=I, imu_mask=IM)
        jout.append(jl.process_scan(P, M, **kw))
        tout.append(tl.process_scan(P, M, **kw))
    return jout, tout, incs


def _errors(outs, truth):
    return np.asarray([np.linalg.norm(o["pose"][:3, 3] - t) for o, t in zip(outs, truth)])


def test_cold_side_lio_at_cruise_carries_both_off_the_map(world):
    _, _, scans = world
    n = 16
    jout, tout, incs = _run(world, True, n, track_capacity=2048)
    assert [o["status"] for o in tout] == [o["status"] for o in jout] \
        == ["initialized"] + ["tracking"] * (n - 1)
    for k, (a, b) in enumerate(zip(tout, jout)):
        np.testing.assert_allclose(a["pose"], b["pose"], rtol=0, atol=0.1, err_msg=str(k))
    # withheld for the 10 warm-up scans, then handed to the filter in both
    for name in ("j", "t"):
        assert all(o is None for o in incs[name][:10])
        assert all(o is not None for o in incs[name][10:])
    for k in range(10, n):
        (jq, jt), (tq, tt) = incs["j"][k], incs["t"][k]
        np.testing.assert_allclose(tt, np.asarray(jt), rtol=0, atol=5e-3)
        np.testing.assert_allclose(tq, np.asarray(jq), rtol=0, atol=5e-3)
        # the vehicle moved 0.64 m in its own frame; the cold filter's
        # increment is decimetres from that and still inside the 1.5 m bound
        true_dt = (np.linalg.inv(scans[k - 1][5]) @ scans[k][5])[:3, 3]
        assert abs(np.linalg.norm(true_dt) - SPEED * 0.1) < 0.01
        assert 0.1 < np.linalg.norm(tt - true_dt) and np.linalg.norm(tt) < 1.5
    # before the increments came in, IMU-driven prediction had caught up;
    # with them the pose leaves the map at ~0.5 m a scan, still "tracking"
    truth = [s[5][:3, 3] for s in scans[:n]]
    je, te = _errors(jout, truth), _errors(tout, truth)
    assert je[9] < 0.15 and te[9] < 0.15
    assert je[-1] > 2.0 and te[-1] > 2.0
    assert np.all(np.diff(je[9:]) > 0.2) and np.all(np.diff(te[9:]) > 0.2)


def test_cold_ukf_at_cruise_settles_metres_off_alike_on_a_thin_tracking_cloud(world):
    _, drive, scans = world
    n = 13
    jout, tout, incs = _run(world, False, n, track_capacity=512)
    assert [o["status"] for o in tout] == [o["status"] for o in jout] \
        == ["initialized"] + ["tracking"] * (n - 1)
    assert all(o is None for o in incs["j"] + incs["t"])
    for k, (a, b) in enumerate(zip(tout, jout)):
        np.testing.assert_allclose(a["pose"], b["pose"], rtol=0, atol=0.3, err_msg=str(k))
    # the raw sweep is matched, so the pose is held against the sweep's start
    truth = [drive.pose(T_START + k * 0.1)[1] for k in range(n)]
    je, te = _errors(jout, truth), _errors(tout, truth)
    assert np.all(je[6:] > 1.8) and np.all(te[6:] > 1.8)
