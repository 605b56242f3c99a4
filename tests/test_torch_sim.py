"""Port parity: the simulators of ``lsd_tpu_torch/sim.py`` against
``lsd_tpu/sim.py``.

Both packages' simulators are numpy; the port's copy must make every
random draw in the reference's order, so for the same config and seed the
world, the scans, the IMU rows, the poses, the velocities and the GNSS
fixes (noise, outlier test, outlier size and sign, only on the frames that
carry a fix) are byte-equal.  Tolerance: none (``tobytes`` equality, and
``==`` on the fix dicts).
"""
import numpy as np
import pytest

from lsd_tpu import sim as jsim
from lsd_tpu_torch import sim as tsim

SCANS, POINTS = 4, 2048


def _corridor(mod, density):
    return mod.CorridorSim(mod.SimConfig(n_scans=SCANS, points_per_scan=POINTS,
                                         point_noise=0.01, acc_noise=0.01, gyro_noise=0.001,
                                         seed=6, rest_time=0.1, ramp_time=0.2,
                                         feature_density=density))


def _fig8(mod):
    return mod.FigureEightSim(mod.SimConfig(radius=8.0, speed=5.0, n_scans=SCANS,
                                            points_per_scan=POINTS, point_noise=0.01,
                                            acc_noise=0.01, seed=3, rest_time=0.1,
                                            ramp_time=0.2),
                              laps=0.3, gps_noise=0.05, gps_outlier_rate=0.4, gps_hz=10.0)


def _route(mod):
    return mod.RouteSim(mod.SimConfig(speed=5.0, n_scans=SCANS, points_per_scan=POINTS,
                                      point_noise=0.01, seed=7, rest_time=0.1, ramp_time=0.2),
                        width=60.0, height=30.0, corner=8.0, laps=0.2, gps_noise=0.02,
                        gps_hz=10.0)


SIMS = {"corridor": lambda m: _corridor(m, 1.0), "tunnel": lambda m: _corridor(m, 0.0),
        "fig8_outliers": _fig8, "route": _route}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(SIMS))
def test_sim_is_byte_equal_to_reference(name):
    j, t = SIMS[name](jsim), SIMS[name](tsim)
    _same(j.world, t.world)
    for dj, dt in zip(j.generate(capacity=POINTS, imu_capacity=16),
                      t.generate(capacity=POINTS, imu_capacity=16), strict=True):
        for a, b in zip(dj, dt, strict=True):
            _same(a, b)
    # along the route: through the ramp, the cruise, and (fig8, route) the
    # turns and the second lobe or the corners
    times = np.linspace(0.0, 9.0, 37)
    for tt in times:
        for a, b in zip(j.pose(tt), t.pose(tt), strict=True):
            _same(a, b)
        _same(j.velocity(tt), t.velocity(tt))
        _same(j.imu_sample(tt), t.imu_sample(tt))
    assert j.duration() == t.duration()
    if hasattr(j, "ins_sample_dict"):
        fixes = [(j.ins_sample_dict(tt, int(tt * 1e6)), t.ins_sample_dict(tt, int(tt * 1e6)))
                 for tt in times]
        assert [a for a, _ in fixes] == [b for _, b in fixes]
    # the generators are in the same state afterwards
    _same(j.rng.random(4), t.rng.random(4))
    if hasattr(j, "_gps_rng"):
        _same(j._gps_rng.random(4), t._gps_rng.random(4))
