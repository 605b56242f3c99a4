"""The traffic generators repeat byte for byte for one seed; the circle's
world does not change with the seed."""
import json

import numpy as np

from port_bench.gen import circle, street
from port_bench.harness import BENCH_DIR

LAP = dict(json.loads((BENCH_DIR / "traffic" / "circle-lap-32k.json").read_text()),
           scans_per_lap=6)
DRIVE = dict(json.loads((BENCH_DIR / "traffic" / "urban-drive-64beam.json").read_text()),
             frames=3, points_per_frame=8192, objects_in_range=4, walls_per_100m=1,
             poles_per_100m=2)
BIG = 2 ** 31 + 12345


def test_lap_repeats_for_a_seed():
    a, sa = circle.lap(LAP, BIG, 2048, 16)
    b, sb = circle.lap(LAP, BIG, 2048, 16)
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()
    assert all(np.array_equal(x, y) for x, y in zip(sa, sb))


def test_lap_world_is_the_same_for_every_seed():
    w1 = circle.build_world(LAP["radius_m"], LAP["world_seed"])
    assert w1.tobytes() == circle.build_world(LAP["radius_m"], LAP["world_seed"]).tobytes()
    a = circle.Circle(10.0, 0.25, LAP["world_seed"], 1, 2048)
    b = circle.Circle(10.0, 0.25, LAP["world_seed"], BIG, 2048)
    assert a.world.tobytes() == b.world.tobytes()
    assert a.scan(0.0)[0].tobytes() != b.scan(0.0)[0].tobytes()


def test_lap_closes_on_a_whole_scan():
    k = LAP["scans_per_lap"]
    sim = circle.Circle(LAP["radius_m"], 2 * np.pi / (k / 10.0), LAP["world_seed"], 0, 16)
    R0, p0 = sim.pose(0.0)
    R1, p1 = sim.pose(k / 10.0)
    assert np.allclose(R0, R1, atol=1e-9) and np.allclose(p0, p1, atol=1e-9)


def test_drive_repeats_for_a_seed_and_fills_every_frame():
    f1, m1, n1 = street.drive(DRIVE, BIG)
    f2, m2, n2 = street.drive(DRIVE, BIG)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(f1, f2)) and n1 == n2
    # the motion as the INS source gives it: this frame's pose in the last one's
    assert np.array_equal(m1, m2) and m1[0, 3] == DRIVE["speed_mps"] * DRIVE["dt_s"]
    assert all(f.shape == (DRIVE["points_per_frame"], 4) for f in f1)
    f3, _, _ = street.drive(DRIVE, BIG + 1)
    assert f3[0].tobytes() != f1[0].tobytes()


def test_an_object_returns_what_the_beams_see():
    # a 4.5 x 1.6 m side facing the sensor from 20 m: 7.2 m^2 over the solid
    # angle of one return of 64 beams over 26.9 degrees and 1024 columns
    rng = np.random.default_rng(0)
    sensor = np.asarray([0.0, 0.0, 0.8])
    pts = street._beam_returns(rng, (1.9, 4.5, 1.6), np.eye(3), np.asarray([20.0, 0.0, 0.8]),
                               sensor, DRIVE)
    cell = (2 * np.pi / 1024) * np.radians(26.9) / 63
    assert abs(len(pts) - 7.2 / (19.05 ** 2 * cell)) <= 1
    assert np.allclose(pts[:, 0], 19.05)
