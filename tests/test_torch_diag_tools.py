"""Port parity for the diagnostics ``lsd_tpu_torch/tools/{campaign_diag,
loc_diag}.py``, on the CPU, on a small saved map of the figure-eight world
(radius 8 m, half a lap) made in ``tmp_path``: each keyframe the
simulator's scan at its true pose, the poses saved with noise, odometry
edges from noisy relative truth and loop edges (one of them an outlier)
between keyframes 6 apart.

- ``campaign_diag.rebuild``: the same graph data as the reference's (every
  array equal), with and without the loop edges, with fixed information.
- ``campaign_diag``'s five ablations and its loop-edge check: every ATE
  within 1e-4 m of the reference's ``main`` on the same map; the counts
  equal.
- ``loc_diag.run`` over a recording of that world (``tools/campaign.py:
  make_recording``): one row per frame, the summary's keys.
"""
import numpy as np
import pytest

import jax
from lsd_tpu.tools import campaign_diag as jdiag
from lsd_tpu_torch import convert
from lsd_tpu_torch import sim as tsim
from lsd_tpu_torch.slam import map_io as tmio
from lsd_tpu_torch.tools import campaign_diag as tdiag
from lsd_tpu_torch.tools import loc_diag as tloc_diag

LAPS, RADIUS, SPEED, POINTS = 0.5, 8.0, 5.0, 2048
ATE_ATOL = 1e-4


def _world():
    """The figure-eight world ``campaign_diag.gt_for_stamps`` rebuilds."""
    n = int((1.5 + 2.0 + 4 * np.pi * RADIUS * LAPS / SPEED) * 10)
    return tsim.FigureEightSim(
        tsim.SimConfig(radius=RADIUS, speed=SPEED, points_per_scan=POINTS, point_noise=0.01,
                       rest_time=1.5, ramp_time=2.0, seed=7, n_scans=n),
        laps=LAPS, gps_noise=0.05, gps_outlier_rate=0.02, gps_hz=10.0)


def _rel(a, b):
    return np.linalg.inv(a) @ b


def _jitter(T, rng, t_sigma, r_sigma):
    from lsd_tpu_torch.geometry import np_so3
    out = T.copy()
    out[:3, :3] = T[:3, :3] @ np_so3.exp_so3(rng.normal(0, r_sigma, 3))
    out[:3, 3] += rng.normal(0, t_sigma, 3)
    return out


@pytest.fixture(scope="module")
def saved_map(tmp_path_factory):
    root = tmp_path_factory.mktemp("diag")
    sim = _world()
    rng = np.random.default_rng(5)
    stamps, gts, clouds = [], [], []
    for k in range(10, int(sim.duration() * 10) - 1, 4):
        t0 = k * 0.1
        pts, _ = sim.scan(t0)
        R, p = sim.pose(t0 + 0.1)
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, p
        stamps.append(1_000_000 + int(round(t0 * 1e6)))
        gts.append(T)
        clouds.append(np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1))
    poses = [_jitter(T, rng, 0.05, 0.005) for T in gts]
    edges = [(i, i + 1, _jitter(_rel(gts[i], gts[i + 1]), rng, 0.02, 0.002),
              np.full(6, 400.0)) for i in range(len(gts) - 1)]
    for i in range(0, len(gts) - 6, 5):
        edges.append((i, i + 6, _jitter(_rel(gts[i], gts[i + 6]), rng, 0.01, 0.001),
                      rng.uniform(50.0, 400.0, 6)))
    edges.append((1, 9, _jitter(_rel(gts[1], gts[9]), rng, 1.5, 0.1), np.full(6, 200.0)))
    map_dir = str(root / "map")
    tmio.save_map(map_dir, np.asarray([sim.LAT0, sim.LON0, 0.0]), stamps, poses, clouds,
                  edges=edges, fixed=[0])
    return map_dir, sim, root


@pytest.mark.parametrize("use_loops,keep_info", [(False, True), (True, True), (True, False)])
def test_rebuild_equal(saved_map, use_loops, keep_info):
    md = tmio.load_map(saved_map[0])
    bj, chain_j, loops_j = jdiag.rebuild(md, use_loops, keep_info)
    bt, chain_t, loops_t = tdiag.rebuild(md, use_loops, keep_info)
    np.testing.assert_array_equal(np.stack(chain_t), np.stack(chain_j))
    assert len(loops_t) == len(loops_j) >= 5
    want = bj.to_data()
    got = convert.graph_to_numpy(bt.to_data(device="cpu"))
    assert list(got) == list(want._fields)
    for part, fields in got.items():
        assert list(fields) == list(getattr(want, part)._fields)
        for f, g in fields.items():
            w = np.asarray(getattr(getattr(want, part), f))
            assert g.dtype == w.dtype, (part, f)
            np.testing.assert_array_equal(g, w, err_msg=f"{part}.{f}")


def test_ablations_match(saved_map):
    map_dir = saved_map[0]
    cache_dir = jax.config.jax_compilation_cache_dir
    try:
        want = jdiag.main(["--map", map_dir, "--laps", str(LAPS), "--radius", str(RADIUS),
                           "--speed", str(SPEED), "--points", str(POINTS)])
    finally:
        # the reference's main points JAX's cache elsewhere
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    got = tdiag.diagnose(map_dir, LAPS, RADIUS, SPEED, POINTS, device="cpu")
    assert got.keys() == want.keys()
    for key, w in want.items():
        if not isinstance(w, dict):
            assert got[key] == pytest.approx(w, abs=ATE_ATOL), key
            continue
        for k2, v in w.items():
            assert got[key][k2] == pytest.approx(v, abs=ATE_ATOL), (key, k2)
    assert want["odom_plus_loops_dcs"]["n_loops"] >= 5


def test_loc_diag_runs(saved_map):
    from lsd_tpu_torch.tools.campaign import make_recording
    map_dir, sim, root = saved_map
    make_recording(sim, str(root / "rec"), t_start=4.0, n_scans=12, capacity=POINTS)
    rows, summ = tloc_diag.run(map_dir, str(root / "rec"), lio_fusion=True, max_frames=12,
                               out=str(root / "diag.jsonl"), progress=lambda m: None,
                               device="cpu")
    assert len(rows) == 12 and len(open(root / "diag.jsonl").readlines()) == 12
    assert set(summ) == {"frames", "scored", "tracked", "inc_used", "wall_s", "rmse_x",
                         "rmse_y", "rmse_h", "inc_et_mean", "inc_et_p95", "inc_er_mean"}
    assert summ["frames"] == 12
    assert all({"k", "t", "status", "matched", "inc_used", "gps"} <= set(r) for r in rows)
