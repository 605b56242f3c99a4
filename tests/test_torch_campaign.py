"""Port parity for the campaign's distributed merge and its entry points:
``tools/campaign.py:merge_distributed`` on a gloo group of 2 CPU ranks
against the reference's ``merge_distributed`` (8 virtual CPU devices), and
``tools/campaign_merge.py``'s command line.

The two maps are ``tests/test_map_merge.py``'s two sessions of one world,
mapped by the port.  Tolerances: the same number of cross edges and
keyframes, no fallback to the single-device solver, rank 0 alone building
the joint graph (the other rank receives it), and the saved merged
node positions within 1e-3 m of the reference's (measured 2.6e-4 m: the
cross edges come from ICP in float32 in either package); the command line
saves what the rank function saves.
"""
import json

import numpy as np
import pytest
import torch
from lsd_tpu.tools.campaign import merge_distributed as jmerge_distributed
from lsd_tpu_torch.parallel import run_ranks
from lsd_tpu_torch.sim import CircleSim, SimConfig
from lsd_tpu_torch.slam import map_io as tmio
from lsd_tpu_torch.slam.lio import LioConfig, lio_init
from lsd_tpu_torch.slam.mapper import Mapper, MapperConfig
from lsd_tpu_torch.tools import campaign_merge
from lsd_tpu_torch.tools.profile_lio import nav_at_start

from tests import torch_ranks

TIMES = ("schur_wall_s", "schur_compile_plus_first_round_s", "schur_solve_round_ms",
         "schur_solve_total_s")


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """``tests/test_map_merge.py``'s two sessions of one world, the second
    starting 2 s later, mapped by the port."""
    root = tmp_path_factory.mktemp("sessions")
    out = []
    for name, t_offset in (("a", 0.0), ("b", 2.0)):
        sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=45, points_per_scan=8192,
                                  seed=33))
        data = sim.generate(capacity=8192, imu_capacity=16, t_start=t_offset)
        m = Mapper(MapperConfig(lio=LioConfig(ds_capacity=4096, map_capacity=2 ** 16,
                                              scan_voxel=0.4, map_voxel=0.4),
                                keyframe_delta_trans=1.5, optimize_every=100),
                   nav_at_start(sim, "cpu") if t_offset == 0.0 else None, device="cpu")
        if t_offset:
            from lsd_tpu_torch.geometry import so3
            from lsd_tpu_torch.slam.state import init_state
            R, p = sim.pose(t_offset)
            f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
            m.lio_state = lio_init(m.cfg.lio, init_state(device="cpu")._replace(
                pos=f(p), quat=so3.matrix_to_quat(f(R)), vel=f(sim.velocity(t_offset))))
        for k, (P, S, M, I, IM, _) in enumerate(data):
            m.process_scan(P, S, M, I, IM, stamp_us=int((t_offset + k * 0.1) * 1e6))
        m.save(str(root / name))
        out.append(str(root / name))
    return out


@pytest.fixture(scope="module")
def merged(sessions, tmp_path_factory):
    """The reference's merge (8 devices) and the port's on 2 gloo ranks."""
    map_a, map_b = sessions
    root = tmp_path_factory.mktemp("merged")
    want = jmerge_distributed(map_a, map_b, str(root / "j"))
    got = run_ranks(torch_ranks.merge_counting, 2, args=(map_a, map_b, str(root / "t")),
                    backend="gloo")
    calls = [g.pop("merge_maps_calls") for g in got]
    return want, got, root, calls


def test_merge_distributed_matches_reference(merged):
    want, got, root, calls = merged
    assert calls == [1, 0]            # rank 0 builds the joint graph, rank 1 receives it
    assert got[0] == got[1] | {k: got[0][k] for k in TIMES}
    rep = got[0]
    assert rep["cross_edges"] == want["cross_edges"] >= 2
    assert (rep["n_a"], rep["n_b"]) == (want["n_a"], want["n_b"])
    assert rep["schur_devices"] == 2 and rep["single_host_fallback"] is False
    assert want["single_host_fallback"] is False
    tp = np.stack(tmio.load_map(str(root / "t"))["poses"])
    jp = np.stack(tmio.load_map(str(root / "j"))["poses"])
    assert tp.shape == jp.shape == (rep["n_a"] + rep["n_b"], 4, 4)
    np.testing.assert_allclose(tp[:, :3, 3], jp[:, :3, 3], atol=1e-3)


def test_campaign_merge_cli(sessions, merged, tmp_path):
    """The command line on 2 ranks saves and reports what the rank
    function does."""
    map_a, map_b = sessions
    _, got, root, _ = merged
    out_json = tmp_path / "merge.json"
    rep = campaign_merge.main([map_a, map_b, str(tmp_path / "cli"), str(out_json),
                               "--ranks", "2"])
    assert json.loads(out_json.read_text()) == rep
    assert {k: v for k, v in rep.items() if k not in TIMES} == \
        {k: v for k, v in got[0].items() if k not in TIMES}
    np.testing.assert_allclose(np.stack(tmio.load_map(str(tmp_path / "cli"))["poses"]),
                               np.stack(tmio.load_map(str(root / "t"))["poses"]), atol=1e-6)
