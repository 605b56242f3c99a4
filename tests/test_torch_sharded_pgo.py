"""Port parity for the distributed pose-graph solvers,
``parallel/sharded_pgo.py`` and ``parallel/schur_pgo.py``, on a gloo group
of 4 CPU ranks against the reference's on a 4-device virtual CPU mesh.

One group (spawned once for the module; the rank function is in
``tests/torch_ranks.py``) solves every graph.  Tolerances:
- ``optimize_sharded`` on ``tests/test_sharded_pgo.py``'s graphs against
  the reference's on a 4-device mesh: node positions atol 1e-3 (6 rounds
  of 40 float32 CG steps, the ranks' sums in other orders), and that
  test's own bars against ground truth;
- ``build_plan``'s arrays equal to the reference's (the same numpy);
- ``optimize_schur`` on ``tests/test_schur_pgo.py``'s graphs against the
  reference's on a 4-device mesh: positions and quaternion magnitudes atol
  5e-3, ``gps_inliers`` and ``n_sep`` equal; the mixed-stiffness graph of
  ``tests/test_numerics_hardening.py`` finite, at that test's bars.
- Either solver, given a graph that differs on one of 2 ranks, raises on
  every rank rather than hanging in a collective.
"""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from lsd_tpu.parallel import optimize_sharded as joptimize_sharded
from lsd_tpu.parallel import schur_pgo as jschur
from lsd_tpu.slam.posegraph import PgoConfig as JPgoConfig
from lsd_tpu_torch import convert
from lsd_tpu_torch.parallel import run_ranks
from lsd_tpu_torch.parallel.schur_pgo import build_plan
from lsd_tpu_torch.slam.posegraph import PgoConfig
from tests.test_posegraph import circle_graph
from tests.test_schur_pgo import _loop_graph

from tests import test_numerics_hardening, torch_ranks

WORLD = 4
CAPS = dict(node_cap=64, se3_cap=64, gps_cap=16)
SHARDED_CFG = dict(outer_iters=6, cg_iters=40)


def _tree(data):
    """A reference graph as nested dicts of numpy arrays."""
    return {part: {f: np.asarray(v) for f, v in getattr(data, part)._asdict().items()}
            for part in data._fields}


def _closed_circle():
    b, gt = circle_graph(n=40)
    n = b.num_nodes
    b.add_se3_edge(0, n - 1, np.linalg.inv(gt[0]) @ gt[-1], rot_info=400.0, trans_info=400.0)
    return b, gt


def _gps_outlier_circle():
    b, gt = circle_graph(n=20, drift=0.0)
    for k in range(0, b.num_nodes, 2):
        b.add_gps_prior(k, gt[k][:3, 3], info=10.0)
    b.add_gps_prior(10, gt[10][:3, 3] + np.asarray([50.0, 0, 0]), info=10.0)
    return b, gt


SCHUR_CASES = {"loops": (dict(), dict(outer_iters=6, cg_iters=120)),
               "drift": (dict(drift=0.05, with_priors=False), dict(outer_iters=6)),
               "outlier": (dict(with_outlier=True), dict(outer_iters=6))}


@pytest.fixture(scope="module")
def graphs():
    out = {"closed": _closed_circle(), "gps_outlier": _gps_outlier_circle()}
    out = {k: (b.to_data(**CAPS), gt) for k, (b, gt) in out.items()}
    for k, (kw, _) in SCHUR_CASES.items():
        out[k] = (_loop_graph(**kw).to_data(), None)
    out["stiff"] = (test_numerics_hardening.TestLargeGraphConditioning()._ill_graph(384).to_data(), None)
    return out


@pytest.fixture(scope="module")
def ranks(graphs):
    jobs = [(_tree(graphs["closed"][0]), "sharded", PgoConfig(**SHARDED_CFG)),
            (_tree(graphs["gps_outlier"][0]), "sharded", PgoConfig(**SHARDED_CFG))]
    jobs += [(_tree(graphs[k][0]), "schur", PgoConfig(**cfg))
             for k, (_, cfg) in SCHUR_CASES.items()]
    jobs.append((_tree(graphs["stiff"][0]), "schur", PgoConfig(outer_iters=4, cg_iters=40)))
    outs = run_ranks(torch_ranks.pgo_runs, WORLD, args=(jobs,), backend="gloo")
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            np.testing.assert_array_equal(a["pos"], b["pos"])
    names = ["closed", "gps_outlier", *SCHUR_CASES, "stiff"]
    return dict(zip(names, outs[0]))


def _jmesh():
    return JMesh(np.array(jax.devices()[:WORLD]), ("dp",))


@pytest.mark.parametrize("name", ["closed", "gps_outlier"])
def test_sharded_pgo_matches_reference(graphs, ranks, name):
    data, gt = graphs[name]
    want = joptimize_sharded(data, _jmesh(), JPgoConfig(**SHARDED_CFG))
    n = int(np.asarray(data.nodes.mask).sum())
    got = ranks[name]["pos"][:n]
    np.testing.assert_allclose(got, np.asarray(want.nodes.pos)[:n], atol=1e-3)
    errs = np.linalg.norm(got - np.stack([T[:3, 3] for T in gt[:n]]), axis=1)
    if name == "closed":
        assert errs.max() < 0.4
    else:
        assert errs[10] < 0.3


@pytest.mark.parametrize("name", list(SCHUR_CASES))
def test_build_plan_matches_reference(graphs, name):
    data = graphs[name][0]
    want = jschur.build_plan(data, WORLD)
    got = build_plan(convert.graph_from_numpy(_tree(data), "cpu"), WORLD)
    assert got._fields == want._fields
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("name", list(SCHUR_CASES))
def test_schur_matches_reference(graphs, ranks, name):
    data = graphs[name][0]
    want, info = jschur.optimize_schur(data, _jmesh(), JPgoConfig(**SCHUR_CASES[name][1]))
    got = ranks[name]
    np.testing.assert_allclose(got["pos"], np.asarray(want.nodes.pos), atol=5e-3)
    np.testing.assert_allclose(np.abs(got["quat"]), np.abs(np.asarray(want.nodes.quat)),
                               atol=5e-3)
    assert got["gps_inliers"] == int(info["gps_inliers"])
    assert got["n_sep"] == info["n_sep"] >= 6
    assert set(got["keys"]) == set(info)
    # the reference test's own bars
    if name == "drift":
        assert abs(float(got["pos"][95, 1])) < 0.1 < abs(float(np.asarray(data.nodes.pos)[95, 1]))
    if name == "outlier":
        assert got["gps_inliers"] == int(np.asarray(data.gps.mask).sum()) - 1
        assert abs(float(got["pos"][32, 1])) < 1.0


def test_schur_mixed_stiffness_finite(ranks):
    pos = ranks["stiff"]["pos"][:384]
    assert np.isfinite(pos).all() and np.isfinite(ranks["stiff"]["quat"][:384]).all()
    assert abs(float(pos[383, 0]) - 2.0 * 383) < 2.0


@pytest.mark.parametrize("which", ["sharded", "schur"])
def test_ranks_with_different_graphs_raise(graphs, which):
    with pytest.raises(RuntimeError, match="2 of 2 ranks failed") as err:
        run_ranks(torch_ranks.pgo_planted, 2, args=(_tree(graphs["closed"][0]), which),
                  backend="gloo", timeout_s=120.0)
    assert str(err.value).count(f"optimize_{which}: the 2 ranks hold different inputs") == 2
