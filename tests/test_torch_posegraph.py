"""Port parity: ``PoseGraphBuilder`` and the robust solver of
lsd_tpu_torch against lsd_tpu on the CPU.

One graph, made with numpy from a seed, goes through both packages'
``PoseGraphBuilder`` and solvers: a noisy 48-node circle with odometry
edges, one right and one grossly wrong loop edge, GPS priors on every
fourth node with one gross outlier, floor priors and orientation priors.
Tolerances, each with its reason:
- padded arrays from ``to_data``: equal (the same numpy code pads them);
- residuals and Huber weights at a random perturbation: atol 1e-4 on
  whitened values of up to a few hundred (float32 rounding of another
  operation order), rtol 1e-5;
- Jacobian blocks: atol 1e-5 with unit information and
  rtol 1e-5 of the largest entry with the graph's own sqrt information
  (entries of up to 200, where one float32 ulp is already 1.5e-5); finite
  at d = 0 for identity rotations;
- node poses after ``optimize``: atol 1e-4 (m and quaternion
  components, 6 rounds of 50 CG steps in float32), ``gps_inliers`` equal,
  costs rtol 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.slam import graph_builder as jgb
from lsd_tpu.slam import posegraph as jpg
from lsd_tpu_torch import convert
from lsd_tpu_torch.geometry import np_so3
from lsd_tpu_torch.slam import graph_builder as tgb
from lsd_tpu_torch.slam import posegraph as tpg

N = 48


def _pose(R, p):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, p
    return T


def _fill(builder, seed=0, unit_info=False):
    """The same factors into either package's builder."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi * 1.1, N)
    gt = [_pose(np_so3.rpy_to_matrix(0.02 * np.sin(3 * a), 0.03 * np.cos(2 * a), a + np.pi / 2),
                [10 * np.cos(a), 10 * np.sin(a), 1.8 + 0.1 * np.sin(a)]) for a in th]
    # initial estimates: ground truth with drift growing along the path
    est = []
    drift = np.eye(4)
    for k, T in enumerate(gt):
        step = _pose(np_so3.exp_so3(rng.normal(0, 2e-3, 3)), rng.normal(0, 0.02, 3))
        drift = drift @ step
        est.append(T @ drift)
        builder.add_node(est[-1], fixed=(k == 0))
    ri, ti = (1.0, 1.0) if unit_info else (4.0e4, 1.0e4)
    for k in range(1, N):
        T_rel = np.linalg.inv(gt[k - 1]) @ gt[k] @ _pose(
            np_so3.exp_so3(rng.normal(0, 1e-3, 3)), rng.normal(0, 5e-3, 3))
        builder.add_se3_edge(k - 1, k, T_rel, rot_info=ri, trans_info=ti)
    # a right loop edge (anisotropic information) and a grossly wrong one
    builder.add_se3_edge(2, N - 3, np.linalg.inv(gt[2]) @ gt[N - 3],
                         rot_info=np.array([300.0, 200.0, 400.0]),
                         trans_info=np.array([400.0, 50.0, 350.0]))
    wrong = np.linalg.inv(gt[5]) @ gt[30] @ _pose(np_so3.exp_so3([0, 0, 0.4]), [3.0, -2.0, 0.5])
    builder.add_se3_edge(5, 30, wrong, rot_info=200.0, trans_info=200.0)
    for k in range(0, N, 4):
        xyz = gt[k][:3, 3] + rng.normal(0, 0.05, 3)
        if k == 20:
            xyz = xyz + np.array([15.0, -9.0, 0.0])          # gross outlier
        builder.add_gps_prior(k, xyz, xy_only=(k % 8 == 0), info=4.0)
    for k in range(3, N, 7):
        builder.add_floor_prior(k, 1.8, z_info=25.0, tilt_info=10.0)
    for k in range(1, N, 9):
        builder.add_orientation_prior(k, np_so3.matrix_to_quat(gt[k][:3, :3]).astype(np.float32),
                                      info=1.0)
    builder.add_orientation_prior(6, gt[6], info=2.0)         # the 4x4 form
    return gt


@pytest.fixture(scope="module")
def graphs():
    jb, tb = jgb.PoseGraphBuilder(), tgb.PoseGraphBuilder()
    gt = _fill(jb)
    _fill(tb)
    return jb, tb, jb.to_data(), tb.to_data(device="cpu"), gt


def _leaves(tgraph):
    return [x for part in tgraph for x in part]


def test_to_data_pads_the_same_arrays(graphs):
    _, _, jd, td, _ = graphs
    assert td.nodes.quat.shape[0] == 64 and td.se3.idx.shape[0] == 64      # powers of two
    assert td.gps.idx.shape[0] == 16 and td.floor.idx.shape[0] == 8
    for a, b in zip(_leaves(td), jax.tree.leaves(jd)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_to_data_of_an_empty_builder_and_explicit_caps():
    jd = jgb.PoseGraphBuilder().to_data()
    td = tgb.PoseGraphBuilder().to_data(device="cpu")
    for a, b in zip(_leaves(td), jax.tree.leaves(jd)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tb = tgb.PoseGraphBuilder()
    _fill(tb)
    td = tb.to_data(node_cap=100, se3_cap=70, gps_cap=12, floor_cap=9, orient_cap=7, device="cpu")
    assert [x.shape[0] for x in (td.nodes.quat, td.se3.idx, td.gps.idx, td.floor.idx,
                                 td.orient.idx)] == [100, 70, 12, 9, 7]


def test_graph_carried_across_by_convert(graphs):
    _, _, jd, td, _ = graphs
    got = convert.graph_from_numpy(jax.device_get(jd), "cpu")
    for a, b in zip(_leaves(got), _leaves(td)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    d = convert.graph_to_numpy(td)
    back = jpg.PoseGraphData(
        nodes=jpg.GraphNodes(**{k: jnp.asarray(v) for k, v in d["nodes"].items()}),
        se3=jpg.Se3Edges(**{k: jnp.asarray(v) for k, v in d["se3"].items()}),
        gps=jpg.GpsPriors(**{k: jnp.asarray(v) for k, v in d["gps"].items()}),
        floor=jpg.FloorPriors(**{k: jnp.asarray(v) for k, v in d["floor"].items()}),
        orient=jpg.OrientPriors(**{k: jnp.asarray(v) for k, v in d["orient"].items()}))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jd)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_empty_graph_matches():
    jg = jpg.empty_graph(8, 16, n_gps=4, n_orient=3)
    tg = tpg.empty_graph(8, 16, n_gps=4, n_orient=3, device="cpu")
    for a, b in zip(_leaves(tg), jax.tree.leaves(jg)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_config_fields_carry_over():
    assert tpg.PgoConfig._fields == jpg.PgoConfig._fields
    assert tuple(tpg.PgoConfig()) == tuple(jpg.PgoConfig())


@pytest.mark.parametrize("name", ["se3", "gps", "floor", "orient"])
def test_residuals_match(graphs, name):
    _, _, jd, td, _ = graphs
    dx = np.random.default_rng(1).normal(0, 0.02, (64, 6)).astype(np.float32)
    jr = getattr(jpg, f"_{name}_residual")(jd.nodes, getattr(jd, name), jnp.asarray(dx))
    tr = getattr(tpg, f"_{name}_residual")(td.nodes, getattr(td, name), torch.as_tensor(dx))
    assert float(np.abs(np.asarray(jr)).max()) > 0.01
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(tpg._huber_weights(tr, 1.0).numpy(),
                               np.asarray(jpg._huber_weights(jr, 1.0)), atol=1e-5)


def _blocks(jd, td, seed=2):
    rng = np.random.default_rng(seed)
    rw_se3 = rng.uniform(0.2, 1.0, jd.se3.mask.shape[0]).astype(np.float32)
    rw_gps = rng.uniform(0.2, 1.0, jd.gps.mask.shape[0]).astype(np.float32)
    jb = jpg._linearize_blocks(jd, jd.nodes, jnp.asarray(rw_se3), jnp.asarray(rw_gps))
    tb = tpg._linearize_blocks(td, td.nodes, torch.as_tensor(rw_se3), torch.as_tensor(rw_gps))
    return jb, tb


def test_jacobian_blocks_match_with_unit_information():
    jb_, tb_ = jgb.PoseGraphBuilder(), tgb.PoseGraphBuilder()
    _fill(jb_, unit_info=True)
    _fill(tb_, unit_info=True)
    jd, td = jb_.to_data(), tb_.to_data(device="cpu")
    # the odometry edges carry unit information; the priors keep theirs (<= 5)
    jb, tb = _blocks(jd, td)
    for (jJ, jr), (tJ, tr), shape in zip(jb, tb, [(64, 6, 12), (16, 3), (8, 3, 6), (8, 6, 6)]):
        assert tuple(tJ.shape) == shape == tuple(jJ.shape)
        np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), atol=1e-5 * max(
            1.0, float(np.abs(np.asarray(jJ)).max()) / 5.0))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4, rtol=1e-5)


def test_jacobian_blocks_match_whitened(graphs):
    _, _, jd, td, _ = graphs
    jb, tb = _blocks(jd, td)
    for (jJ, jr), (tJ, tr) in zip(jb, tb):
        jJ = np.asarray(jJ)
        np.testing.assert_allclose(tJ.numpy(), jJ, atol=1e-5 * max(1.0, float(np.abs(jJ).max())))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4, rtol=1e-5)


def test_jacobians_are_finite_at_identity():
    """d = 0 on identity rotations: the safe-norm / sinc path of so3."""
    tg = tpg.empty_graph(4, 4, n_floor=2, n_orient=2, device="cpu")
    on = lambda part: part._replace(mask=torch.ones_like(part.mask))
    tg = tg._replace(nodes=on(tg.nodes), se3=on(tg.se3)._replace(
        idx=torch.tensor([[0, 1], [1, 2], [2, 3], [0, 3]], dtype=torch.int32)),
        floor=on(tg.floor), orient=on(tg.orient))
    jg = jpg.PoseGraphData(*[type(jp)(*[jnp.asarray(x.numpy()) for x in tp])
                             for jp, tp in zip(jpg.empty_graph(4, 4, n_floor=2, n_orient=2), tg)])
    ones = lambda n: (torch.ones(n), jnp.ones(n))
    tb = tpg._linearize_blocks(tg, tg.nodes, ones(4)[0], ones(1)[0])
    jb = jpg._linearize_blocks(jg, jg.nodes, ones(4)[1], ones(1)[1])
    for (jJ, jr), (tJ, tr) in zip(jb, tb):
        assert bool(torch.isfinite(tJ).all()) and bool(torch.isfinite(tr).all())
        np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), atol=1e-6)


def test_optimize_matches(graphs):
    _, _, jd, td, gt = graphs
    jout, jinfo = jpg.optimize(jd, jpg.PgoConfig())
    tout, tinfo = tpg.optimize(td, tpg.PgoConfig())
    np.testing.assert_allclose(tout.nodes.pos.numpy(), np.asarray(jout.nodes.pos), atol=1e-4)
    np.testing.assert_allclose(tout.nodes.quat.numpy(), np.asarray(jout.nodes.quat), atol=1e-4)
    assert int(tinfo["gps_inliers"]) == int(jinfo["gps_inliers"]) == 11     # 12 less the outlier
    np.testing.assert_array_equal(tout.gps.mask.numpy(), np.asarray(jout.gps.mask))
    assert not bool(tout.gps.mask[5])                                       # node 20's prior
    costs = tinfo["costs"].numpy()
    np.testing.assert_allclose(costs, np.asarray(jinfo["costs"]), rtol=1e-3)
    assert costs.shape == (6,) and costs[-1] < costs[0] and np.isfinite(costs).all()
    # the solve did its job: closer to the ground truth than the drifted start,
    # the wrong loop edge notwithstanding
    gt_pos = np.stack([T[:3, 3] for T in gt])
    err0 = np.linalg.norm(td.nodes.pos.numpy()[:N] - gt_pos, axis=1).mean()
    err1 = np.linalg.norm(tout.nodes.pos.numpy()[:N] - gt_pos, axis=1).mean()
    assert err1 < 0.5 * err0 and err1 < 0.1
    # padding and the fixed node stay put
    np.testing.assert_array_equal(tout.nodes.pos.numpy()[N:], td.nodes.pos.numpy()[N:])
    np.testing.assert_array_equal(tout.nodes.pos.numpy()[0], td.nodes.pos.numpy()[0])


def test_optimize_without_dcs_and_with_few_iterations_matches(graphs):
    _, _, jd, td, _ = graphs
    kw = dict(outer_iters=2, cg_iters=10, dcs_phi=0.0, gps_chi2_gate=1e9)
    jout, jinfo = jpg.optimize(jd, jpg.PgoConfig(**kw))
    tout, tinfo = tpg.optimize(td, tpg.PgoConfig(**kw))
    np.testing.assert_allclose(tout.nodes.pos.numpy(), np.asarray(jout.nodes.pos), atol=1e-4)
    np.testing.assert_allclose(tout.nodes.quat.numpy(), np.asarray(jout.nodes.quat), atol=1e-4)
    assert int(tinfo["gps_inliers"]) == int(jinfo["gps_inliers"]) == 12


def test_update_from_and_node_pose_match(graphs):
    jb, tb, jd, td, _ = graphs
    jb2, tb2 = jgb.PoseGraphBuilder(), tgb.PoseGraphBuilder()
    _fill(jb2)
    _fill(tb2)
    jout, _ = jpg.optimize(jd, jpg.PgoConfig(outer_iters=1, cg_iters=5))
    tout, _ = tpg.optimize(td, tpg.PgoConfig(outer_iters=1, cg_iters=5))
    jb2.update_from(jout, n_nodes=40)
    tb2.update_from(tout, n_nodes=40)
    for i in (0, 7, 39, 40, 47):
        np.testing.assert_allclose(tb2.node_pose(i), jb2.node_pose(i), atol=1e-4)
    np.testing.assert_array_equal(tb2.node_pose(45), tb.node_pose(45))    # beyond n_nodes
    tb2.set_node_pose(3, np.eye(4))
    tb2.set_fixed(3)
    tb2.del_se3_edge(0)
    assert tb2.fixed[3] and len(tb2.se3) == len(tb.se3) - 1
    np.testing.assert_array_equal(tb2.node_pose(3), np.eye(4, dtype=np.float32))
