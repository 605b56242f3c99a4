"""The port's CUDA kernels on the card (skipped where there is none).

This file imports only torch and numpy, so it runs on a machine with a card
and no JAX.  Run it there with

    python -m pytest tests/test_torch_cuda.py -m cuda -o addopts="" --noconftest -q

(``--noconftest``: the suite's conftest sets up JAX).  Each kernel is held
against its plain PyTorch version on the card.  Tolerances for
``p2p_reduce``: HtH within 1e-5 * max|HtH| and Htr within
1e-4 * max(|Htr|, 1) (the kernel sums in a fixed block order, the plain
version through a matmul); n_valid exact (both round each operation alike,
the kernel being built without FMA contraction); two launches bitwise equal,
and so a CUDA-graph replay and a direct call.  Each call is one launch of
the kernel.

The mapping path's PyTorch ops run on the card as on the CPU:
``hashmap_insert`` gives the same integers and points (integer scatter-min
and scatter-add are order-free), ``optimize`` and ``icp_point_to_plane`` the
same poses within atol 1e-4 (float atomics in the scatter-adds and another
order of the reductions; 2e-3 for ICP against a raw-point target, whose
plane fits are ill-conditioned in float32), and neither makes a host sync.

The localization path: ``ndt_build`` gives the same keys and counts (integer
scatter-min), means within 1e-4 and an inverse covariance whose Mahalanobis
distances agree within 2e-2 for 99 % of the voxels (float atomics in the
sums; the covariance cancels in float32); ``ndt_align`` on one map agrees
within 1e-4 and ``localize_track_step`` within 1e-3, and neither makes a
host sync; a short ``Localizer`` drive gives the same statuses and poses
within 0.02 m.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from lsd_tpu_torch.utils.precision import set_slam_precision
    set_slam_precision()
    return torch.device("cuda", 0)


def _inputs(n, dev, seed=0):
    from lsd_tpu_torch.geometry import so3
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=10, size=(n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    d = rng.normal(scale=0.1, size=n)
    w = (rng.random(n) > 0.2) * 400.0
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    R = so3.exp_so3(f([0.02, -0.03, 0.4]))
    Re = so3.exp_so3(f([0.0, 0.01, -0.02]))
    return f(pts), f(nrm), f(d), f(w), R, Re, f([0.1, 0.0, -0.05]), f([1.0, -2.0, 0.3])


@pytest.mark.parametrize("n", [1, 1000, 16384 - 37, 16384, 100000])
@pytest.mark.parametrize("est_ext", [False, True])
@pytest.mark.parametrize("cluster", [0, 8])
def test_p2p_kernel_matches_plain(cuda, n, est_ext, cluster):
    """cluster 0 is ``p2p_reduce`` with the card's cluster size; 8 is the
    8-block cluster that a card without room for 16 falls back to."""
    from lsd_tpu_torch.ops import p2p
    args = _inputs(n, cuda, seed=n)
    if cluster:
        run = lambda: p2p._launch(args, 1.0, est_ext, cluster).split_with_sizes((576, 24, 3))
    else:
        run = lambda: p2p.p2p_reduce(*args, 1.0, est_extrinsic=est_ext)
    before = p2p.p2p_reduce.launches
    out = run()
    again = run()
    assert p2p.p2p_reduce.launches == before + (0 if cluster else 2)
    ref = p2p.p2p_reduce_plain(*args, 1.0, est_extrinsic=est_ext)
    torch.cuda.synchronize()
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    H, r, s = out
    H = H.view(24, 24)
    rH, rr, rs = ref
    assert float((H - rH).abs().max()) <= 1e-5 * float(rH.abs().max())
    assert float((r - rr).abs().max()) <= 1e-4 * max(float(rr.abs().max()), 1.0)
    assert float(s[0]) == float(rs[0])
    torch.testing.assert_close(s[1:], rs[1:], rtol=1e-5, atol=1e-6)
    if not est_ext:
        assert float(H[18:].abs().max()) == 0.0 and float(r[18:].abs().max()) == 0.0


def test_p2p_launch_shape_is_16_or_8_blocks_of_256(cuda):
    from lsd_tpu_torch.ops.p2p import launch_shape
    blocks, threads = launch_shape(cuda)
    assert blocks in (16, 8) and threads == 256


def test_p2p_kernel_all_masked(cuda):
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    args = list(_inputs(4096, cuda))
    args[3] = torch.zeros_like(args[3])
    H, r, s = p2p_reduce(*args, 1.0)
    assert float(H.abs().max()) == 0.0 and float(r.abs().max()) == 0.0
    assert float(s.abs().max()) == 0.0


def test_p2p_kernel_empty_input_gives_zeros(cuda):
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    H, r, s = p2p_reduce(*_inputs(0, cuda), 1.0, est_extrinsic=True)
    torch.cuda.synchronize()
    assert H.shape == (24, 24) and r.shape == (24,) and s.shape == (3,)
    assert float(H.abs().max()) == 0.0 and float(r.abs().max()) == 0.0
    assert float(s.abs().max()) == 0.0


def test_p2p_kernel_is_one_launch_per_call(cuda):
    from torch.profiler import ProfilerActivity, profile
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    args = _inputs(16384, cuda)
    p2p_reduce(*args, 1.0)
    torch.cuda.synchronize()
    # the profiler now and then drops a couple of kernel records from a
    # trace: a trace with fewer kernels than calls is taken again, one with
    # more fails
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(100):
                p2p_reduce(*args, 1.0)
            torch.cuda.synchronize()
        on_card = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        count = sum(e.count for e in on_card if "p2p_" in e.key)
        # nothing else ran on the card: no copy, fill or second pass
        assert [e.key for e in on_card
                if "p2p_" not in e.key and e.self_device_time_total > 0] == []
        assert count <= 100
        if count == 100:
            break
    assert count == 100


def test_p2p_kernel_graph_replay_is_bitwise_equal(cuda):
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    args = _inputs(16384, cuda, seed=3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        p2p_reduce(*args, 1.0, est_extrinsic=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = p2p_reduce(*args, 1.0, est_extrinsic=True)
    for scale in (1.0, 0.5):       # the replay reads the inputs as they are now
        args[3].mul_(scale)
        graph.replay()
        direct = p2p_reduce(*args, 1.0, est_extrinsic=True)
        torch.cuda.synchronize()
        for a, b in zip(captured, direct):
            assert torch.equal(a, b)
    assert float(captured[2][0]) > 0


def test_p2p_wrapper_rejects_mixed_devices(cuda):
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    args = list(_inputs(64, cuda))
    args[4] = args[4].cpu()
    with pytest.raises(ValueError):
        p2p_reduce(*args, 1.0)


def test_lio_step_on_card_matches_cpu(cuda):
    """Six small scans on the card and on the CPU end within 1e-3 m."""
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.slam.lio import LioConfig, lio_init, lio_step
    from lsd_tpu_torch.tools.profile_lio import nav_at_start
    sim = CircleSim(SimConfig(n_scans=6, points_per_scan=2048, point_noise=0.01, seed=5))
    data = sim.generate(capacity=2048, imu_capacity=16)
    cfg = LioConfig(ds_capacity=1024, map_capacity=2 ** 13)
    final = {}
    for dev in ("cpu", cuda):
        st = lio_init(cfg, nav_at_start(sim, dev))
        before = p2p_reduce.launches
        for tup in data:
            st, _ = lio_step(cfg, st, *[torch.as_tensor(a, device=dev) for a in tup[:5]])
        if dev != "cpu":
            assert p2p_reduce.launches - before == cfg.max_iters * len(data)
        final[str(dev)] = st.nav.pos.cpu().numpy()
    np.testing.assert_allclose(final["cuda:0"], final["cpu"], atol=1e-3)


# ---- the mapping path's ops: the card against the CPU ----------------------


def _room(rng, n):
    """Ground and four walls within 8 m of the origin."""
    k = n // 5
    parts = [np.stack([rng.uniform(-8, 8, n - 4 * k), rng.uniform(-8, 8, n - 4 * k),
                       np.zeros(n - 4 * k)], 1)]
    for axis, at in ((0, -8.0), (0, 8.0), (1, -8.0), (1, 7.0)):
        w = np.stack([rng.uniform(-8, 8, k), rng.uniform(-8, 8, k), rng.uniform(0, 3, k)], 1)
        w[:, axis] = at
        parts.append(w)
    return (np.concatenate(parts) + rng.normal(0, 0.005, (n, 3))).astype(np.float32)


@pytest.mark.parametrize("cap,voxel,min_voxels,min_full", [
    (2 ** 14, 0.5, 2000, 300), (2 ** 11, 0.5, 1800, 300), (2 ** 14, 2.0, 200, 200)])
def test_hashmap_insert_on_card_equals_cpu(cuda, cap, voxel, min_voxels, min_full):
    """Three scans into one map; the small table crowds the probe window
    (over 85 % of its slots taken), the large voxels fill past K points
    (nearly every voxel full).  ``min_voxels`` and ``min_full`` guard each
    case's occupancy and its count of full voxels, so that a case goes on
    testing what it is there for."""
    from lsd_tpu_torch.ops.hashmap import hashmap_create, hashmap_insert, hashmap_knn
    rng = np.random.default_rng(0)
    maps = {}
    for dev in ("cpu", cuda):
        m = hashmap_create(cap, 8, voxel, device=dev)
        r = np.random.default_rng(1)
        for _ in range(3):
            pts = _room(r, 4096)
            mask = r.random(4096) > 0.1
            m = hashmap_insert(m, torch.as_tensor(pts, device=dev),
                               torch.as_tensor(mask, device=dev))
        maps[str(dev)] = m
    a, b = maps["cpu"], maps["cuda:0"]
    for name in ("keys", "coords", "counts", "points"):
        assert torch.equal(getattr(a, name), getattr(b, name).cpu()), name
    assert int((a.keys >= 0).sum()) > min_voxels and int((a.counts == 8).sum()) > min_full
    q = _room(rng, 1024)
    qm = np.ones(1024, bool)
    na, va = hashmap_knn(a, torch.as_tensor(q), torch.as_tensor(qm), k=5, neighborhood=7)
    nb, vb = hashmap_knn(b, torch.as_tensor(q, device=cuda), torch.as_tensor(qm, device=cuda),
                         k=5, neighborhood=7)
    assert torch.equal(va, vb.cpu())
    torch.testing.assert_close(na[va], nb.cpu()[va], rtol=0, atol=1e-6)


def _graph_builder(n=64, seed=0):
    from lsd_tpu_torch.geometry import np_so3
    from lsd_tpu_torch.slam.graph_builder import PoseGraphBuilder
    rng = np.random.default_rng(seed)

    def pose(R, p):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, p
        return T
    th = np.linspace(0, 2.2 * np.pi, n)
    gt = [pose(np_so3.rpy_to_matrix(0.0, 0.02 * np.cos(a), a + np.pi / 2),
               [10 * np.cos(a), 10 * np.sin(a), 1.8]) for a in th]
    b = PoseGraphBuilder()
    drift = np.eye(4)
    for k, T in enumerate(gt):
        drift = drift @ pose(np_so3.exp_so3(rng.normal(0, 2e-3, 3)), rng.normal(0, 0.02, 3))
        b.add_node(T @ drift, fixed=(k == 0))
        if k:
            b.add_se3_edge(k - 1, k, np.linalg.inv(gt[k - 1]) @ gt[k], 4.0e4, 1.0e4)
    b.add_se3_edge(2, n - 4, np.linalg.inv(gt[2]) @ gt[n - 4], 300.0, 300.0)
    b.add_se3_edge(5, 30, pose(np.eye(3), [3.0, 1.0, 0.0]), 200.0, 200.0)     # a wrong loop
    for k in range(0, n, 4):
        b.add_gps_prior(k, gt[k][:3, 3] + (9.0 if k == 20 else 0.0), xy_only=True, info=4.0)
    for k in range(3, n, 7):
        b.add_floor_prior(k, 1.8, 25.0, 10.0)
        b.add_orientation_prior(k, gt[k], info=1.0)
    return b


def test_optimize_on_card_matches_cpu_and_makes_no_sync(cuda):
    from lsd_tpu_torch.slam.posegraph import PgoConfig, optimize
    from lsd_tpu_torch.tools.profile_lio import sync_sites
    b = _graph_builder()
    out_c, info_c = optimize(b.to_data(device="cpu"), PgoConfig())
    data = b.to_data(device=cuda)
    optimize(data, PgoConfig(outer_iters=1, cg_iters=2))          # warm up
    (out_g, info_g), sites = sync_sites(lambda: optimize(data, PgoConfig()))
    assert sites == {}, f"optimize made host syncs: {sites}"
    torch.testing.assert_close(out_g.nodes.pos.cpu(), out_c.nodes.pos, rtol=0, atol=1e-4)
    torch.testing.assert_close(out_g.nodes.quat.cpu(), out_c.nodes.quat, rtol=0, atol=1e-4)
    assert int(info_g["gps_inliers"]) == int(info_c["gps_inliers"]) == 15
    costs = info_g["costs"].cpu()
    torch.testing.assert_close(costs, info_c["costs"], rtol=1e-3, atol=1e-6)
    assert bool(torch.isfinite(costs).all()) and float(costs[-1]) < float(costs[0])


@pytest.mark.parametrize("kind", ["surfel", "points"])
def test_icp_on_card_matches_cpu_and_makes_no_sync(cuda, kind):
    from lsd_tpu_torch.geometry import np_so3
    from lsd_tpu_torch.ops.hashmap import hashmap_create, hashmap_insert
    from lsd_tpu_torch.ops.surfel import surfel_create, surfel_insert
    from lsd_tpu_torch.slam.registration import icp_point_to_plane
    from lsd_tpu_torch.tools.profile_lio import sync_sites
    rng = np.random.default_rng(0)
    target = _room(rng, 16384)
    R = np_so3.rpy_to_matrix(0.01, -0.02, 0.3)
    t_true = np.array([1.0, -0.5, 0.2])
    source = ((_room(rng, 4096) - t_true) @ R).astype(np.float32)
    q0 = np_so3.matrix_to_quat(R @ np_so3.exp_so3([0.01, -0.02, 0.05])).astype(np.float32)
    t0 = (t_true + [0.15, -0.1, 0.05]).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        f = lambda a: torch.as_tensor(a, device=dev)
        ones = torch.ones(len(target), dtype=torch.bool, device=dev)
        if kind == "surfel":
            m = surfel_insert(surfel_create(2 ** 15, 0.5, device=dev), f(target), ones)
        else:
            m = hashmap_insert(hashmap_create(2 ** 15, 8, 0.5, device=dev), f(target), ones)
        args = (m, f(source), torch.ones(4096, dtype=torch.bool, device=dev), f(q0), f(t0))
        kw = dict(iters=20, plane_thresh=0.1, max_dist=0.5, neighborhood=7, min_points=4)
        if dev == "cpu":
            out["cpu"] = icp_point_to_plane(*args, **kw)
        else:
            icp_point_to_plane(*args, **dict(kw, iters=1))         # warm up
            out["cuda"], sites = sync_sites(lambda: icp_point_to_plane(*args, **kw))
            assert sites == {}, f"icp_point_to_plane made host syncs: {sites}"
    (qc, tc, ic), (qg, tg, ig) = out["cpu"], out["cuda"]
    # the raw-point target's 5-point plane fits are ill-conditioned in
    # float32 (ROADMAP queue C) and the card's batched LU rounds otherwise
    # than LAPACK, so the two alignments settle a millimetre apart
    atol = 1e-4 if kind == "surfel" else 2e-3
    torch.testing.assert_close(qg.cpu(), qc, rtol=0, atol=atol)
    torch.testing.assert_close(tg.cpu(), tc, rtol=0, atol=atol)
    assert abs(float(ig["n_inliers"]) - float(ic["n_inliers"])) <= (1 if kind == "surfel" else 2)
    assert float(np.linalg.norm(tg.cpu().numpy() - t_true)) < 0.02
    assert float(ig["inlier_ratio"]) > 0.9


def test_mapper_on_card_matches_cpu(cuda):
    """Twelve small scans through ``Mapper`` on the card and on the CPU: the
    same keyframes, poses within 2e-3 m, and a map that saves and loads."""
    import tempfile
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.slam.lio import LioConfig
    from lsd_tpu_torch.slam.map_io import load_map
    from lsd_tpu_torch.slam.mapper import Mapper, MapperConfig
    from lsd_tpu_torch.tools.profile_lio import nav_at_start
    sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=12, points_per_scan=2048,
                              point_noise=0.01, seed=21))
    data = sim.generate(capacity=2048, imu_capacity=16)
    cfg = MapperConfig(lio=LioConfig(ds_capacity=1024, map_capacity=2 ** 13),
                       keyframe_delta_trans=0.5, optimize_every=4, keyframe_cloud_cap=2048,
                       loop_min_distance=3.0, loop_map_capacity=2 ** 13, loop_map_voxel=1.0)
    runs = {}
    for dev in ("cpu", cuda):
        m = Mapper(cfg, nav_at_start(sim, dev))
        for k, d in enumerate(data):
            m.process_scan(*d[:5], stamp_us=int(k * 1e5))
        with tempfile.TemporaryDirectory() as tmp:
            m.save(tmp)
            loaded = load_map(tmp)
        assert len(loaded["poses"]) == len(m.store)
        runs[str(dev)] = m
    a, b = runs["cpu"], runs["cuda:0"]
    assert len(a.store) == len(b.store) > 8 and a.loop_stats == b.loop_stats
    np.testing.assert_allclose(b.trajectory(), a.trajectory(), atol=2e-3)
    for ka, kb in zip(a.store.frames, b.store.frames):
        np.testing.assert_allclose(kb.pose, ka.pose, atol=2e-3)

    # the same drive with the graph worker and the pipelined fetch: the
    # worker prints what a job raises and goes on, so hold it to having done
    # every keyframe's graph work on the card, the loop gates included
    import dataclasses
    nav0 = nav_at_start(sim, cuda)
    m = Mapper(dataclasses.replace(cfg, async_graph=True, async_fetch=True), nav0)
    for k, d in enumerate(data):
        m.process_scan(*d[:5], stamp_us=int(k * 1e5))
    m.flush()
    worker = m._worker
    m.close()
    assert not worker.is_alive()
    assert m.worker_errors == [] and "dropped_jobs" not in m.loop_stats
    assert m.sc_ids == list(range(len(m.store))) and len(m.store) == len(b.store)
    assert m.loop_stats["accepted"] >= 1            # ScanContext, ICP and the gates ran there
    assert any(not np.array_equal(kf.pose, kf.odom) for kf in m.store.frames)   # a PGO ran
    assert m.trajectory().shape == (12, 4, 4) and np.isfinite(m.trajectory()).all()
    # two runs on the card are not bitwise equal (float atomics in the surfel
    # map's scatter-adds); the odometry does not depend on the graph thread
    for ka, kb in zip(b.store.frames, m.store.frames):
        np.testing.assert_allclose(kb.odom, ka.odom, atol=1e-4)


# ---- the localization path: the card against the CPU -----------------------


def _ring_scan(n=8192, sweeps=1):
    """``sweeps`` sweeps of the simulator's ring world from its first pose,
    each another sample of the world, stacked: (points, stamps, mask)."""
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    sim = CircleSim(SimConfig(n_scans=2, points_per_scan=n, seed=11))
    P = np.zeros((sweeps * n, 3), np.float32)
    S = np.zeros(sweeps * n, np.float32)
    M = np.zeros(sweeps * n, bool)
    for i in range(sweeps):
        pts, stamps = sim.scan(0.0)
        k = min(len(pts), n)
        P[i * n:i * n + k], S[i * n:i * n + k], M[i * n:i * n + k] = pts[:k, :3], stamps[:k], True
    return P, S, M


def _on(dev, *arrays):
    return tuple(torch.as_tensor(a, device=dev) for a in arrays)


@pytest.mark.parametrize("voxel,cap", [(1.0, 2 ** 14), (1.5, 2 ** 11)])
def test_ndt_build_on_card_matches_cpu(cuda, voxel, cap):
    """The small table crowds the probe window; points that lose every
    claim round end without a slot on both devices alike."""
    from lsd_tpu_torch.slam.registration import ndt_build
    P, _, M = _ring_scan()
    a = ndt_build(*_on("cpu", P, M), voxel, cap)
    b = ndt_build(*_on(cuda, P, M), voxel, cap)
    assert torch.equal(a.keys, b.keys.cpu()) and torch.equal(a.counts, b.counts.cpu())
    assert int((a.keys >= 0).sum()) > 250
    torch.testing.assert_close(b.mean.cpu(), a.mean, rtol=0, atol=1e-4)
    sel = a.counts >= 4
    rng = np.random.default_rng(0)
    d = torch.as_tensor(rng.normal(0, 0.3, (int(sel.sum()), 3)).astype(np.float32))
    md = lambda m: torch.einsum("ni,nij,nj->n", d, m.cov_inv.cpu()[sel], d)
    rel = ((md(b) - md(a)).abs() / md(a)).numpy()
    assert np.quantile(rel, 0.99) < 2e-2 and rel.max() < 0.2, (np.quantile(rel, 0.99), rel.max())


def _perturbed(P, scale=0.4):
    from lsd_tpu_torch.geometry import np_so3
    R = np_so3.exp_so3([0.0, 0.0, 0.04 * scale])
    return ((P - np.asarray([0.4, -0.3, 0.05], np.float32) * scale) @ R).astype(np.float32)


@pytest.mark.parametrize("kw", [dict(iters=15, searches=4), dict(iters=30)])
def test_ndt_align_on_card_matches_cpu_and_makes_no_sync(cuda, kw):
    from lsd_tpu_torch.slam.registration import NdtMap, ndt_align, ndt_build
    from lsd_tpu_torch.tools.profile_lio import sync_sites
    P, _, M = _ring_scan()
    m = ndt_build(*_on("cpu", P, M), 1.0, 2 ** 14)
    src = _perturbed(P)
    one = np.asarray([1.0, 0, 0, 0], np.float32)
    qc, tc, ic = ndt_align(m, *_on("cpu", src, M, one, np.zeros(3, np.float32)), **kw)
    args = (NdtMap(*[x.to(cuda) for x in m]), *_on(cuda, src, M, one, np.zeros(3, np.float32)))
    ndt_align(*args, iters=1)                                     # warm up
    (qg, tg, ig), sites = sync_sites(lambda: ndt_align(*args, **kw))
    assert sites == {}, f"ndt_align made host syncs: {sites}"
    torch.testing.assert_close(qg.cpu(), qc, rtol=0, atol=1e-4)
    torch.testing.assert_close(tg.cpu(), tc, rtol=0, atol=1e-4)
    assert abs(float(ig["matched_frac"]) - float(ic["matched_frac"])) <= 2.0 / M.sum()
    assert float(np.linalg.norm(tg.cpu().numpy() - [0.16, -0.12, 0.02])) < 0.05


def _track_inputs(dev):
    """A filter state, an NDT map and a surfel map of four sweeps, and a
    fifth seen from 0.1 m further on, all on ``dev`` (the maps are built on
    the CPU and moved, so that both devices match against the same ones)."""
    from lsd_tpu_torch.ops.surfel import SurfelMap, surfel_create, surfel_insert
    from lsd_tpu_torch.slam.registration import NdtMap, ndt_build
    from lsd_tpu_torch.slam.ukf import UkfState, ukf_init
    P, S, M = _ring_scan(sweeps=5)
    ndt = ndt_build(*_on("cpu", P[8192:], M[8192:]), 1.0, 2 ** 14)
    icp = surfel_insert(surfel_create(2 ** 16, 0.5, device="cpu"), *_on("cpu", P[8192:], M[8192:]))
    P, S, M = P[:8192], S[:8192], M[:8192]
    st = ukf_init(device="cpu")
    x = st.x.clone()
    x[3:6] = torch.tensor([1.0, 0.2, 0.0])
    src = (P - np.asarray([0.1, 0.02, 0.0], np.float32))
    mv = lambda t: type(t)(*[v.to(dev) for v in t])
    return (mv(UkfState(x, st.P)), mv(ndt), mv(icp), *_on(dev, src, M)), S


@pytest.mark.parametrize("mode", ["const", "imu", "odom"])
def test_track_step_on_card_matches_cpu_and_makes_no_sync(cuda, mode):
    from lsd_tpu_torch.slam.localization import localize_track_step
    from lsd_tpu_torch.tools.profile_lio import sync_sites
    out = {}
    for dev in ("cpu", cuda):
        head, S = _track_inputs(dev)
        f = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
        args = (*head, f(0.1), f([0.0, 0.0, 0.02]), f([0.0, 0.0, 9.81]), f([0.1, 0.0, 0.0]),
                f(True, torch.bool), f(0.25))
        kw = dict(odom_dq=f([1.0, 0, 0, 0]), odom_dt=f([0.1, 0.02, 0.0]), gate_t=f(1.0),
                  gate_ang=f(0.17), gps_gate=f(2.5), stamps=f(S) if mode == "odom" else None,
                  has_imu=mode == "imu", has_odom=mode == "odom",
                  ndt_searches=4 if mode == "odom" else 15, track_voxel=0.4, track_capacity=4096)
        if dev == "cpu":
            out["cpu"] = localize_track_step(*args, **kw)
        else:
            localize_track_step(*args, **kw)                      # warm up
            out["cuda"], sites = sync_sites(lambda: localize_track_step(*args, **kw))
            assert sites == {}, f"localize_track_step made host syncs: {sites}"
    c, g = out["cpu"], out["cuda"]
    torch.testing.assert_close(g[0].x.cpu(), c[0].x, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(g[0].P.cpu(), c[0].P, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(g[1].cpu(), c[1], rtol=0, atol=1e-3)
    assert bool(g[4]) == bool(c[4]) is True and bool(g[5]) == bool(c[5]) is True
    assert abs(float(g[2]) - float(c[2])) < 0.01 and abs(float(g[3]) - float(c[3])) < 0.01
    assert float(np.linalg.norm(g[1][:3, 3].cpu().numpy() - [0.1, 0.02, 0.0])) < 0.05


def test_localizer_on_card_matches_cpu(cuda, tmp_path):
    """A map of 40 small scans (made on the CPU), then 14 scans of a drive
    from rest through ``Localizer`` on each device, production mode: the
    side LIO launches the p2p kernel three times a scan on the card."""
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.slam.lio import LioConfig
    from lsd_tpu_torch.slam.localization import Localizer, LocalizerConfig
    from lsd_tpu_torch.slam.mapper import Mapper, MapperConfig
    from lsd_tpu_torch.tools.profile_lio import nav_at_start
    world = dict(radius=8.0, omega=0.8, points_per_scan=4096, point_noise=0.01, seed=21)
    lio = dict(ds_capacity=2048, map_capacity=2 ** 14, scan_voxel=0.4, map_voxel=0.4)
    sim = CircleSim(SimConfig(n_scans=40, **world))
    m = Mapper(MapperConfig(lio=LioConfig(**lio), keyframe_delta_trans=1.5,
                            keyframe_cloud_cap=4096), nav_at_start(sim, "cpu"))
    for k, d in enumerate(sim.generate(capacity=4096, imu_capacity=16)):
        m.process_scan(*d[:5], stamp_us=int(k * 1e5))
    m.save(str(tmp_path / "map"))
    drive = CircleSim(SimConfig(n_scans=14, rest_time=0.4, ramp_time=2.0, **world))
    scans = drive.generate(capacity=4096, imu_capacity=16, t_start=0.037)
    R, p = drive.pose(0.037)
    hint = np.eye(4)
    hint[:3, :3], hint[:3, 3] = R, p + [0.8, -0.5, 0.1]
    outs = {}
    for dev in ("cpu", cuda):
        loc = Localizer(str(tmp_path / "map"), LocalizerConfig(
            lio=LioConfig(max_iters=3, **lio), ndt_capacity=2 ** 13, track_capacity=2048,
            update_map_every=0.5), device=dev)
        loc.set_init_pose(hint)
        before = p2p_reduce.launches
        res = []
        for k, (P, S, M, I, IM, _) in enumerate(scans):
            smp = drive.imu_sample(0.037 + k * 0.1)
            res.append(loc.process_scan(P, M, int((0.037 + k * 0.1) * 1e6), imu_gyro=smp[1:4],
                                        imu_acc=smp[4:7] * 9.81, stamps=S, imu=I, imu_mask=IM))
        if dev != "cpu":
            assert p2p_reduce.launches - before == 3 * len(scans)
            assert loc.ukf.x.device.type == "cuda" and loc.ndt_map.keys.device.type == "cuda"
        assert loc.last_step_diag["has_odom"]
        outs[str(dev)] = res
    assert [o["status"] for o in outs["cuda:0"]] == [o["status"] for o in outs["cpu"]] \
        == ["initialized"] + ["tracking"] * 13
    for k, (a, b) in enumerate(zip(outs["cuda:0"], outs["cpu"])):
        np.testing.assert_allclose(a["pose"], b["pose"], rtol=0, atol=0.02, err_msg=str(k))
        assert np.linalg.norm(a["pose"][:3, 3] - scans[k][5][:3, 3]) < 0.1
