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

The IMU propagation kernel against ``propagate_plain`` on the card, over
seven slot layouts and a column-major covariance: state and track within rtol 1e-5 and atol 1e-6 and P
within 1e-5 of its largest entry (float32 rounding of the same recursion;
the kernel sums each entry of F P F^T in a fixed order, the plain version
through cuBLAS); with no slot valid, state and P come back bitwise and the
track repeats the start.  One launch (no copy of P) and no host sync a
call; a CUDA-graph
replay equals a direct call bitwise.  100 scans of ``lio_step`` at the
benchmark's size with the kernel follow the same scans through
``propagate_plain`` within the pose, rotation and covariance gaps of
``port_bench/limits/lio-replay.json``: the limits that decide the
benchmark's ``correct``.

The LIO step as CUDA graphs (``slam/lio_graph.py``): 40 bench-size scans
through the graphs follow the eager body within a tenth of those limits, on
either map, re-searching planes every iteration and trimming the map (under
deterministic algorithms exactly; the surfel map also with the default
kernels); a returned state is never overwritten, the state passed in never
written; a scan after warm-up is at most 100 launches and 4 host syncs, one
capture a key; a capture succeeds while another thread uses the card.  The
gate kernel (``csrc/lio_gate.cu``) against ``_gate_degenerate_plain`` with
0 to 3 pose eigenvalues under the threshold: E within 1e-5, counts equal;
no host sync; a CUDA-graph replay equals a direct call.

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

The detection path: ``voxelize_dynamic`` and the BEV scatters give equal
results on the card (a stable sort; each scatter target receives one
pillar), rotated IoU, GIoU and overlap agree within 1e-5 + 1e-5 of the
value and NMS keeps the same boxes, the float32 network with TF32 off
agrees within 1e-3 of each map's largest magnitude (cuDNN picks other
convolution algorithms), the tracker keeps the same tracks, and
``build_detector_predict_fn``'s function makes no host sync.

The camera path: ``resize_linear`` gives equal bytes (integer arithmetic);
the float32 ``Mono3D`` with TF32 off agrees within 1e-4 of each map's
largest magnitude (a control with cuDNN's TF32 on must not) and decodes
the same valid boxes; the bf16 ``Yolo2D``
within 3e-2 (the CPU tests' bar against JAX; cuDNN accumulates in another
order before each bf16 rounding); ``nms_2d`` keeps the same boxes and,
like the model and decode inside ``Mono3DInfer``, makes no host sync
(``Mono3DInfer.detect`` makes exactly one, its packed fetch);
``quantized_matmul`` through ``torch._int_mm`` gives the CPU's int32
accumulators, with M, K and N padded to what that call takes.

Training: one step of each trainer at a small size from the same weights
and batch, card against CPU: float32 gradients (the detector's twin,
Mono3D) within 1e-3 of each leaf's largest magnitude, the bf16 Yolo2D's
per leaf at cosine >= 0.999 and relative norm gap <= 0.05 (the conv
biases that a GroupNorm follows aside: their gradient is rounding noise,
``tests/test_torch_train_camera.py``); a whole step, upload included,
makes no host sync.

The runtime: two threads that reach the p2p kernel first at once build it
once and both launch it right; ``SlamModule`` driven from a thread of its
own gives the CPU's keyframes and GPS priors and poses within 0.02 m (the
``Localizer`` bar above); ``knn_mean_colors`` within 1e-5 of the colours'
range (TF32 off on both).

The scoring path: the simulators' scans reach the card unchanged (a copy
there and back is byte-equal); ``evaluate_mot`` with its IoUs on the card
(within the IoU bar above) equals the CPU's in its integer fields and
within 1e-5 in its float fields;
``tools.evaluate.run_tpu_lio`` with no device argument runs on the card and
launches the p2p kernel ``max_iters`` (4) times per scan; without a card,
``tools.evaluate``'s runner and CLI raise instead of running on the CPU.

The multi-device code: the map-sharded LIO step on one NCCL rank follows
``lio_step`` within 1e-3 m over six scans and launches the p2p kernel
``max_iters`` times per scan.

DSVT-Pillar: the set-attention kernel against ``set_attention_plain`` on
each of the four partitions of a bench-size frame (the pillars of one
169,600-point sweep of the benchmark's drive, seeded bf16 Q, K and V)
within 1e-2 of the largest output (both sum in float32 in another order
before one bf16 rounding: one bf16 step is 2^-8 of a value); a forward of
the DSVT backbone on that frame is one kernel launch a layer and makes no
host sync (the partition, the pillars and the encoder neither); a CUDA-graph
replay equals a direct call bitwise; the served bf16 model through
``build_detector_predict_fn`` on one frame agrees with the float32
``dsvt_plain.py`` within ``port_bench/limits/dsvt-drive.json``, the limits
that decide the benchmark's ``correct``, on the benchmark's seeded weights
(non-trivial biases, norm scales and BatchNorm statistics).

The online system: frames that the online source captured from live UDP
traffic through ``SlamModule`` on the card and on the CPU, poses within
0.02 m; ``run``'s ``start_system`` with no device puts ``Perception`` and
its SLAM stage on the card and answers ``/v1/status``.
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
    before = p2p.p2p_reduce.launches.read()
    out = run()
    again = run()
    assert p2p.p2p_reduce.launches.read() == before + 2
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


IMU_LAYOUTS = ["16_valid", "11_of_16", "11_of_64", "1_slot", "none_valid", "gap_clamped",
               "equal_stamps", "P_column_major"]


def _imu_case(layout, dev, seed=3):
    """propagate's arguments: the simulator's IMU batch (11 valid rows at
    100 Hz) laid out as ``layout`` names, biases, and a dense covariance with
    a small asymmetric part, so that a transposed read would show; with
    ``P_column_major`` it is stored column-major, as the LIO step's
    covariance comes out of its inverse."""
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.slam.imu import ImuNoise
    from lsd_tpu_torch.tools.profile_lio import nav_at_start
    sim = CircleSim(SimConfig(n_scans=2, points_per_scan=512, gyro_noise=0.01, acc_noise=0.01,
                              seed=seed))
    scan = sim.generate(capacity=512, imu_capacity=64 if layout == "11_of_64" else 16)[1]
    imu, mask = scan[3].copy(), scan[4].copy()
    if layout == "16_valid":
        imu[11:, 0] = 0.1 + 0.01 * np.arange(1, 6)
        mask[:] = True
    elif layout == "1_slot":
        imu, mask = imu[:1], mask[:1]
    elif layout == "none_valid":
        mask[:] = False
    elif layout == "gap_clamped":
        imu[6:11, 0] += 0.25                     # one interval of 0.26 s, clamped to 0.1
    elif layout == "equal_stamps":
        imu[4, 0] = imu[3, 0]                    # a zero interval
    rng = np.random.default_rng(seed)
    A = rng.normal(scale=1e-2, size=(24, 24))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    nav = nav_at_start(sim, dev)._replace(bg=f([1e-4, -2e-4, 3e-4]), ba=f([0.01, -0.02, 5e-3]))
    P = f(A @ A.T + np.eye(24) * 1e-4 + rng.normal(scale=1e-6, size=(24, 24)))
    if layout == "P_column_major":
        P = P.T.contiguous().T
    return nav, P, f(imu), torch.as_tensor(mask, device=dev), ImuNoise(), 9.81


def _imu_outputs(res):
    st, P, tr = res
    return [st.quat, st.pos, st.vel, P, tr["quat"], tr["pos"], tr["vel"]]


@pytest.mark.parametrize("layout", IMU_LAYOUTS)
def test_imu_kernel_matches_plain(cuda, layout):
    from lsd_tpu_torch.slam.imu import propagate, propagate_plain
    args = _imu_case(layout, cuda)
    before = propagate.launches.read()
    out = _imu_outputs(propagate(*args))
    again = _imu_outputs(propagate(*args))
    assert propagate.launches.read() == before + 2
    ref = _imu_outputs(propagate_plain(*args))
    torch.cuda.synchronize()
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    for k, (a, b) in enumerate(zip(out, ref)):
        if k == 3:
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    nav, P = args[0], args[1]
    if layout == "none_valid":
        for a, b in zip(out[:4], [nav.quat, nav.pos, nav.vel, P]):
            assert torch.equal(a, b)
        for a, b in zip(out[4:], [nav.quat, nav.pos, nav.vel]):
            assert torch.equal(a, b.expand_as(a))
    elif layout != "1_slot":                     # the first slot's interval is 0
        assert not torch.equal(out[3], P)


def test_imu_kernel_is_one_launch_per_call_and_makes_no_sync(cuda):
    from torch.profiler import ProfilerActivity, profile
    from lsd_tpu_torch.slam.imu import propagate
    from lsd_tpu_torch.tools.profile_lio import sync_sites
    args = _imu_case("P_column_major", cuda)         # as the LIO step hands it over
    propagate(*args)
    before = propagate.launches.read()
    _, sites = sync_sites(lambda: propagate(*args))
    assert sites == {}, f"propagate made host syncs: {sites}"
    assert propagate.launches.read() == before + 1
    syncs = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
             "cudaMemcpy")

    def traced(calls):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                propagate(*args)
            torch.cuda.synchronize()
        events = prof.key_averages()
        return events, {e.key: e.count for e in events if e.key in syncs}

    # the runtime waits of a trace that holds only the closing synchronize
    # (and the profiler's own): 100 calls add none
    _, waits = traced(0)
    # as for the p2p kernel: a trace with fewer kernels than calls is taken
    # again, one with more fails
    for _ in range(5):
        events, waits_100 = traced(100)
        assert waits_100 == waits
        on_card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        count = sum(e.count for e in on_card if "imu_propagate" in e.key)
        assert [e.key for e in on_card
                if "imu_propagate" not in e.key and e.self_device_time_total > 0] == []
        assert count <= 100
        if count == 100:
            break
    assert count == 100


def test_imu_kernel_graph_replay_equals_a_direct_call(cuda):
    from lsd_tpu_torch.slam.imu import propagate
    args = list(_imu_case("11_of_16", cuda))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        propagate(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _imu_outputs(propagate(*args))
    for scale in (1.0, 0.5):       # the replay reads the IMU rows as they are now
        args[2][:, 1:4].mul_(scale)
        graph.replay()
        direct = _imu_outputs(propagate(*args))
        torch.cuda.synchronize()
        for a, b in zip(captured, direct):
            assert torch.equal(a, b)


def test_imu_wrapper_rejects_mixed_devices(cuda):
    from lsd_tpu_torch.slam.imu import propagate
    args = list(_imu_case("11_of_16", cuda))
    args[3] = args[3].cpu()
    with pytest.raises(ValueError, match="imu_mask"):
        propagate(*args)


def test_lio_step_with_imu_kernel_follows_plain_propagation(cuda, monkeypatch):
    """100 scans at the benchmark's size (32,768 points, ``BENCH_CFG``),
    with the kernel and with ``propagate_plain`` in its place."""
    import json
    from pathlib import Path
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.slam import imu, lio
    from lsd_tpu_torch.tools.profile_lio import BENCH_CFG as cfg, nav_at_start
    limits = json.loads((Path(__file__).resolve().parent.parent
                         / "port_bench" / "limits" / "lio-replay.json").read_text())
    n = 100
    sim = CircleSim(SimConfig(n_scans=n, points_per_scan=2 ** 15, point_noise=0.01, seed=7))
    scans = [tuple(torch.as_tensor(a, device=cuda) for a in d[:5])
             for d in sim.generate(capacity=2 ** 15, imu_capacity=16)]
    runs = []
    for plain in (False, True):
        step = lio.lio_step
        if plain:     # the eager body: the graphs of lio_step hold the kernel
            monkeypatch.setattr(lio, "propagate", imu.propagate_plain)
            step = lio._lio_step_eager
        st = lio.lio_init(cfg, nav_at_start(sim, cuda))
        before = imu.propagate.launches.read()
        poses, covs = [], []
        for scan in scans:
            st, info = step(cfg, st, *scan)
            poses.append(info["pose"])
            covs.append(st.P)
        assert imu.propagate.launches.read() - before == (0 if plain else n)
        runs.append([torch.stack(x).double().cpu().numpy() for x in (poses, covs)])
    (pk, ck), (pp, cp) = runs
    pos = np.linalg.norm(pk[:, :3, 3] - pp[:, :3, 3], axis=1).max()
    chord = np.linalg.norm((pk[:, :3, :3] - pp[:, :3, :3]).reshape(n, -1), axis=1)
    rot = (2.0 * np.arcsin(np.clip(chord / (2.0 * np.sqrt(2.0)), 0.0, 1.0))).max()
    cov = (np.abs(ck - cp).reshape(n, -1).max(1) / np.abs(cp).reshape(n, -1).max(1)).max()
    assert pos <= limits["pose_gap_m"], pos
    assert rot <= limits["rot_gap_rad"], rot
    assert cov <= limits["cov_gap_rel"], cov


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
        before = p2p_reduce.launches.read()
        for tup in data:
            st, _ = lio_step(cfg, st, *[torch.as_tensor(a, device=dev) for a in tup[:5]])
        if dev != "cpu":
            assert p2p_reduce.launches.read() - before == cfg.max_iters * len(data)
        final[str(dev)] = st.nav.pos.cpu().numpy()
    np.testing.assert_allclose(final["cuda:0"], final["cpu"], atol=1e-3)


def test_sharded_lio_step_nccl_world_1_matches_lio_step(cuda):
    """The map-sharded step on one NCCL rank against ``lio_step`` on six
    small scans: within 1e-3 m (the card-against-CPU bar above: float
    atomics order the scatters' sums differently from run to run), the p2p
    kernel ``max_iters`` times per scan, the local table the whole map."""
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.parallel import make_sharded_lio_step, sharded_lio_init, single_rank
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.slam.lio import LioConfig, lio_init, lio_step
    from lsd_tpu_torch.tools.profile_lio import nav_at_start
    sim = CircleSim(SimConfig(n_scans=6, points_per_scan=4096, point_noise=0.01, seed=11))
    data = sim.generate(capacity=4096, imu_capacity=16)
    cfg = LioConfig(ds_capacity=2048, map_capacity=2 ** 14, scan_voxel=0.4, map_voxel=0.4,
                    max_iters=4, research_thresh=0.0)
    with single_rank("nccl", timeout_s=60) as mesh:
        assert (mesh.size, mesh.rank, mesh.device) == (1, 0, cuda)
        step = make_sharded_lio_step(cfg, mesh)
        st_s = sharded_lio_init(cfg, mesh, nav_at_start(sim, cuda))
        st_1 = lio_init(cfg, nav_at_start(sim, cuda))
        for tup in data:
            scan = [torch.as_tensor(a, device=cuda) for a in tup[:5]]
            before = p2p_reduce.launches.read()
            st_s, pose = step(st_s, *scan)
            assert p2p_reduce.launches.read() - before == cfg.max_iters
            st_1, info = lio_step(cfg, st_1, *scan)
            np.testing.assert_allclose(pose[:3, 3].cpu().numpy(),
                                       info["pose"][:3, 3].cpu().numpy(), atol=1e-3)
        assert st_s.map.capacity == cfg.map_capacity


# ---- the LIO step as CUDA graphs, and its degeneracy gate -------------------

def _bench_drive(dev, n, seed=7):
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.tools.profile_lio import nav_at_start
    sim = CircleSim(SimConfig(n_scans=n, points_per_scan=2 ** 15, point_noise=0.01, seed=seed))
    scans = [tuple(torch.as_tensor(a, device=dev) for a in d[:5])
             for d in sim.generate(capacity=2 ** 15, imu_capacity=16)]
    return nav_at_start(sim, dev), scans


def _lio_limits():
    import json
    from pathlib import Path
    return json.loads((Path(__file__).resolve().parent.parent
                       / "port_bench" / "limits" / "lio-replay.json").read_text())


def _fresh_runners(monkeypatch):
    """An empty cache of keys: the next call of a key warms, the one after
    captures."""
    import collections
    from lsd_tpu_torch.slam import lio_graph
    monkeypatch.setattr(lio_graph, "_runners", collections.OrderedDict())
    return lio_graph


GRAPH_CASES = {
    "surfel": {},
    "points": dict(map_type="points"),
    "research_every_iteration": dict(research_thresh=1e-9),
    "trim": dict(recenter_thresh=0.5, map_radius=8.0),
}


@pytest.mark.parametrize("case,deterministic", [(c, True) for c in GRAPH_CASES]
                         + [("surfel", False)])
def test_lio_graphs_follow_the_eager_body_at_bench_size(cuda, case, deterministic,
                                                        monkeypatch):
    """40 bench-size scans (32,768 points, ``BENCH_CFG`` with the case's
    fields) through ``lio_step``'s graphs and through the eager body on the
    card: every scan's pose and rotation, every covariance and the map's
    keys after the last within a tenth of the limits that decide the
    benchmark's ``correct``.  Under deterministic algorithms both run the
    same kernels in the same order and agreed exactly (H100 80GB HBM3).
    With the default ones the scatters' float atomics sum in an order that
    changes from run to run, and the raw-point map's 5-point plane fits and
    a map trimmed to 8 m carry it into the pose: two eager runs of the
    raw-point drive parted by 2.6e-4 m, graphs and eager body of the trimmed
    one by up to 7.8e-4 m, over a tenth of the limit; the surfel map, the
    benchmark's, also runs with them."""
    if deterministic:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    try:
        _graphs_follow_eager(cuda, case, monkeypatch)
    finally:
        torch.use_deterministic_algorithms(False)


def _graphs_follow_eager(cuda, case, monkeypatch):
    from lsd_tpu_torch.slam import lio as L
    from lsd_tpu_torch.tools.profile_lio import BENCH_CFG
    lio_graph = _fresh_runners(monkeypatch)
    cfg = BENCH_CFG._replace(**GRAPH_CASES[case])
    limits = _lio_limits()
    n = 40
    nav0, scans = _bench_drive(cuda, n)
    matches = []
    match = L._match_planes
    monkeypatch.setattr(L, "_match_planes", lambda *a: matches.append(1) or match(*a))
    before = dict(lio_graph.counters)
    runs = []
    for step in (L.lio_step, L._lio_step_eager):
        st = L.lio_init(cfg, nav0)
        poses, covs = [], []
        for scan in scans:
            st, info = step(cfg, st, *scan)
            poses.append(info["pose"])
            covs.append(st.P)
        runs.append([torch.stack(x).double().cpu().numpy() for x in (poses, covs)]
                    + [st.map.keys.cpu().numpy()])
    counts = {k: lio_graph.counters[k] - before[k] for k in before}
    (pg, cg, kg), (pe, ce, ke) = runs
    pos = np.linalg.norm(pg[:, :3, 3] - pe[:, :3, 3], axis=1).max()
    chord = np.linalg.norm((pg[:, :3, :3] - pe[:, :3, :3]).reshape(n, -1), axis=1)
    rot = (2.0 * np.arcsin(np.clip(chord / (2.0 * np.sqrt(2.0)), 0.0, 1.0))).max()
    cov = (np.abs(cg - ce).reshape(n, -1).max(1) / np.abs(ce).reshape(n, -1).max(1)).max()
    used = (kg >= 0) | (ke >= 0)
    keys = float(np.mean(kg[used] != ke[used]))
    assert pos <= 0.1 * limits["pose_gap_m"], pos
    assert rot <= 0.1 * limits["rot_gap_rad"], rot
    assert cov <= 0.1 * limits["cov_gap_rel"], cov
    assert keys <= 0.1 * limits["map_key_share"], keys
    assert (counts["captures"], counts["eager"], counts["replays"]) == (1, 1, n - 1)
    # 0.25 m a scan on the circle: a trim every second or third scan
    assert (counts["trims"] >= n // 4) if case == "trim" else counts["trims"] == 0
    if case == "research_every_iteration":    # most scans re-search in the eager body
        assert len(matches) > 2 * n


def test_lio_graph_state_is_fresh_and_its_input_untouched(cuda):
    """A state that ``lio_step`` returned is intact after three later calls,
    and the state passed in is unchanged, bitwise."""
    from lsd_tpu_torch.slam.lio import lio_init, lio_step
    from lsd_tpu_torch.tools.profile_lio import BENCH_CFG as cfg
    nav0, scans = _bench_drive(cuda, 6)
    st = lio_init(cfg, nav0)
    for scan in scans[:2]:
        st, _ = lio_step(cfg, st, *scan)
    leaves = lambda x: ([x] if isinstance(x, torch.Tensor) else
                        [t for k in sorted(x) for t in leaves(x[k])] if isinstance(x, dict)
                        else [t for v in x for t in leaves(v)])
    st_in = st
    given = [t.clone() for t in leaves(st_in)]
    st_out, info = lio_step(cfg, st_in, *scans[2])
    returned = [t.clone() for t in leaves((st_out, info))]
    st = st_out
    for scan in scans[3:]:
        st, _ = lio_step(cfg, st, *scan)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(leaves(st_in), given))
    assert all(torch.equal(a, b) for a, b in zip(leaves((st_out, info)), returned))
    assert not torch.equal(st.nav.pos, st_out.nav.pos)


def test_lio_graph_scan_is_few_launches_and_syncs(cuda, monkeypatch):
    """After warm-up a bench-size scan is graph replays: at most 100 kernel
    launches and at most 4 host syncs (the three re-search flags and the trim
    flag); the counters show one capture for the key, then replays, and
    the kernels, counting where they run, ran as often as the eager body
    launches them: the p2p kernel and the gate ``max_iters`` times, the IMU
    kernel once."""
    from torch.profiler import ProfilerActivity, profile
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.slam.imu import propagate
    from lsd_tpu_torch.slam.lio import _gate_degenerate, lio_init, lio_step
    from lsd_tpu_torch.tools.profile_lio import BENCH_CFG as cfg, sync_sites
    lio_graph = _fresh_runners(monkeypatch)
    before = dict(lio_graph.counters)
    nav0, scans = _bench_drive(cuda, 8)
    st = lio_init(cfg, nav0)
    for scan in scans[:6]:
        st, _ = lio_step(cfg, st, *scan)
    kernels = (p2p_reduce.launches, propagate.launches, _gate_degenerate.launches)
    for k in kernels:
        k.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        st, info = lio_step(cfg, st, *scans[6])
    assert [k.read() for k in kernels] == [cfg.max_iters, 1, cfg.max_iters]
    launches = sum(1 for e in prof.events()
                   if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    (st, _), sites = sync_sites(lambda: lio_step(cfg, st, *scans[7]))
    counts = {k: lio_graph.counters[k] - before[k] for k in before}
    assert launches <= 100, launches
    assert sum(sites.values()) <= 4, sites
    assert counts == dict(captures=1, replays=7, eager=1, trims=0), counts


GATE_TOL = 1e-5


@pytest.mark.parametrize("n_small", [0, 1, 2, 3])
def test_gate_kernel_matches_plain(cuda, n_small):
    """The gate kernel against ``_gate_degenerate_plain`` on the card over
    random symmetric positive definite pose blocks with ``n_small``
    eigenvalues under ``degen_thresh`` (the rest at least 4 times over it,
    at most 200): E within 1e-5 (float32 eigenvectors of such blocks,
    ~1.2e-7 * 200 / 10), counts equal; one launch a call, bitwise
    repeatable; a CUDA-graph replay equals a direct call, and the launch
    count, taken where the kernel runs, counts the replay and not the
    capture."""
    from lsd_tpu_torch.slam import lio as L
    cfg = L.LioConfig()
    rng = np.random.default_rng(n_small)
    trials = 0
    while trials < 20:
        small = rng.uniform(0.0, 0.5 * cfg.degen_thresh, n_small)
        large = rng.uniform(4.0 * cfg.degen_thresh, 200.0, 6 - n_small)
        Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
        A = (Q * np.concatenate([small, large])) @ Q.T
        mu = np.linalg.eigvalsh(A[3:6, 3:6])
        if np.abs(mu - cfg.degen_rel_frac * mu[-1]).min() < 1e-3 * mu[-1]:
            continue        # n_weak's bar within float32's reach of an eigenvalue
        trials += 1
        H = rng.normal(scale=0.1, size=(24, 24))
        H = H @ H.T
        H[:6, :6] = A
        HtH = torch.as_tensor(H.astype(np.float32), device=cuda)
        before = L._gate_degenerate.launches.read()
        got = L._gate_degenerate(cfg, HtH)
        again = L._gate_degenerate(cfg, HtH)
        assert L._gate_degenerate.launches.read() == before + 2
        want = L._gate_degenerate_plain(cfg, HtH)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert float((got[0] - want[0]).abs().max()) <= GATE_TOL
        assert int(got[1]) == int(want[1]) == n_small
        assert int(got[2]) == int(want[2])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        L._gate_degenerate(cfg, HtH)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0 = L._gate_degenerate.launches.read()
    with torch.cuda.graph(graph):
        captured = L._gate_degenerate(cfg, HtH)
    assert L._gate_degenerate.launches.read() == n0
    HtH[:6, :6].mul_(0.5)               # the replay reads HtH as it is now
    graph.replay()
    direct = L._gate_degenerate(cfg, HtH)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, direct))
    assert L._gate_degenerate.launches.read() == n0 + 2


def test_gate_kernel_makes_no_host_sync(cuda):
    from lsd_tpu_torch.slam import lio as L
    from lsd_tpu_torch.tools.profile_lio import sync_sites
    HtH = torch.eye(24, device=cuda) * 50.0
    L._gate_degenerate(L.LioConfig(), HtH)
    _, sites = sync_sites(lambda: L._gate_degenerate(L.LioConfig(), HtH))
    assert sites == {}


def test_lio_graph_captures_while_another_thread_launches(cuda, monkeypatch):
    """A key warmed and captured while a second thread launches kernels and
    reads values back on the default stream (as the pipeline's stages do):
    the capture succeeds and the steps equal the eager body's.  (The second
    thread draws no random numbers on the card: a capture registers the
    default CUDA generator, and torch refuses its use from another thread
    while the capture lasts.)"""
    import threading
    from lsd_tpu_torch.slam import lio as L
    from lsd_tpu_torch.tools.profile_lio import BENCH_CFG as cfg
    lio_graph = _fresh_runners(monkeypatch)
    nav0, scans = _bench_drive(cuda, 5)
    stop, errors, rounds = threading.Event(), [], [0]

    def busy():
        try:
            x = torch.zeros(4096, device=cuda)
            a = torch.full((256, 256), 0.01, device=cuda)
            while not stop.is_set():
                x.add_(1.0)
                float((a @ a).sum())
                rounds[0] += 1
        except Exception as exc:       # reported below: the thread must not die silently
            errors.append(exc)
    other = threading.Thread(target=busy)
    other.start()
    try:
        before = lio_graph.counters["captures"]
        st = L.lio_init(cfg, nav0)
        got = []
        for scan in scans:
            st, info = L.lio_step(cfg, st, *scan)
            got.append(info["pose"])
        captured = lio_graph.counters["captures"] - before
    finally:
        stop.set()
        other.join(timeout=60)
    assert not other.is_alive() and not errors and rounds[0] > 0
    assert captured == 1
    st = L.lio_init(cfg, nav0)
    for k, scan in enumerate(scans):
        st, info = L._lio_step_eager(cfg, st, *scan)
        assert float((info["pose"] - got[k]).abs().max()) <= 1e-4


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
        before = p2p_reduce.launches.read()
        res = []
        for k, (P, S, M, I, IM, _) in enumerate(scans):
            smp = drive.imu_sample(0.037 + k * 0.1)
            res.append(loc.process_scan(P, M, int((0.037 + k * 0.1) * 1e6), imu_gyro=smp[1:4],
                                        imu_acc=smp[4:7] * 9.81, stamps=S, imu=I, imu_mask=IM))
        if dev != "cpu":
            assert p2p_reduce.launches.read() - before == 3 * len(scans)
            assert loc.ukf.x.device.type == "cuda" and loc.ndt_map.keys.device.type == "cuda"
        assert loc.last_step_diag["has_odom"]
        outs[str(dev)] = res
    assert [o["status"] for o in outs["cuda:0"]] == [o["status"] for o in outs["cpu"]] \
        == ["initialized"] + ["tracking"] * 13
    for k, (a, b) in enumerate(zip(outs["cuda:0"], outs["cpu"])):
        np.testing.assert_allclose(a["pose"], b["pose"], rtol=0, atol=0.02, err_msg=str(k))
        assert np.linalg.norm(a["pose"][:3, 3] - scans[k][5][:3, 3]) < 0.1


def _scene(seed=0):
    from lsd_tpu_torch.tools.profile_detector import scene_config
    from lsd_tpu_torch.training.data import SyntheticDetectionDataset
    sc = SyntheticDetectionDataset(scene_config(), seed=seed).scene()
    return sc["points"], sc["mask"]


@pytest.mark.parametrize("capacity", ["reference", "true_reference"])
def test_voxelize_and_scatter_on_card_equal_cpu(cuda, capacity):
    from lsd_tpu_torch.models.vfe import scatter_to_bev, scatter_to_bev_s2d
    from lsd_tpu_torch.ops.voxelize import voxelize_dynamic
    from lsd_tpu_torch.tools.profile_detector import CAPACITIES
    cfg = CAPACITIES[capacity]()
    pts, mask = _scene(1)
    pts = np.concatenate([pts, pts + [0.05, -0.03, 0.0, 0.0]]).astype(np.float32)
    mask = np.concatenate([mask, mask])
    feats = torch.as_tensor(np.random.default_rng(2).normal(size=(cfg.max_voxels, 16)),
                            dtype=torch.float32)
    out = {}
    for dev in ("cpu", cuda):
        vox = voxelize_dynamic(torch.as_tensor(pts, device=dev), torch.as_tensor(mask, device=dev),
                               cfg.voxel_size, cfg.pc_range, cfg.max_voxels,
                               cfg.max_points_per_voxel)
        f = feats.to(dev) * vox[3][:, None]
        bev = (scatter_to_bev_s2d(f, vox[1], vox[3], cfg.grid_hw, cfg.s2d_factor)
               if cfg.s2d_factor > 1 else scatter_to_bev(f, vox[1], vox[3], cfg.grid_hw))
        out[str(dev)] = [a.cpu() for a in (*vox, bev)]
    for a, b in zip(out["cpu"], out["cuda:0"]):
        assert torch.equal(a, b)
    counts = out["cpu"][2]
    assert int((counts > 0).sum()) > 5000 and int((counts == cfg.max_points_per_voxel).sum()) > 100


def test_iou_and_nms_on_card_match_cpu_and_make_no_sync(cuda):
    from lsd_tpu_torch.ops import iou3d
    from lsd_tpu_torch.tools.profile_lio import sync_sites
    rng = np.random.default_rng(3)
    boxes = np.c_[rng.uniform(-15, 15, (256, 2)), rng.uniform(-0.5, 1.5, 256),
                  rng.uniform(0.5, 5.0, (256, 3)), rng.uniform(-np.pi, np.pi, 256)]
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    scores = torch.as_tensor(rng.uniform(0, 1, 256), dtype=torch.float32)
    mask = torch.as_tensor(rng.uniform(size=256) > 0.2)
    for fn in ("boxes_overlap_bev", "boxes_iou3d", "boxes_giou3d"):
        a = getattr(iou3d, fn)(boxes, boxes[:100])
        b = getattr(iou3d, fn)(boxes.to(cuda), boxes[:100].to(cuda)).cpu()
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
    for thresh, keep in ((0.1, 128), (0.5, 64)):
        ci, ck = iou3d.nms_bev(boxes, scores, mask, thresh, keep)
        args = (boxes.to(cuda), scores.to(cuda), mask.to(cuda), thresh, keep)
        iou3d.nms_bev(*args)
        (gi, gk), sites = sync_sites(lambda: iou3d.nms_bev(*args))
        assert not sites, sites
        assert torch.equal(gk.cpu(), ck) and torch.equal(gi.cpu()[ck], ci[ck])
        assert 5 < int(ck.sum()) < keep


@pytest.mark.parametrize("s2d", [1, 2])
def test_detector_float32_on_card_matches_cpu(cuda, s2d):
    from lsd_tpu_torch.models.detector import (CenterPointDetector, DetectorConfig,
                                               init_detector_params)
    cfg = DetectorConfig(pc_range=(-25.6, -25.6, -3.0, 25.6, 25.6, 3.0),
                         voxel_size=(0.2 / s2d, 0.2 / s2d, 6.0), max_voxels=65536,
                         max_points_per_voxel=8, bev_stride=2, s2d_factor=s2d)
    model = CenterPointDetector(cfg, dtype=torch.float32)
    init_detector_params(model, torch.Generator().manual_seed(0))
    pts, mask = _scene(2)
    pts[:, :2] *= 0.4
    with torch.no_grad():
        ref = model(torch.as_tensor(pts), torch.as_tensor(mask))
        got = model.to(cuda)(torch.as_tensor(pts, device=cuda), torch.as_tensor(mask, device=cuda))
    for k, v in ref.items():
        err = float((got[k].cpu() - v).abs().max()) / float(v.abs().max())
        assert err <= 1e-3, (k, err)


def test_tracker_on_card_matches_cpu(cuda):
    from lsd_tpu_torch.detection.tracker import Tracker3D, TrackerConfig
    rng = np.random.default_rng(5)
    base = np.c_[rng.uniform(-30, 30, (10, 2)), np.full(10, 0.8),
                 np.tile([4.5, 1.9, 1.6], (10, 1)), rng.uniform(-3, 3, 10)]
    motion = np.eye(4)
    motion[0, 3] = -1.0
    trackers = [Tracker3D(TrackerConfig(), device=d) for d in ("cpu", cuda)]
    for k in range(15):
        boxes = base.copy()
        boxes[:, 0] -= k
        boxes = boxes[rng.uniform(size=10) > 0.15] + rng.normal(0, 0.03, (1, 7))
        scores = rng.uniform(0.2, 0.9, len(boxes))
        outs = [t.update(boxes, scores, np.zeros(len(boxes), int), 0.1, motion if k else None)
                for t in trackers]
        assert [o["id"] for o in outs[0]["objects"]] == [o["id"] for o in outs[1]["objects"]]
        for a, b in zip(*(o["objects"] for o in outs)):
            np.testing.assert_allclose(a["box"], b["box"], rtol=0, atol=1e-9)


def test_predict_on_card_makes_no_host_sync(cuda):
    from lsd_tpu_torch.detection.accumulate import FrameAccumulator
    from lsd_tpu_torch.models.detector import DetectorConfig
    from lsd_tpu_torch.runtime.modules import build_detector_predict_fn
    from lsd_tpu_torch.tools.profile_detector import ego_drive
    from lsd_tpu_torch.tools.profile_lio import sync_sites
    fn = build_detector_predict_fn(det_cfg=DetectorConfig.reference_capacity(), with_seg=True)
    frames, _ = ego_drive(2)
    acc = FrameAccumulator(2, frames[0][0].shape[0])
    for f in frames:
        pts, msk = acc.push(*f)
    fn(pts, msk)
    out, sites = sync_sites(lambda: fn(pts, msk))
    assert not sites, sites
    assert all(t.device.type == "cuda" for t in out)
    assert out[0].shape == (128, 7) and int(out[3].sum()) > 3


def test_resize_on_card_equals_cpu(cuda):
    from lsd_tpu_torch.utils.image import resize_linear
    rng = np.random.default_rng(0)
    for src, dst in (((1080, 1920), (384, 640)), ((1080, 1920), (256, 320)), ((96, 160), (384, 640))):
        img = torch.as_tensor(rng.integers(0, 256, (*src, 3), dtype=np.uint8))
        assert torch.equal(resize_linear(img.to(cuda), dst).cpu(), resize_linear(img, dst))


def _shipped(name):
    from lsd_tpu_torch.models.params_io import load_params
    return load_params(f"weights/{name}.msgpack")


def test_mono3d_float32_on_card_matches_cpu(cuda):
    from lsd_tpu_torch.convert import load_camera_params
    from lsd_tpu_torch.models.mono3d import Mono3D, Mono3DConfig, decode_mono3d, maps_hwc
    model = Mono3D(Mono3DConfig(image_hw=(192, 320)))
    load_camera_params(model, _shipped("mono3d"))
    img = torch.as_tensor(np.random.default_rng(1).random((1, 3, 192, 320)).astype(np.float32))
    K = torch.tensor([[280.0, 0, 160], [0, 280.0, 96], [0, 0, 1]])
    out = []
    with torch.no_grad():
        for d, tf32 in (("cpu", False), (cuda, False), (cuda, True)):
            torch.backends.cudnn.allow_tf32 = tf32
            try:
                maps = maps_hwc(model.to(d).eval()(img.to(d)))
            finally:
                torch.backends.cudnn.allow_tf32 = False
            out.append(({k: v.cpu() for k, v in maps.items()},
                        [a.cpu() for a in decode_mono3d(maps, K.to(d), 64, 4)]))
    (ref_maps, ref_dec), (maps, dec), (tf32_maps, _) = out

    def worst(got):
        return max(float((got[k] - v).abs().max() / v.abs().max()) for k, v in ref_maps.items())
    # TF32 off meets the CPU parity bar; the control with TF32 on breaks it
    assert worst(maps) <= 1e-4 < worst(tf32_maps)
    valid = ref_dec[3]
    assert torch.equal(dec[3], valid) and torch.equal(dec[2][valid], ref_dec[2][valid])
    torch.testing.assert_close(dec[0][valid], ref_dec[0][valid], rtol=1e-3, atol=1e-3)


def test_yolo2d_bf16_on_card_matches_cpu_and_nms_makes_no_sync(cuda):
    from lsd_tpu_torch.convert import load_camera_params
    from lsd_tpu_torch.models.mono3d import maps_hwc
    from lsd_tpu_torch.models.yolo2d import Yolo2D, Yolo2DConfig, decode_yolo2d, nms_2d
    from lsd_tpu_torch.tools.profile_lio import sync_sites
    model = Yolo2D(Yolo2DConfig(num_classes=4))
    load_camera_params(model, _shipped("yolo2d_trafficlight"))
    img = torch.as_tensor(np.random.default_rng(2).random((1, 3, 256, 320)).astype(np.float32))
    with torch.no_grad():
        ref = maps_hwc(model.eval()(img))
        got = maps_hwc(model.to(cuda)(img.to(cuda)))
    for k, v in ref.items():
        assert float((got[k].cpu() - v).abs().max() / v.abs().max()) <= 3e-2, k
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 200, (64, 2))
    boxes = torch.as_tensor(np.c_[xy, xy + rng.uniform(5, 60, (64, 2))], dtype=torch.float32)
    scores = torch.as_tensor(np.round(rng.uniform(0, 1, 64), 2), dtype=torch.float32)
    mask = torch.as_tensor(rng.uniform(size=64) > 0.2)
    want = nms_2d(boxes, scores, mask)
    args = (boxes.to(cuda), scores.to(cuda), mask.to(cuda))
    nms_2d(*args)
    keep, sites = sync_sites(lambda: nms_2d(*args))
    assert not sites, sites
    assert torch.equal(keep.cpu(), want) and 3 < int(want.sum()) < int(mask.sum())
    _, sites = sync_sites(lambda: decode_yolo2d(got, 16, 64))
    assert not sites, sites


def test_mono3d_infer_fetches_once(cuda):
    from lsd_tpu_torch.detection.mono3d_infer import Mono3DInfer
    from lsd_tpu_torch.tools.profile_lio import sync_sites
    infer = Mono3DInfer()
    img = np.random.default_rng(4).integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    K = np.asarray([[1000.0, 0, 960], [0, 1000.0, 540], [0, 0, 1]])
    infer.detect(img, K)
    with torch.inference_mode():
        x, Ks = infer._prep(img, K)
        _, sites = sync_sites(lambda: infer._predict(x, Ks))
    assert not sites, sites
    det, sites = sync_sites(lambda: infer.detect(img, K))
    assert sum(sites.values()) == 1, sites
    assert det["heat"].shape == (96, 160, 4) and np.isfinite(det["heat"]).all()
    ref = Mono3DInfer(device="cpu").detect(img, K)
    assert [o["label"] for o in det["camera_objs"]] == [o["label"] for o in ref["camera_objs"]]


@pytest.mark.parametrize("m,k,n", [(8, 64, 32), (17, 64, 32), (17, 16, 8), (24, 64, 32),
                                   (300, 33, 12), (15360, 64, 12)])
def test_quantized_matmul_int_mm_on_card_equals_cpu(cuda, m, k, n):
    from lsd_tpu_torch.models import quantize as tq
    rng = np.random.default_rng(m)
    a = torch.as_tensor(rng.integers(-127, 128, (m, k), dtype=np.int8))
    b = torch.as_tensor(rng.integers(-127, 128, (k, n), dtype=np.int8))
    assert torch.equal(tq._int_mm(a.to(cuda), b.to(cuda)).cpu(), tq._int_mm(a, b))
    x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32))
    scale = torch.as_tensor(rng.uniform(0.01, 0.1, n).astype(np.float32))
    torch.testing.assert_close(tq.quantized_matmul(x.to(cuda), b.to(cuda), scale.to(cuda)).cpu(),
                               tq.quantized_matmul(x, b, scale), rtol=0, atol=0)


def test_first_kernel_build_off_the_main_thread(cuda, tmp_path, monkeypatch):
    """Two pipeline threads reach the p2p kernel first at once: one nvcc
    build, both launches right."""
    import threading
    from lsd_tpu_torch.ops import p2p
    from lsd_tpu_torch.utils import cuda_build
    runs = []
    real_run = cuda_build.subprocess.run

    def counted(cmd, *a, **k):
        runs.append(cmd)
        return real_run(cmd, *a, **k)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build.subprocess, "run", counted)
    cuda_build._load.cache_clear()
    p2p._library.cache_clear()
    args = _inputs(4096, cuda)
    want = p2p.p2p_reduce_plain(*args, 1.0)
    got, errors = [], []

    def worker():
        try:
            got.append(p2p.p2p_reduce(*args, 1.0))
        except Exception as exc:    # reported below: the thread must not die silently
            errors.append(exc)
    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    cuda_build._load.cache_clear()
    p2p._library.cache_clear()
    assert not errors and len(runs) == 1 and len(got) == 2
    for out in got:
        torch.testing.assert_close(out[2][0], want[2][0], rtol=0, atol=0)


def test_slam_module_on_card_matches_cpu(cuda):
    """``SlamModule`` (mapping, pipelined fetch, graph work inline) over 12
    frames with RTK fixes on each device, driven from a thread of its own as
    the pipeline drives it: the same keyframes and GPS priors, poses within
    0.02 m, three p2p launches a frame on the card."""
    import threading
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.runtime import clear_interfaces
    from lsd_tpu_torch.runtime.config import ConfigManager
    from lsd_tpu_torch.runtime.modules import SlamModule
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.slam.lio import lio_init
    from lsd_tpu_torch.tools.profile_lio import nav_at_start
    from lsd_tpu_torch.tools.recording import fix_projector, frame_dict, truth_fix
    sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=24, points_per_scan=4096,
                              point_noise=0.01, seed=21))
    proj, p0 = fix_projector(), sim.pose(0.0)[1]
    frames = [frame_dict(s, 1_000_000 + k * 100_000,
                         truth_fix(sim, (k + 1) * 0.1, 1_100_000 + k * 100_000, proj, p0))
              for k, s in enumerate(sim.generate(capacity=4096, imu_capacity=16))]
    runs = {}
    for dev in ("cpu", cuda):
        clear_interfaces()
        cfg = ConfigManager().config
        cfg.slam.update(resolution=0.4, key_frames_interval=[1.5, 0.3], async_graph=False)
        m = SlamModule(cfg, device=dev)
        m.setup(cfg)
        m.engine.lio_state = lio_init(m.engine.cfg.lio, nav_at_start(sim, dev))
        before = p2p_reduce.launches.read()
        poses = []
        t = threading.Thread(target=lambda: poses.extend(
            m.process(dict(d))["slam_pose"].copy() for d in frames + frames[-1:]))
        t.start()
        t.join()
        assert len(poses) == len(frames) + 1 and len(m.engine.odometry) == len(frames)
        if dev != "cpu":
            assert p2p_reduce.launches.read() - before == 3 * len(frames)
        runs[str(dev)] = m.engine, np.stack(poses)
        clear_interfaces()
    (ce, cp), (ge, gp) = runs["cpu"], runs["cuda:0"]
    assert [kf.stamp_us for kf in ge.store.frames] == [kf.stamp_us for kf in ce.store.frames]
    assert len(ge.graph.gps) == len(ce.graph.gps) >= 2
    np.testing.assert_allclose(gp, cp, rtol=0, atol=0.02)
    np.testing.assert_allclose(np.stack([g[1] for g in ge.graph.gps]),
                               np.stack([g[1] for g in ce.graph.gps]), rtol=0, atol=0.02)


@pytest.mark.parametrize("n_cloud,n_query", [(700, 37), (70000, 2000)])
def test_knn_mean_colors_on_card_matches_cpu(cuda, n_cloud, n_query):
    from lsd_tpu_torch.slam.mesh import knn_mean_colors
    rng = np.random.default_rng(n_cloud)
    cloud = rng.normal(size=(n_cloud, 3)).astype(np.float32) * 4
    rgb = rng.uniform(0, 255, (n_cloud, 3)).astype(np.float32)
    q = rng.normal(size=(n_query, 3)).astype(np.float32) * 4
    want = knn_mean_colors(cloud, rgb, q, device="cpu")
    got = knn_mean_colors(cloud, rgb, q, device=cuda)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def _small_trainer(model, dev):
    from lsd_tpu_torch.models.detector import DetectorConfig
    from lsd_tpu_torch.models.mono3d import Mono3DConfig
    from lsd_tpu_torch.models.yolo2d import Yolo2DConfig
    from lsd_tpu_torch.training import camera_data as cd
    from lsd_tpu_torch.training.data import SyntheticDetectionDataset, SyntheticSceneConfig
    from lsd_tpu_torch.training.mono3d import Mono3DTrainer
    from lsd_tpu_torch.training.trainer import Trainer
    from lsd_tpu_torch.training.yolo import YoloTrainer
    if model == "detector":
        cfg = DetectorConfig.reference_capacity()._replace(
            pc_range=(-25.6, -25.6, -3.0, 25.6, 25.6, 3.0), max_voxels=16384)
        ds = SyntheticDetectionDataset(SyntheticSceneConfig(realistic=True, xy_range=24.0),
                                       point_capacity=2 ** 14, batch_size=2, seed=1)
        return Trainer(cfg, device=dev, dtype=torch.float32), ds
    if model == "mono3d":
        hw = (96, 160)
        return (Mono3DTrainer(Mono3DConfig(image_hw=hw, base_ch=8), device=dev),
                cd.SyntheticMono3DDataset(cd.Mono3DSceneConfig(hw=hw), batch_size=2, seed=1))
    hw = (128, 160)
    return (YoloTrainer(Yolo2DConfig(num_classes=4), hw=hw, device=dev),
            cd.SyntheticTrafficLightDataset(cd.TrafficLightSceneConfig(hw=hw), batch_size=4,
                                            seed=1))


@pytest.mark.parametrize("model", ["detector", "mono3d", "yolo2d"])
def test_training_step_on_card_matches_cpu_and_makes_no_sync(cuda, model):
    from lsd_tpu_torch.tools.profile_lio import sync_sites
    cpu, ds = _small_trainer(model, "cpu")
    card, _ = _small_trainer(model, cuda)
    card.model.load_state_dict(cpu.model.state_dict())
    batch = next(ds.batches(1))
    grads = []
    for tr in (cpu, card):
        loss, _ = tr.loss_on_batch(tr.upload(batch))
        loss.backward()
        grads.append({n: p.grad.detach().cpu().double() for n, p in tr.model.named_parameters()})
        tr.opt.zero_grad()
    for n, want in grads[0].items():
        got = grads[1][n]
        if model != "yolo2d":
            assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max()), n
        elif not (n.startswith("ConvBlock") and n.endswith("Conv_0.bias")):
            g, w = got.reshape(-1), want.reshape(-1)
            assert float(g @ w / (g.norm() * w.norm())) >= 0.999, n
            assert float((g - w).norm() / w.norm()) <= 0.05, n
    card.train_step(card.upload(batch))
    (loss, aux), sites = sync_sites(lambda: card.train_step(card.upload(batch)))
    assert not sites, sites
    assert loss.device == card.device and bool(torch.isfinite(loss))


@pytest.mark.parametrize("world", ["corridor", "fig8", "route"])
def test_sim_scans_reach_the_card_unchanged(cuda, world):
    from lsd_tpu_torch import sim
    cfg = sim.SimConfig(radius=8.0, n_scans=3, points_per_scan=4096, point_noise=0.01, seed=7,
                        rest_time=0.1, ramp_time=0.1)
    s = {"corridor": lambda: sim.CorridorSim(cfg),
         "fig8": lambda: sim.FigureEightSim(cfg, laps=0.2, gps_outlier_rate=0.3),
         "route": lambda: sim.RouteSim(cfg, laps=0.2)}[world]()
    for scan in s.generate(capacity=4096, imu_capacity=16):
        for a in scan:
            back = torch.as_tensor(a).to(cuda).cpu().numpy()
            assert back.dtype == a.dtype and back.tobytes() == a.tobytes()


def test_evaluate_mot_iou_on_card_equals_cpu(cuda):
    from lsd_tpu_torch.detection.eval import _iou_matrix, evaluate_mot
    rng = np.random.default_rng(3)
    frames = []
    for k in range(12):
        gt = np.concatenate([rng.uniform(-30, 30, (6, 2)) + 0.2 * k, np.zeros((6, 1)),
                             rng.uniform(1, 5, (6, 3)), rng.uniform(-3, 3, (6, 1))], axis=1)
        boxes = gt + rng.normal(0, 0.2, gt.shape) * [1, 1, 0, 0.2, 0.2, 0.2, 0.1]
        frames.append(dict(gt_ids=np.arange(6), gt_boxes=gt, track_ids=np.arange(6) + (k > 6),
                           boxes=boxes, scores=rng.random(6)))
    a, b = frames[0]["gt_boxes"], frames[0]["boxes"]
    np.testing.assert_allclose(_iou_matrix(a, b, cuda), _iou_matrix(a, b), rtol=1e-5, atol=1e-5)
    got, want = evaluate_mot(frames, device=cuda), evaluate_mot(frames)
    for k in ("ids", "misses", "false_pos", "n_gt", "tp"):
        assert got[k] == want[k]
    for k in ("amota", "amotp", "mota", "motp"):
        assert abs(got[k] - want[k]) <= 1e-5


def test_run_tpu_lio_runs_on_the_card_by_default(cuda):
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.sim import CorridorSim, SimConfig
    from lsd_tpu_torch.tools.evaluate import run_tpu_lio
    sim = CorridorSim(SimConfig(n_scans=12, points_per_scan=8192, point_noise=0.01, seed=5,
                                rest_time=0.3, ramp_time=0.3))
    data = sim.generate(capacity=8192, imu_capacity=16)
    p2p_reduce.launches.reset()
    ate, ms, _ = run_tpu_lio(sim, data, 4)
    assert p2p_reduce.launches.read() == 4 * len(data)
    assert np.isfinite(ate) and ate < 0.1 and ms > 0


def test_evaluate_raises_without_a_card(cuda, monkeypatch):
    from lsd_tpu_torch.tools import evaluate
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--skip-reference", "--scans", "30"])
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.run_tpu_lio(None, [], 0)


def _online_frames(n, points, tmp_path):
    """Frames of the online source: ``n`` scans of the 8 m ring (seed 21)
    streamed as Custom datagrams through ``SourceManager`` in online mode,
    with GPCHC fixes stamped in GPS time (so no IMU row), as phase 13 of
    ``chip_smoke.py`` sends them."""
    import socket
    import struct
    import threading
    import time
    from lsd_tpu_torch.io.gpchc import format_gpchc
    from lsd_tpu_torch.runtime.config import ConfigManager
    from lsd_tpu_torch.runtime.source_manager import SourceManager
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.tools.recording import fix_projector, truth_fix
    sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=n, points_per_scan=points,
                              point_noise=0.01, seed=21))
    data = sim.generate(capacity=points, imu_capacity=16)
    proj, p0 = fix_projector(), sim.pose(0.0)[1]
    ports = []
    for _ in range(2):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    cfg = ConfigManager().config
    cfg["input"].update(mode="online", scan_hz=10.0)
    cfg["lidar"] = [dict(name="0-Custom", port=ports[0], decoder="Custom", range_min=0.0)]
    cfg["ins"].update(use=True, port=ports[1])
    src = SourceManager(cfg)
    src.setup(cfg)

    def send():
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        t0 = time.perf_counter() + 0.15
        for k, scan in enumerate(data):
            for j in range(10):
                time.sleep(max(0.0, t0 + k / 10 + j / 100 - time.perf_counter()))
                tx.sendto(format_gpchc(truth_fix(sim, k / 10 + j / 100,
                                                 1_700_000_000_000_000 + (k * 10 + j) * 10_000,
                                                 proj, p0)).encode(), ("127.0.0.1", ports[1]))
                if j == 0:
                    pts = np.concatenate([scan[0], np.zeros((points, 1), np.float32)], axis=1)
                    tx.sendto(struct.pack("<IIQ", 0x4C53444C, points, k) + pts.tobytes(),
                              ("127.0.0.1", ports[0]))
        tx.close()
    frames = []
    sender = threading.Thread(target=send, daemon=True)
    try:
        sender.start()
        deadline = time.time() + n / 10 + 5
        while time.time() < deadline and \
                sum(len(f["points"]["0-Custom"]) for f in frames) < n * points:
            d = src.get_data()
            if d is not None:
                frames.append(d)
    finally:
        sender.join(5)
        src.release()
    assert sum(len(f["points"]["0-Custom"]) for f in frames) == n * points
    return sim, frames


def test_online_frames_slam_module_on_card_matches_cpu(cuda, tmp_path):
    """Frames captured live by the online source (10 scans of 4,000 points,
    each one Custom datagram,
    no IMU row) through ``SlamModule`` on the card and on the CPU (mapping,
    graph work and fetch synchronous, the LIO seeded at the simulator's
    start): poses within 0.02 m (the ``SlamModule`` bar above), three p2p
    launches a frame on the card."""
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.runtime import clear_interfaces
    from lsd_tpu_torch.runtime.config import ConfigManager
    from lsd_tpu_torch.runtime.modules import SlamModule
    from lsd_tpu_torch.slam.lio import lio_init
    from lsd_tpu_torch.tools.profile_lio import nav_at_start
    sim, frames = _online_frames(10, 4000, tmp_path)
    assert all(len(f["imu_data"]) == 0 for f in frames)
    poses = {}
    for dev in ("cpu", cuda):
        clear_interfaces()
        cfg = ConfigManager().config
        cfg.input.mode = "online"
        cfg.slam.update(resolution=0.4, key_frames_interval=[1.5, 0.3], async_graph=False,
                        async_fetch=False)
        m = SlamModule(cfg, device=dev)
        m.setup(cfg)
        m.engine.lio_state = lio_init(m.engine.cfg.lio, nav_at_start(sim, dev))
        before = p2p_reduce.launches.read()
        poses[str(dev)] = np.stack([m.process(dict(f))["slam_pose"].copy() for f in frames])
        if dev != "cpu":
            assert p2p_reduce.launches.read() - before == 3 * len(frames)
        m.release()
        clear_interfaces()
    assert np.isfinite(poses["cuda:0"]).all()
    np.testing.assert_allclose(poses["cuda:0"], poses["cpu"], rtol=0, atol=0.02)


def test_run_server_on_card_answers_status(cuda, tmp_path):
    """What ``python -m lsd_tpu_torch run`` starts (``start_system``), with
    no ``--device``: ``Perception`` on the card over a recording through
    Source -> SLAM -> Sink, the web API on port 0 answering ``/v1/status``
    and serving the UI, the SLAM stage on the card."""
    import json
    import time
    import urllib.request
    from lsd_tpu_torch.__main__ import start_system, stop_system
    from lsd_tpu_torch.runtime import clear_interfaces
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.tools.recording import write_recording
    sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=6, points_per_scan=2048, seed=3))
    rec = write_recording(str(tmp_path / "rec"), sim, sim.generate(capacity=2048, imu_capacity=16))
    clear_interfaces()
    p, srv, upgrade, port = start_system(data=rec, host="127.0.0.1", port=0)
    try:
        assert p.device.type == "cuda"
        assert p.module_manager.modules["SLAM"].device.type == "cuda"
        deadline = time.time() + 120
        status = {}
        while time.time() < deadline:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/status", data=b"{}")
            with urllib.request.urlopen(req, timeout=10) as r:
                status = json.loads(r.read())
            if status["modules"]["SLAM"]["frames"] >= 6:
                break
            time.sleep(0.2)
        assert status["status"] == "Running" and status["modules"]["SLAM"]["frames"] >= 6
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10) as r:
            assert b"<!DOCTYPE html>" in r.read()
    finally:
        stop_system(p, srv, upgrade)
        clear_interfaces()


# -- DSVT-Pillar -------------------------------------------------------------

def _waymo_frame(seed=11):
    import json
    from pathlib import Path
    from port_bench.gen import street
    root = Path(__file__).resolve().parent.parent
    tr = json.loads((root / "port_bench" / "traffic" / "urban-drive-waymo-top.json").read_text())
    return tr, street.Street(tr, seed).frame(0)


def _dsvt_frame(dev, seed=11):
    """A bench-size frame's pillars and partitions, seeded bf16 Q|K and V."""
    from lsd_tpu_torch.models.detector import DetectorConfig
    from lsd_tpu_torch.models.dsvt import DSVTConfig, partition_shift
    from lsd_tpu_torch.ops.voxelize import pillarize_dynamic
    _, frame = _waymo_frame(seed)
    pts = torch.as_tensor(frame, device=dev)
    cfg = DetectorConfig.dsvt_pillar()
    pil = pillarize_dynamic(pts, torch.ones(len(pts), dtype=torch.bool, device=dev),
                            cfg.voxel_size, cfg.pc_range, cfg.max_voxels)
    coords, pmask = pil[3], pil[4]
    parts = [p for win, sh in DSVTConfig().shifts()
             for p in partition_shift(coords, pmask, win, sh, cfg.grid_hw, 36)[:2]]
    g = torch.Generator(device=dev).manual_seed(seed)
    qk = torch.randn(cfg.max_voxels, 384, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(cfg.max_voxels, 192, generator=g, device=dev).to(torch.bfloat16)
    return cfg, pts, pil, parts, qk, v


def test_dsvt_kernel_matches_plain_at_bench_size(cuda):
    from lsd_tpu_torch.models.dsvt import WRITE, set_attention, set_attention_plain
    _, _, pil, parts, qk, v = _dsvt_frame(cuda)
    assert 30000 < int(pil[4].sum()) < 73728
    for part in parts:
        got = set_attention(qk[:, :192], qk[:, 192:], v, part, 8)
        want = set_attention_plain(qk[:, :192], qk[:, 192:], v, part, 8)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max() / want.float().abs().max()
        assert err <= 1e-2, float(err)
        written = torch.zeros(v.shape[0], dtype=torch.bool, device=cuda)
        written[part.inds.long()[(part.flags & WRITE).bool()]] = True
        assert torch.equal(written, pil[4])             # every pillar once, nothing else
        assert not got[~written].any()
        assert torch.equal(got, set_attention(qk[:, :192], qk[:, 192:], v, part, 8))


def _dsvt_model(dev, seed=0):
    from lsd_tpu_torch.models.detector import (CenterPointDetector, DetectorConfig,
                                               init_detector_params)
    model = CenterPointDetector(DetectorConfig.dsvt_pillar())
    init_detector_params(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval().requires_grad_(False).fold()


def test_dsvt_is_one_launch_per_layer_and_makes_no_sync(cuda):
    from lsd_tpu_torch.models.dsvt import set_attention
    from lsd_tpu_torch.tools.profile_lio import sync_sites
    model = _dsvt_model(cuda)
    _, pts, _, _, _, _ = _dsvt_frame(cuda)
    mask = torch.ones(len(pts), dtype=torch.bool, device=cuda)
    with torch.inference_mode():
        model.encode(pts, mask)
        before = set_attention.launches
        _, sites = sync_sites(lambda: model.encode(pts, mask))
    assert sites == {}, f"the DSVT path made host syncs: {sites}"
    assert set_attention.launches == before + 8


def test_dsvt_kernel_graph_replay_equals_a_direct_call(cuda):
    from lsd_tpu_torch.models.dsvt import set_attention
    _, _, _, parts, qk, v = _dsvt_frame(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        set_attention(qk[:, :192], qk[:, 192:], v, parts[1], 8)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = set_attention(qk[:, :192], qk[:, 192:], v, parts[1], 8)
    for scale in (1.0, 0.5):       # the replay reads V as it is now
        v.mul_(scale)
        graph.replay()
        direct = set_attention(qk[:, :192], qk[:, 192:], v, parts[1], 8)
        torch.cuda.synchronize()
        assert torch.equal(captured, direct)


def test_dsvt_pillar_on_card_matches_plain_reference(cuda, tmp_path):
    import json
    from pathlib import Path
    from lsd_tpu_torch.models import dsvt_plain
    from lsd_tpu_torch.models.detector import DetectorConfig
    from lsd_tpu_torch.models.params_io import load_params
    from lsd_tpu_torch.runtime.modules import build_detector_predict_fn
    from port_bench.drivers.dsvt_drive import (candidates, check_numbers, frame_gaps,
                                               numpy_candidates, write_weights)
    root = Path(__file__).resolve().parent.parent
    limits = json.loads((root / "port_bench" / "limits" / "dsvt-drive.json").read_text())
    conf = json.loads((root / "port_bench" / "configs" / "dsvt-pillar-waymo.json").read_text())
    cfg = DetectorConfig.dsvt_pillar()
    # the benchmark's weights: biases, norm scales and BatchNorm statistics drawn too
    path = str(write_weights(5, tmp_path / "dsvt.msgpack"))
    predict = build_detector_predict_fn(weights=path, det_cfg=cfg, device=cuda)
    _, frame = _waymo_frame(seed=5)
    rec = {}
    model = predict.model
    encode, decode = model.encode, model.decode
    model.encode = lambda p, m: rec.setdefault("features", encode(p, m))
    model.dsvt.blocks[0].layers[0].out.register_forward_pre_hook(
        lambda mod, args: rec.setdefault("attention0", args[0].clone()))

    def keep(preds):
        rec.update(preds)
        rec["pre"] = numpy_candidates(decode(preds))
        return decode(preds)
    model.decode = keep
    predict(frame, np.ones(len(frame), bool))
    ref = dsvt_plain.forward(dsvt_plain.flatten(load_params(path)), frame, cuda)
    gaps = check_numbers([frame_gaps(rec, ref, candidates(ref, conf))])
    assert all(v <= limits[k] for k, v in gaps.items()), gaps
