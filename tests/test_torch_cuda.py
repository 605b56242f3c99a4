"""The port's CUDA kernels on the card (skipped where there is none).

This file imports only torch and numpy, so it runs on a machine with a card
and no JAX.  Run it there with

    python -m pytest tests/test_torch_cuda.py -m cuda -o addopts="" --noconftest -q

(``--noconftest``: the suite's conftest sets up JAX).  Each kernel is held
against its plain PyTorch version on the card.  Tolerances for
``p2p_reduce``: HtH within 1e-5 * max|HtH| and Htr within
1e-4 * max(|Htr|, 1) (the kernel sums in a fixed block order, the plain
version through a matmul); n_valid exact (both round each operation alike,
the kernel being built without FMA contraction); two launches bitwise equal.
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
def test_p2p_kernel_matches_plain(cuda, n, est_ext):
    from lsd_tpu_torch.ops.p2p import p2p_reduce, p2p_reduce_plain
    args = _inputs(n, cuda, seed=n)
    before = p2p_reduce.launches
    out = p2p_reduce(*args, 1.0, est_extrinsic=est_ext)
    again = p2p_reduce(*args, 1.0, est_extrinsic=est_ext)
    assert p2p_reduce.launches == before + 2
    ref = p2p_reduce_plain(*args, 1.0, est_extrinsic=est_ext)
    torch.cuda.synchronize()
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    H, r, s = out
    rH, rr, rs = ref
    assert float((H - rH).abs().max()) <= 1e-5 * float(rH.abs().max())
    assert float((r - rr).abs().max()) <= 1e-4 * max(float(rr.abs().max()), 1.0)
    assert float(s[0]) == float(rs[0])
    torch.testing.assert_close(s[1:], rs[1:], rtol=1e-5, atol=1e-6)
    if not est_ext:
        assert float(H[18:].abs().max()) == 0.0 and float(r[18:].abs().max()) == 0.0


def test_p2p_kernel_all_masked(cuda):
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    args = list(_inputs(4096, cuda))
    args[3] = torch.zeros_like(args[3])
    H, r, s = p2p_reduce(*args, 1.0)
    assert float(H.abs().max()) == 0.0 and float(r.abs().max()) == 0.0
    assert float(s.abs().max()) == 0.0


def test_p2p_wrapper_rejects_mixed_devices(cuda):
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    args = list(_inputs(64, cuda))
    args[4] = args[4].cpu()
    with pytest.raises(ValueError):
        p2p_reduce(*args, 1.0)


def test_lio_step_on_card_matches_cpu(cuda):
    """Six small scans on the card and on the CPU end within 1e-3 m."""
    from lsd_tpu_torch.geometry import so3
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.slam.lio import LioConfig, lio_init, lio_step
    from lsd_tpu_torch.slam.state import init_state
    sim = CircleSim(SimConfig(n_scans=6, points_per_scan=2048, point_noise=0.01, seed=5))
    data = sim.generate(capacity=2048, imu_capacity=16)
    R0, p0 = sim.pose(0.0)
    cfg = LioConfig(ds_capacity=1024, map_capacity=2 ** 13)
    final = {}
    for dev in ("cpu", cuda):
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        nav0 = init_state(device=dev)._replace(pos=f(p0), quat=so3.matrix_to_quat(f(R0)),
                                               vel=f(sim.velocity(0.0)))
        st = lio_init(cfg, nav0)
        before = p2p_reduce.launches
        for tup in data:
            st, _ = lio_step(cfg, st, *[torch.as_tensor(a, device=dev) for a in tup[:5]])
        if dev != "cpu":
            assert p2p_reduce.launches - before == cfg.max_iters * len(data)
        final[str(dev)] = st.nav.pos.cpu().numpy()
    np.testing.assert_allclose(final["cuda:0"], final["cpu"], atol=1e-3)
