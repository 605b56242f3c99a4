"""Port parity: slam/imu of lsd_tpu_torch against lsd_tpu on the CPU.

IMU batches come from the numpy simulator (a copy in each package; the two
give identical arrays) and from seeded noise.  Tolerances: state, track and
covariance rtol 1e-5 with atol 1e-6 (float32 rounding of the same
recursion; the plain loop over masked slot layouts likewise, with a dense
covariance within 1e-5 of its largest entry); undistorted points atol 5e-5 m (a few float32 ulps at 40 m
range: the frame transforms are matmuls whose summation order differs
between XLA and PyTorch).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.geometry import so3 as jso3
from lsd_tpu.sim import CircleSim as JCircleSim
from lsd_tpu.sim import SimConfig as JSimConfig
from lsd_tpu.slam import imu as jimu
from lsd_tpu.slam.state import init_state as jinit
from lsd_tpu_torch.sim import CircleSim, SimConfig
from lsd_tpu_torch.slam import imu as timu
from lsd_tpu_torch.slam.state import NavState


def _close(j, t, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _scan(seed=3, imu_capacity=16, gyro_noise=0.0):
    cfg = SimConfig(n_scans=2, points_per_scan=4096, point_noise=0.01,
                    gyro_noise=gyro_noise, acc_noise=gyro_noise, seed=seed)
    sim = CircleSim(cfg)
    data = sim.generate(capacity=4096, imu_capacity=imu_capacity)
    R, p = sim.pose(0.0)
    nav = jinit()._replace(pos=jnp.asarray(p, jnp.float32),
                           quat=jso3.matrix_to_quat(jnp.asarray(R, jnp.float32)),
                           vel=jnp.asarray(sim.velocity(0.0), jnp.float32),
                           bg=jnp.asarray([1e-4, -2e-4, 3e-4], jnp.float32),
                           ext_q=jnp.asarray([0.999, 0.01, -0.02, 0.03], jnp.float32),
                           ext_t=jnp.asarray([0.1, -0.05, 0.2], jnp.float32))
    return data[1], nav


def _tnav(nav):
    return NavState(*[torch.as_tensor(np.array(a)) for a in nav])


def test_sim_copy_is_identical():
    a = CircleSim(SimConfig(n_scans=2, points_per_scan=512, seed=11)).generate(512, 16)
    b = JCircleSim(JSimConfig(n_scans=2, points_per_scan=512, seed=11)).generate(512, 16)
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("imu_capacity,noise", [(16, 0.0), (8, 0.0), (16, 0.01)])
def test_propagate_matches_reference(imu_capacity, noise):
    (P_, S_, M_, I_, IM_, _), nav = _scan(imu_capacity=imu_capacity, gyro_noise=noise)
    if imu_capacity == 16:
        IM_ = IM_.copy()
        IM_[5] = False                          # a masked sample mid-batch
    P0 = (np.eye(24) * 1e-4).astype(np.float32)
    js, jP, jtr = jimu.propagate(nav, jnp.asarray(P0), jnp.asarray(I_), jnp.asarray(IM_),
                                 jimu.ImuNoise())
    ts, tP, ttr = timu.propagate(_tnav(nav), torch.as_tensor(P0), torch.as_tensor(I_),
                                 torch.as_tensor(IM_), timu.ImuNoise())
    for a, b in zip(js, ts):
        _close(a, b)
    _close(jP, tP, atol=1e-9)
    for k in ("t", "quat", "pos", "vel"):
        _close(jtr[k], ttr[k])


def _layout(name):
    """A masked slot layout of the simulator's batch (11 valid rows at 100
    Hz): 11 of 16 or of 64 slots, none valid, or an interval above 0.1 s."""
    (_, _, _, I_, IM_, _), nav = _scan(imu_capacity=64 if name == "11_of_64" else 16,
                                       gyro_noise=0.01)
    I_, IM_ = I_.copy(), IM_.copy()
    if name == "none_valid":
        IM_[:] = False
    elif name == "gap_clamped":
        I_[6:11, 0] += 0.25                      # one interval of 0.26 s, clamped to 0.1
    return I_, IM_, nav


@pytest.mark.parametrize("layout", ["11_of_16", "11_of_64", "none_valid", "gap_clamped"])
def test_propagate_plain_masked_layouts_match_reference(layout):
    I_, IM_, nav = _layout(layout)
    A = np.random.default_rng(0).normal(scale=1e-2, size=(24, 24))
    P0 = (A @ A.T + np.eye(24) * 1e-4).astype(np.float32)
    js, jP, jtr = jimu.propagate(nav, jnp.asarray(P0), jnp.asarray(I_), jnp.asarray(IM_),
                                 jimu.ImuNoise())
    ts, tP, ttr = timu.propagate_plain(_tnav(nav), torch.as_tensor(P0), torch.as_tensor(I_),
                                       torch.as_tensor(IM_), timu.ImuNoise())
    for a, b in zip(js, ts):
        _close(a, b)
    assert float(np.abs(tP.numpy() - np.asarray(jP)).max()) <= 1e-5 * float(np.abs(jP).max())
    for k in ("t", "quat", "pos", "vel"):
        _close(jtr[k], ttr[k])
    if layout == "none_valid":
        np.testing.assert_array_equal(tP.numpy(), P0)
        np.testing.assert_array_equal(ttr["pos"].numpy(), np.tile(np.asarray(nav.pos), (16, 1)))
    else:
        assert float(np.abs(tP.numpy() - P0).max()) > 0.0


@pytest.mark.parametrize("bad,match", [
    ("P_float64", "P must be float32"),
    ("imu_6_columns", r"imu has shape \(16, 6\)"),
    ("65_slots", "imu has 65 slots"),
    ("mask_length", r"imu_mask has shape \(15,\)"),
])
def test_propagate_rejects_what_the_kernel_does_not_take(bad, match):
    nav = _tnav(jinit())
    P = torch.eye(24) * 1e-4
    imu = torch.zeros(16, 7)
    mask = torch.ones(16, dtype=torch.bool)
    if bad == "P_float64":
        P = P.double()
    elif bad == "imu_6_columns":
        imu = imu[:, :6]
    elif bad == "65_slots":
        imu, mask = torch.zeros(65, 7), torch.ones(65, dtype=torch.bool)
    else:
        mask = mask[:15]
    with pytest.raises((TypeError, ValueError), match=match):
        timu.propagate(nav, P, imu, mask, timu.ImuNoise())


def test_step_F_matches_reference():
    rng = np.random.default_rng(0)
    R = np.array(jso3.exp_so3(jnp.asarray(rng.normal(size=3).astype(np.float32))))
    w, a = rng.normal(size=(2, 3)).astype(np.float32)
    dt = np.float32(0.01)
    _close(jimu._step_F(jnp.asarray(R), jnp.asarray(w), jnp.asarray(a), dt),
           timu._step_F(torch.as_tensor(R), torch.as_tensor(w), torch.as_tensor(a),
                        torch.as_tensor(dt)))


def test_undistort_matches_reference():
    (P_, S_, M_, I_, IM_, _), nav = _scan()
    P0 = jnp.eye(24) * 1e-4
    js, _, jtr = jimu.propagate(nav, P0, jnp.asarray(I_), jnp.asarray(IM_), jimu.ImuNoise())
    ju = jimu.undistort(jnp.asarray(P_), jnp.asarray(S_), jnp.asarray(M_), js, jtr)
    ttr = {k: torch.as_tensor(np.array(v)) for k, v in jtr.items()}
    tu = timu.undistort(torch.as_tensor(P_), torch.as_tensor(S_), torch.as_tensor(M_),
                        _tnav(js), ttr)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=5e-5, rtol=0)
    assert float(np.abs(np.asarray(ju)).max()) > 10.0


def test_rot_between_and_static_init_match_reference():
    rng = np.random.default_rng(1)
    for a, b in [rng.normal(size=(2, 3)),
                 (np.array([0, 0, 1.0]), np.array([0, 0, 1.0])),
                 (np.array([0, 0, 1.0]), np.array([0, 0, -1.0]))]:
        a, b = a.astype(np.float32), b.astype(np.float32)
        _close(jimu.rot_between(jnp.asarray(a), jnp.asarray(b)),
               timu.rot_between(torch.as_tensor(a), torch.as_tensor(b)))
    samples = np.concatenate([np.zeros((50, 1)), rng.normal(size=(50, 3)) * 1e-3,
                              np.array([0.05, -0.03, 0.99]) + rng.normal(size=(50, 3)) * 1e-3],
                             1).astype(np.float32)
    js, jscale = jimu.static_init(samples)
    ts, tscale = timu.static_init(samples, device="cpu")
    for a, b in zip(js, ts):
        _close(a, b)
    np.testing.assert_allclose(tscale, jscale, rtol=1e-6)
