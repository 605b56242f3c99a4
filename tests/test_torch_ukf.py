"""Port parity: the localizer's unscented Kalman filter.

``lsd_tpu_torch.slam.ukf`` on the CPU against ``lsd_tpu.slam.ukf`` on the
same seeded inputs.  Tolerances (float32; Cholesky and solve come from
another LAPACK than XLA's):
- one call of any ``ukf_*`` function: state and covariance atol 2e-5
  (measured: at most 1.4e-5 on a position of ~5 m) plus rtol 1e-6 (the
  dt-floor case carries velocities of hundreds of m/s);
- a chain of 25 rounds of every predict and correct: atol 2e-4 (measured
  2.3e-5);
- the so3 functions at a batch of 47 sigma points against the reference
  mapped over the rows: atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.geometry import so3 as jso3
from lsd_tpu.slam import ukf as J
from lsd_tpu_torch import convert
from lsd_tpu_torch.geometry import so3 as tso3
from lsd_tpu_torch.slam import ukf as T

ONE, CHAIN = 2e-5, 2e-4


def f(a):
    return torch.tensor(np.asarray(a, np.float32))


def j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _pose(yaw, p=(5.0, -2.0, 1.0)):
    Tm = np.eye(4, dtype=np.float32)
    Tm[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    Tm[:3, 3] = p
    return Tm


def _state(seed, yaw=0.6):
    """A filter state off its initial one: two predicts and a correct in
    the reference, handed to both packages through ``convert``."""
    rng = np.random.default_rng(seed)
    st = J.ukf_init(j(_pose(yaw)))
    st = st._replace(x=st.x.at[3:6].set(j(rng.normal(0, 1, 3)))
                     .at[16:19].set(j(rng.normal(0, 0.2, 3))))
    st = J.ukf_predict(st, j(0.1))
    st = J.ukf_correct(st, st.x[0:3] + j(rng.normal(0, 0.05, 3)), st.x[6:10])
    st = J.ukf_predict(st, j(0.1))
    tree = jax.device_get(st)
    return st, convert.ukf_state_from_numpy(tree, device="cpu")


def _close(tst, jst, atol):
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), rtol=1e-6, atol=atol)
    np.testing.assert_allclose(tst.P.numpy(), np.asarray(jst.P), rtol=1e-6, atol=atol)


def test_config_and_layout_carry_over():
    assert T.UkfConfig._fields == J.UkfConfig._fields
    assert tuple(T.UkfConfig()) == tuple(J.UkfConfig())
    assert (T.DIM, T.OBS_DIM, T.GRAVITY) == (J.DIM, J.OBS_DIM, J.GRAVITY)
    assert T.UkfState._fields == J.UkfState._fields


@pytest.mark.parametrize("with_pose", [False, True])
def test_init_matches(with_pose):
    Tm = _pose(2.2)
    jst = J.ukf_init(j(Tm)) if with_pose else J.ukf_init()
    tst = T.ukf_init(f(Tm)) if with_pose else T.ukf_init(device="cpu")
    _close(tst, jst, 1e-7)
    assert tst.x.dtype == torch.float32 and tst.P.shape == (23, 23)


def test_sigma_points_and_weights_match():
    jst, tst = _state(0)
    jp, jwm, jwc = J._sigma_points(jst.x, jst.P, J.UkfConfig())
    tp, c = T._sigma_points(tst.x, tst.P, T.UkfConfig())
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=ONE)
    np.testing.assert_array_equal(c.wm.numpy(), np.asarray(jwm))
    np.testing.assert_array_equal(c.wc.numpy(), np.asarray(jwc))
    # alpha = 1: lam = 0, so the centre point has no weight in the mean and
    # 1 - alpha^2 + beta in the covariance
    assert float(c.wm[0]) == 0.0 and float(c.wc[0]) == 2.0 and tp.shape == (47, 23)


def test_sigma_points_of_a_covariance_that_is_not_positive_definite_are_nan():
    """The reference's Cholesky returns NaN there; the port's must neither
    raise nor return the partial factor."""
    jst, tst = _state(1)
    bad = np.asarray(jst.P).copy()
    bad[2, 2] = -1.0
    jp, _, _ = J._sigma_points(jst.x, j(bad), J.UkfConfig())
    tp, _ = T._sigma_points(tst.x, f(bad), T.UkfConfig())
    np.testing.assert_array_equal(torch.isnan(tp).numpy(), np.isnan(np.asarray(jp)))
    assert torch.isnan(tp[1:]).any(dim=1).all() and not torch.isnan(tp[0]).any()
    out = T.ukf_predict(T.UkfState(tst.x, f(bad)), f(0.1))
    assert not torch.isfinite(out.x).all()


def test_so3_at_batch_47_matches_the_mapped_reference():
    rng = np.random.default_rng(3)
    w = rng.normal(0, 1.0, (47, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = 1e-7
    q = np.asarray(jax.vmap(jso3.quat_from_rotvec)(j(w)))
    np.testing.assert_allclose(tso3.quat_from_rotvec(f(w)).numpy(), q, rtol=0, atol=1e-6)
    back = np.asarray(jax.vmap(jso3.rotvec_from_quat)(j(q)))
    np.testing.assert_allclose(tso3.rotvec_from_quat(f(q)).numpy(), back, rtol=0, atol=1e-6)


def test_hemi_align_is_the_reference_s():
    rng = np.random.default_rng(4)
    Q = rng.normal(size=(47, 4)).astype(np.float32)
    Q[:, 0] *= 1e-3                       # w straddles zero: the yaw-180 case
    out = T._hemi_align(f(Q)).numpy()
    np.testing.assert_array_equal(out, np.asarray(J._hemi_align(j(Q))))
    assert (out @ out[0] >= 0).all() and (np.abs(out) == np.abs(Q)).all()
    assert (out != Q).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_predict_const_velocity_matches(seed):
    jst, tst = _state(seed)
    _close(T.ukf_predict(tst, f(0.1)), J.ukf_predict(jst, j(0.1)), ONE)


@pytest.mark.parametrize("seed", [0, 1])
def test_predict_imu_matches(seed):
    jst, tst = _state(seed)
    rng = np.random.default_rng(10 + seed)
    g, a = rng.normal(0, 0.3, 3), rng.normal(0, 1, 3) + [0, 0, 9.81]
    _close(T.ukf_predict(tst, f(0.1), T.UkfConfig(), f(g), f(a)),
           J.ukf_predict(jst, j(0.1), J.UkfConfig(), j(g), j(a)), ONE)


@pytest.mark.parametrize("dt", [0.1, 1e-4])
def test_predict_odom_matches(dt):
    """dt below the 1e-3 floor exercises the clamp on the velocity rates."""
    jst, tst = _state(2)
    dq = np.asarray(jso3.quat_from_rotvec(j([0.01, -0.02, 0.08])))
    dtr = [0.5, 0.05, -0.01]
    _close(T.ukf_predict_odom(tst, f(dq), f(dtr), f(dt)),
           J.ukf_predict_odom(jst, j(dq), j(dtr), j(dt)), ONE)


@pytest.mark.parametrize("flip", [False, True])
def test_correct_matches(flip):
    """``flip``: the observed quaternion arrives on the other cover."""
    jst, tst = _state(3)
    q = np.asarray(jso3.quat_from_rotvec(j([0.0, 0.02, 0.65])))
    q = -q if flip else q
    p = np.asarray(jst.x[0:3]) + [0.1, -0.05, 0.02]
    _close(T.ukf_correct(tst, f(p), f(q)), J.ukf_correct(jst, j(p), j(q)), ONE)


def test_correct_with_another_config_matches():
    jst, tst = _state(4)
    kw = dict(r_pos=0.05, r_quat=0.01, q_vel=0.1)
    p, q = np.asarray(jst.x[0:3]) + 0.05, np.asarray(jst.x[6:10])
    _close(T.ukf_correct(T.ukf_predict(tst, f(0.1), T.UkfConfig(**kw)), f(p), f(q),
                         T.UkfConfig(**kw)),
           J.ukf_correct(J.ukf_predict(jst, j(0.1), J.UkfConfig(**kw)), j(p), j(q),
                         J.UkfConfig(**kw)), ONE)


@pytest.mark.parametrize("r_pos", [0.01, 4.0])
def test_correct_position_matches(r_pos):
    jst, tst = _state(5)
    p = np.asarray(jst.x[0:3]) + [0.5, -0.3, 2.0]
    tout = T.ukf_correct_position(tst, f(p), f(r_pos))
    _close(tout, J.ukf_correct_position(jst, j(p), j(r_pos)), ONE)
    # z is near-unconstrained: the 2 m of altitude offset barely moves it
    assert abs(float(tout.x[2] - tst.x[2])) < 0.01


def test_pose_matches():
    jst, tst = _state(6, yaw=-2.5)
    np.testing.assert_allclose(T.ukf_pose(tst).numpy(), np.asarray(J.ukf_pose(jst)),
                               rtol=0, atol=1e-6)


def test_chain_at_yaw_180_matches_and_keeps_the_attitude_covariance_small():
    """The double-cover case: 25 rounds of odometry predict, pose correct
    and position correct at yaw = pi - 1e-3, then 20 constant-velocity
    predicts turning through the boundary."""
    yaw = np.pi - 1e-3
    Tm = _pose(yaw, (0.0, 0.0, 0.0))
    jst, tst = J.ukf_init(j(Tm)), T.ukf_init(f(Tm))
    dq = np.asarray(jso3.quat_from_rotvec(j([0.0, 0.0, 0.0005])))
    dtr = [0.5, 0.0, 0.0]
    q_obs = np.asarray(jso3.matrix_to_quat(j(Tm[:3, :3])))
    for k in range(25):
        jst = J.ukf_predict_odom(jst, j(dq), j(dtr), j(0.1))
        tst = T.ukf_predict_odom(tst, f(dq), f(dtr), f(0.1))
        obs = np.asarray(jst.x[0:3])
        jst, tst = J.ukf_correct(jst, j(obs), j(q_obs)), T.ukf_correct(tst, f(obs), f(q_obs))
        jst = J.ukf_correct_position(jst, j(obs), j(0.01))
        tst = T.ukf_correct_position(tst, f(obs), f(0.01))
        assert float(tst.P[6:10, 6:10].abs().max()) < 5e-2, k
        Tk = T.ukf_pose(tst).numpy()
        err = np.degrees(np.arctan2(Tk[1, 0], Tk[0, 0]) - yaw)
        assert abs((err + 180.0) % 360.0 - 180.0) < 3.0, k
    _close(tst, jst, CHAIN)
    jst, tst = J.ukf_init(j(Tm)), T.ukf_init(f(Tm))
    jst = jst._replace(x=jst.x.at[16:19].set(j([0.0, 0.0, 0.3])))
    x = tst.x.clone()
    x[16:19] = f([0.0, 0.0, 0.3])
    tst = tst._replace(x=x)
    for k in range(20):
        jst, tst = J.ukf_predict(jst, j(0.1)), T.ukf_predict(tst, f(0.1))
        assert float(tst.P[6:10, 6:10].abs().max()) < 5e-2, k
    _close(tst, jst, CHAIN)


def test_chain_of_every_step_matches():
    jst, tst = _state(7)
    rng = np.random.default_rng(7)
    dq = np.asarray(jso3.quat_from_rotvec(j([0.0, 0.0, 0.03])))
    g, a = [0.01, -0.02, 0.5], [0.1, 0.2, 9.8]
    for _ in range(25):
        jst = J.ukf_predict_odom(jst, j(dq), j([0.5, 0, 0]), j(0.1))
        tst = T.ukf_predict_odom(tst, f(dq), f([0.5, 0, 0]), f(0.1))
        jst, tst = J.ukf_predict(jst, j(0.1)), T.ukf_predict(tst, f(0.1))
        jst = J.ukf_predict(jst, j(0.1), J.UkfConfig(), j(g), j(a))
        tst = T.ukf_predict(tst, f(0.1), T.UkfConfig(), f(g), f(a))
        p = np.asarray(jst.x[0:3]) + rng.normal(0, 0.05, 3)
        q = np.asarray(jst.x[6:10])
        jst, tst = J.ukf_correct(jst, j(p), j(q)), T.ukf_correct(tst, f(p), f(q))
        jst = J.ukf_correct_position(jst, j(p), j(0.25))
        tst = T.ukf_correct_position(tst, f(p), f(0.25))
    _close(tst, jst, CHAIN)
    assert torch.isfinite(tst.P).all()


def test_imu_mount_quaternion_rotates_the_rates():
    """Gyro z through an identity mount yields yaw; through a mount turned
    90 deg about x it does not (the reference's own test), and both
    packages agree on both."""
    g, a = [0.0, 0.0, 0.5], [0.0, 0.0, 9.81]
    q_mount = np.asarray(jso3.quat_from_rotvec(j([np.pi / 2, 0.0, 0.0])))
    jst, tst = J.ukf_init(), T.ukf_init(device="cpu")
    for _ in range(10):
        jst = J.ukf_predict(jst, j(0.1), J.UkfConfig(), j(g), j(a))
        tst = T.ukf_predict(tst, f(0.1), T.UkfConfig(), f(g), f(a))
    _close(tst, jst, CHAIN)
    Tk = T.ukf_pose(tst).numpy()
    assert abs(np.arctan2(Tk[1, 0], Tk[0, 0]) - 0.5) < 0.1
    jst = J.ukf_init()
    jst = jst._replace(x=jst.x.at[19:23].set(j(q_mount)))
    tst = convert.ukf_state_from_numpy(jax.device_get(jst), device="cpu")
    jst = J.ukf_predict(jst, j(0.1), J.UkfConfig(), j(g), j(a))
    tst = T.ukf_predict(tst, f(0.1), T.UkfConfig(), f(g), f(a))
    _close(tst, jst, ONE)
    Tk = T.ukf_pose(tst).numpy()
    assert abs(np.arctan2(Tk[1, 0], Tk[0, 0])) < 0.02


def test_state_round_trips_through_convert():
    jst, tst = _state(8)
    d = convert.ukf_state_to_numpy(tst)
    back = J.UkfState(**{k: jnp.asarray(v) for k, v in d.items()})
    np.testing.assert_array_equal(np.asarray(back.x), np.asarray(jst.x))
    np.testing.assert_array_equal(np.asarray(back.P), np.asarray(jst.P))
    again = convert.ukf_state_from_numpy(d, device="cpu")
    assert torch.equal(again.x, tst.x) and torch.equal(again.P, tst.P)
