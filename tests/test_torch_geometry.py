"""Port parity: geometry/so3, geometry/se3 and slam/state of lsd_tpu_torch
against lsd_tpu on the CPU.

Inputs are made with numpy from a seed and handed to both packages, with
rotation angles at 0, on both sides of the small-angle branches (1e-5,
1e-4) and within 1e-3 of pi.  Tolerance: rtol 1e-5 (float32 rounding of two
implementations of the same formulas), with atol 1e-6 for entries that are
zero in exact arithmetic.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.geometry import se3 as jse3
from lsd_tpu.geometry import so3 as jso3
from lsd_tpu.slam import state as jstate
from lsd_tpu_torch.geometry import se3 as tse3
from lsd_tpu_torch.geometry import so3 as tso3
from lsd_tpu_torch.slam import state as tstate

RTOL, ATOL = 1e-5, 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _rotvecs(n=64, seed=0):
    rng = _rng(seed)
    w = rng.normal(size=(n, 3)) * rng.choice([1e-7, 1e-3, 0.5, 2.5], size=(n, 1))
    w[0] = 0.0
    return w.astype(np.float32)


def _rotvecs_edges(n=64, seed=9):
    """Rotation vectors whose angles sit at 0, on both sides of the
    small-angle branches and near pi, then random ones."""
    rng = _rng(seed)
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    edges = [0.0, 1e-7, 0.9e-5, 1.1e-5, 0.9e-4, 1.1e-4, 1e-2,
             np.pi - 1e-2, np.pi - 1e-3, np.pi - 1e-4]
    angles = np.concatenate([edges, rng.uniform(0.0, np.pi, n - len(edges))])
    return (axes * angles[:, None]).astype(np.float32)


def _rpys(n=64, seed=10):
    rpy = _rng(seed).uniform(-np.pi, np.pi, size=(n, 3))
    rpy[:, 1] /= 2.0                      # pitch in (-pi/2, pi/2)
    rpy[0] = 0.0
    rpy[1] = [1e-6, -1e-6, np.pi - 1e-3]  # yaw near pi
    rpy[2] = [np.pi - 1e-3, 0.3, -0.2]    # roll near pi
    return rpy.astype(np.float32)


def _poses(n=64, seed=11):
    R = np.array(jso3.exp_so3(jnp.asarray(_rotvecs_edges(n, seed))))
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = _rng(seed).normal(size=(n, 3)) * 5
    return T


def _quats(n=64, seed=1):
    q = _rng(seed).normal(size=(n, 4)).astype(np.float32)
    q[0] = [-1.0, 0.0, 0.0, 0.0]          # w < 0 is canonicalized
    q[1] = [0.0, 1.0, 0.0, 0.0]           # rotation by pi
    return q


def _rotations(n=64, seed=2):
    R = np.array(jso3.exp_so3(jnp.asarray(_rotvecs(n, seed))))
    R[1] = np.diag([1.0, -1.0, -1.0])     # trace -1: a non-w pivot
    return R.astype(np.float32)


def _close(j, t):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def _both(fn_name, *arrays, mod=(jso3, tso3)):
    j = getattr(mod[0], fn_name)(*[jnp.asarray(a) for a in arrays])
    t = getattr(mod[1], fn_name)(*[torch.as_tensor(a) for a in arrays])
    return j, t


CASES = {
    "hat": lambda: (_rotvecs(),),
    "vee": lambda: (np.array(jso3.hat(jnp.asarray(_rotvecs()))),),
    "exp_so3": lambda: (_rotvecs(),),
    "log_so3": lambda: (_rotations(),),
    "quat_mul": lambda: (_quats(seed=1), _quats(seed=3)),
    "quat_conj": lambda: (_quats(),),
    "quat_normalize": lambda: (_quats(),),
    "quat_from_rotvec": lambda: (_rotvecs(),),
    "rotvec_from_quat": lambda: (_quats(),),
    "quat_to_matrix": lambda: (_quats(),),
    "matrix_to_quat": lambda: (_rotations(),),
    "quat_rotate": lambda: (_quats() / np.linalg.norm(_quats(), axis=1, keepdims=True),
                            _rng(4).normal(size=(64, 3)).astype(np.float32) * 20),
    "left_jacobian": lambda: (_rotvecs_edges(),),
    "inv_left_jacobian": lambda: (_rotvecs_edges(),),
    "rpy_to_matrix": lambda: (_rpys(),),
    "matrix_to_rpy": lambda: (np.array(jso3.rpy_to_matrix(jnp.asarray(_rpys()))),),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_so3_matches_reference(name):
    j, t = _both(name, *CASES[name]())
    _close(j, t)


@pytest.mark.parametrize("name", ["exp_so3", "left_jacobian", "inv_left_jacobian"])
def test_so3_gradients_finite_at_small_and_large_angles(name):
    """``torch.where`` differentiates both branches: the unused one must not
    put a NaN into the gradient, at 0 above all."""
    w = torch.as_tensor(_rotvecs_edges()).requires_grad_(True)
    getattr(tso3, name)(w).sum().backward()
    assert bool(torch.isfinite(w.grad).all())


def test_jacobians_invert_each_other():
    w = torch.as_tensor(_rotvecs_edges())
    eye = torch.eye(3).expand(len(w), 3, 3)
    np.testing.assert_allclose((tso3.left_jacobian(w) @ tso3.inv_left_jacobian(w)).numpy(),
                               eye.numpy(), atol=2e-3)


SE3_CASES = {
    "rotation": lambda: (_poses(),),
    "translation": lambda: (_poses(),),
    "compose": lambda: (_poses(seed=11), _poses(seed=12)),
    "inverse": lambda: (_poses(),),
    "exp_se3": lambda: (np.concatenate(
        [_rng(13).normal(size=(64, 3)).astype(np.float32), _rotvecs_edges()], axis=1),),
    "log_se3": lambda: (_poses(),),
    "transform_points": lambda: (_poses()[3], _rng(14).normal(size=(100, 3)).astype(np.float32) * 20),
    "relative_pose": lambda: (_poses(seed=11), _poses(seed=12)),
}


@pytest.mark.parametrize("name", sorted(SE3_CASES))
def test_se3_matches_reference(name):
    j, t = _both(name, *SE3_CASES[name](), mod=(jse3, tse3))
    _close(j, t)


@pytest.mark.parametrize("a", [0.0, 0.3, 1.0])
def test_pose_interp_matches_reference(a):
    T0, T1 = _poses(seed=15), _poses(seed=16)
    j = jse3.pose_interp(jnp.asarray(T0), jnp.asarray(T1), a)
    t = tse3.pose_interp(torch.as_tensor(T0), torch.as_tensor(T1), a)
    _close(j, t)


def test_quat_normalize_canonical_sign():
    t = tso3.quat_normalize(torch.as_tensor(_quats()))
    assert bool((t[:, 0] >= 0).all())


@pytest.mark.parametrize("t_shape", ["per_row", "scalar"])
def test_quat_slerp_matches_reference(t_shape):
    q0 = _quats(seed=5)
    q1 = q0 + 0.05 * _rng(6).normal(size=q0.shape).astype(np.float32)
    q1[2] = q0[2]                                 # identical: the linear fallback
    q1[3] = -q0[3]                                # antipodal: the short way round
    if t_shape == "per_row":
        a = _rng(7).random((64, 1)).astype(np.float32)
    else:
        a = np.float32(0.3)
    j = jso3.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(a))
    t = tso3.quat_slerp(torch.as_tensor(q0), torch.as_tensor(q1), torch.as_tensor(a))
    _close(j, t)


def test_make_pose_matches_reference():
    R, p = _rotations(), _rng(8).normal(size=(64, 3)).astype(np.float32)
    _close(jse3.make_pose(jnp.asarray(R), jnp.asarray(p)),
           tse3.make_pose(torch.as_tensor(R), torch.as_tensor(p)))
    # broadcast one rotation over many translations
    _close(jse3.make_pose(jnp.asarray(R[3]), jnp.asarray(p)),
           tse3.make_pose(torch.as_tensor(R[3]), torch.as_tensor(p)))


def _nav_pair(seed):
    rng = _rng(seed)
    vals = dict(
        pos=rng.normal(size=3) * 10, quat=rng.normal(size=4), vel=rng.normal(size=3),
        bg=rng.normal(size=3) * 1e-3, ba=rng.normal(size=3) * 1e-2,
        grav=np.array([0.0, 0.0, -9.81]) + rng.normal(size=3) * 1e-2,
        ext_q=rng.normal(size=4), ext_t=rng.normal(size=3) * 0.1)
    vals["quat"] /= np.linalg.norm(vals["quat"])
    vals["ext_q"] /= np.linalg.norm(vals["ext_q"])
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    j = jstate.NavState(**{k: jnp.asarray(v) for k, v in vals.items()})
    t = tstate.NavState(**{k: torch.as_tensor(v) for k, v in vals.items()})
    return j, t


def test_state_layout_and_init():
    assert tstate.ERR_DIM == jstate.ERR_DIM == 24
    for name in ("IDX_P", "IDX_R", "IDX_V", "IDX_BG", "IDX_BA", "IDX_G",
                 "IDX_ER", "IDX_ET"):
        assert getattr(tstate, name) == getattr(jstate, name)
    j, t = jstate.init_state(), tstate.init_state(device="cpu")
    for a, b in zip(j, t):
        _close(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_boxplus_boxminus_match_reference(seed):
    j, t = _nav_pair(seed)
    dx = (_rng(seed + 10).normal(size=24) * 0.05).astype(np.float32)
    jp = jstate.boxplus(j, jnp.asarray(dx))
    tp = tstate.boxplus(t, torch.as_tensor(dx))
    for a, b in zip(jp, tp):
        _close(a, b)
    _close(jstate.boxminus(jp, j), tstate.boxminus(tp, t))
    # the round trip recovers dx
    np.testing.assert_allclose(tstate.boxminus(tp, t).numpy(), dx, rtol=1e-3, atol=1e-5)


def test_pose_matrix_matches_reference():
    j, t = _nav_pair(3)
    _close(j.pose_matrix(), t.pose_matrix())
    _close(j.rot, t.rot)
    _close(j.ext_rot, t.ext_rot)
