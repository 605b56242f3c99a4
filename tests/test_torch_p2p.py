"""Port parity: the fused point-to-plane reduction.

``lsd_tpu_torch.ops.p2p.p2p_reduce_plain`` (and ``p2p_reduce`` on CPU
tensors, which runs it) against the Pallas kernel
``lsd_tpu.ops.pallas_p2p.p2p_reduce`` in interpret mode, at the tolerances
of ``tests/test_pallas_p2p.py``: HtH within 2e-6 * max|HtH|, Htr within
2e-5 * max(|Htr|, 1), exact n_valid, sum |r| rtol 1e-5.  The CUDA kernel
itself is held to the plain version on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.geometry import so3 as jso3
from lsd_tpu.ops.pallas_p2p import p2p_reduce as pallas_p2p_reduce
from lsd_tpu_torch.ops import p2p


def _setup(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=10, size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    d = rng.normal(scale=0.1, size=n).astype(np.float32)
    w = ((rng.random(n) > 0.2) * 400.0).astype(np.float32)
    R = np.array(jso3.exp_so3(jnp.asarray([0.02, -0.03, 0.4])), np.float32)
    Re = np.array(jso3.exp_so3(jnp.asarray([0.0, 0.01, -0.02])), np.float32)
    te = np.array([0.1, 0.0, -0.05], np.float32)
    pos = np.array([1.0, -2.0, 0.3], np.float32)
    return pts, nrm, d, w, R, Re, te, pos


def _run_both(args, est_ext, max_resid=1.0):
    j = pallas_p2p_reduce(*[jnp.asarray(a) for a in args], max_resid,
                          est_extrinsic=est_ext, interpret=True)
    t = p2p.p2p_reduce(*[torch.as_tensor(a) for a in args], max_resid,
                       est_extrinsic=est_ext)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _assert_close(j, t):
    (jH, jr, js), (tH, tr, ts) = j, t
    assert np.max(np.abs(tH - jH)) <= 2e-6 * np.max(np.abs(jH))
    assert np.max(np.abs(tr - jr)) <= 2e-5 * max(np.max(np.abs(jr)), 1.0)
    assert int(ts[0]) == int(js[0])                       # n_valid exact
    np.testing.assert_allclose(ts[1], js[1], rtol=1e-5)   # sum |r|
    np.testing.assert_allclose(ts[2], js[2], rtol=1e-5)   # sum w


@pytest.mark.parametrize("n", [1500, 3 * 1024 - 37, 4096])
@pytest.mark.parametrize("est_ext", [True, False])
def test_plain_matches_pallas(n, est_ext):
    j, t = _run_both(_setup(n=n, seed=n), est_ext)
    _assert_close(j, t)
    assert 0 < int(t[2][0]) < n


def test_no_extrinsic_zeroes_block():
    j, t = _run_both(_setup(), False)
    tH, tr, _ = t
    assert np.max(np.abs(tH[18:, :])) == 0.0 and np.max(np.abs(tH[:, 18:])) == 0.0
    assert np.max(np.abs(tr[18:])) == 0.0
    _assert_close(j, t)


def test_all_masked():
    pts, nrm, d, w, R, Re, te, pos = _setup(n=300)
    j, t = _run_both((pts, nrm, d, np.zeros_like(w), R, Re, te, pos), False)
    assert np.max(np.abs(t[0])) == 0.0 and np.max(np.abs(t[1])) == 0.0
    assert int(t[2][0]) == 0
    _assert_close(j, t)


def test_stats_order_is_the_codes_not_the_docstring():
    # [n_valid, sum |r|, sum w] as pallas_p2p.py:177 returns (its docstring
    # at :127 lists another order)
    _, (_, _, ts) = _run_both(_setup(), True)
    w = _setup()[3]
    assert float(ts[0]) == int(ts[0]) and float(ts[0]) <= (w > 0).sum()
    assert ts[2] == pytest.approx(400.0 * ts[0])


def test_cpu_path_counts_no_launch():
    before = p2p.p2p_reduce.launches.read()
    p2p.p2p_reduce(*[torch.as_tensor(a) for a in _setup(n=200)], 1.0)
    assert p2p.p2p_reduce.launches.read() == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = [torch.as_tensor(a) for a in _setup(n=64)]
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "shape":
        args[2] = args[2][:-1]
    elif bad == "contiguity":
        args[1] = args[1].T.contiguous().T
    else:
        args[4] = args[4].to("meta")
    with pytest.raises((TypeError, ValueError)):
        p2p.p2p_reduce(*args, 1.0)
