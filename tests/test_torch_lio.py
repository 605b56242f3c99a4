"""Port parity for the slice as a whole: the LIO scan step.

``lsd_tpu_torch.slam.lio.lio_step`` on the CPU against the JAX
``lsd_tpu.slam.lio.lio_step`` with ``use_pallas_p2p`` on (Pallas kernel in
interpret mode) and off (XLA reduction), on the same simulated scans.
Tolerance: final position and quaternion within atol 1e-3, the bar the
reference holds its own Pallas kernel to (``tests/test_pallas_p2p.py``).

The scans carry 16 IMU samples, as ``bench.py``'s do: a 10 Hz sweep spans
11 samples at 100 Hz, and a capacity of 8 drops the last three, leaving a
6-scan run so weakly constrained (a few dozen valid points per scan) that
one residual on the gate's edge moves the pose by centimetres in either
package.

Also here: state carried across packages by ``convert.py``, the batch
entry point, and the guards that keep the port free of JAX.
"""
import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.geometry import so3 as jso3
from lsd_tpu.sim import CircleSim, SimConfig
from lsd_tpu.slam import lio as jlio
from lsd_tpu.slam.state import init_state as jinit
from lsd_tpu_torch import convert
from lsd_tpu_torch.slam import lio as tlio

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-3


@pytest.fixture(scope="module")
def run():
    sim = CircleSim(SimConfig(n_scans=6, points_per_scan=2048, point_noise=0.01, seed=5))
    data = sim.generate(capacity=2048, imu_capacity=16)
    R0, p0 = sim.pose(0.0)
    nav0 = jinit()._replace(pos=jnp.asarray(p0, jnp.float32),
                            quat=jso3.matrix_to_quat(jnp.asarray(R0, jnp.float32)),
                            vel=jnp.asarray(sim.velocity(0.0), jnp.float32))
    return data, nav0


def _jcfg(flag):
    return jlio.LioConfig(ds_capacity=1024, map_capacity=2 ** 13, use_pallas_p2p=flag)


TCFG = tlio.LioConfig(ds_capacity=1024, map_capacity=2 ** 13)


def _jax_steps(cfg, st, scans):
    for tup in scans:
        st, _ = jlio.lio_step(cfg, st, *[jnp.asarray(a) for a in tup[:5]])
    return st


def _torch_steps(st, scans):
    for tup in scans:
        st, info = tlio.lio_step(TCFG, st, *[torch.as_tensor(a) for a in tup[:5]])
    return st, info


def _assert_nav_close(jst, tst):
    np.testing.assert_allclose(tst.nav.pos.numpy(), np.asarray(jst.nav.pos), atol=ATOL)
    np.testing.assert_allclose(tst.nav.quat.numpy(), np.asarray(jst.nav.quat), atol=ATOL)


@pytest.mark.parametrize("use_pallas_p2p", [True, False])
def test_lio_step_matches_reference(run, use_pallas_p2p):
    data, nav0 = run
    cfg = _jcfg(use_pallas_p2p)
    jst = _jax_steps(cfg, jlio.lio_init(cfg, nav0), data)
    tst0 = convert.lio_state_from_numpy(jax.device_get(jlio.lio_init(cfg, nav0)), "cpu")
    tst, info = _torch_steps(tst0, data)
    _assert_nav_close(jst, tst)
    assert int(info["num_valid"]) > 0
    assert int(tst.step_count) == len(data) and bool(tst.initialized)
    assert tuple(info["pose"].shape) == (4, 4)


def test_state_carried_across_by_convert(run):
    data, nav0 = run
    cfg = _jcfg(True)
    jst = _jax_steps(cfg, jlio.lio_init(cfg, nav0), data[:3])
    tst = convert.lio_state_from_numpy(jax.device_get(jst), "cpu")
    np.testing.assert_array_equal(tst.map.keys.numpy(), np.asarray(jst.map.keys))
    # the port's dict form rebuilds the JAX state exactly
    back = convert.lio_state_to_numpy(tst)
    jback = jlio.LioState(
        nav=jst.nav._replace(**{k: jnp.asarray(v) for k, v in back["nav"].items()}),
        P=jnp.asarray(back["P"]),
        map=jst.map._replace(keys=jnp.asarray(back["map"]["keys"]),
                             coords=tuple(map(jnp.asarray, back["map"]["coords"])),
                             moments=tuple(map(jnp.asarray, back["map"]["moments"])),
                             voxel_size=jnp.asarray(back["map"]["voxel_size"])),
        map_center=jnp.asarray(back["map_center"]),
        initialized=jnp.asarray(back["initialized"]),
        step_count=jnp.asarray(back["step_count"]))
    for a, b in zip(jax.tree.leaves(jst), jax.tree.leaves(jback)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # both packages continue the same run for three more scans
    jfin = _jax_steps(cfg, jback, data[3:])
    tfin, _ = _torch_steps(tst, data[3:])
    _assert_nav_close(jfin, tfin)


def test_lio_step_batch_matches_sequential(run):
    data, nav0 = run
    st0 = convert.lio_state_from_numpy(jax.device_get(jlio.lio_init(_jcfg(True), nav0)), "cpu")
    seq, _ = _torch_steps(st0, data)
    stacked = [torch.as_tensor(np.stack([d[i] for d in data])) for i in range(5)]
    bst, poses = tlio.lio_step_batch(TCFG, st0, *stacked)
    assert tuple(poses.shape) == (len(data), 4, 4)
    for a, b in zip(seq.nav, bst.nav):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    torch.testing.assert_close(poses[-1, :3, 3], seq.nav.pos, rtol=0, atol=1e-6)


def test_points_map_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="queue A"):
        tlio.lio_init(tlio.LioConfig(map_type="points"), device="cpu")


def test_config_fields_carry_over():
    assert tlio.LioConfig._fields == jlio.LioConfig._fields
    for f in jlio.LioConfig._fields:
        if f != "imu_noise":
            assert getattr(tlio.LioConfig(), f) == getattr(jlio.LioConfig(), f), f
    assert tuple(tlio.LioConfig().imu_noise) == tuple(jlio.LioConfig().imu_noise)


def test_import_leaves_jax_out():
    code = ("import sys; import lsd_tpu_torch, lsd_tpu_torch.slam.lio, "
            "lsd_tpu_torch.convert, lsd_tpu_torch.sim, lsd_tpu_torch.utils.metrics; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'lsd_tpu.')) "
            "or m == 'lsd_tpu']; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_import_in_port_sources():
    files = sorted((REPO / "lsd_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "lsd_tpu", "flax", "optax"), f"{f}: {mod}"


def test_entry_points_raise_without_cuda(monkeypatch):
    from lsd_tpu_torch.ops.surfel import surfel_create
    from lsd_tpu_torch.slam.state import init_state
    from lsd_tpu_torch.utils.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tlio.lio_init(TCFG), lambda: init_state(),
                 lambda: surfel_create(2 ** 10), resolve_device,
                 lambda: resolve_device("cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
