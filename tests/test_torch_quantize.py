"""Port parity: int8 checkpoints, the msgpack writer and the w8a8 product
(``lsd_tpu_torch/models/quantize.py``, ``models/params_io.py``) against
``lsd_tpu`` and flax.

- ``quantize_params`` and ``quantization_error``: int8 leaves, scales and
  errors bit-equal to the reference's (both numpy, rounding half to even).
- ``LSDQ8001`` files: written by either package, read by the other, the
  same trees; the port's file is the reference's byte for byte.
- ``save_params``: the bytes ``flax.serialization.to_bytes`` writes, also
  with arrays chunked (the chunk size lowered for the test); read back by
  flax and by the port's reader.
- ``quantized_matmul``: on the CPU an int32 matmul; its result equals the
  reference's (the same int32 accumulators, the same float32 rescale), and
  it is within 5 % of the float32 product at the reference test's shape.
- A quantized Mono3D checkpoint served by the port: its heat map within
  0.15 of the float32 one's largest magnitude, the reference test's bar.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from lsd_tpu.models import quantize as jq
from lsd_tpu.models.params_io import save_params as jsave
from lsd_tpu_torch import convert
from lsd_tpu_torch.models import mono3d as tm
from lsd_tpu_torch.models import params_io, quantize as tq


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def mono3d_tree():
    return params_io.load_params("weights/mono3d.msgpack")


def test_quantize_params_bit_equal(mono3d_tree):
    got, want = tq.quantize_params(mono3d_tree), jq.quantize_params(mono3d_tree)
    _assert_trees_equal(got, want)
    kinds = {np.asarray(v).dtype.kind for _, v in _leaves(got)}
    assert kinds == {"i", "f"}
    _assert_trees_equal(params_io.dequantize_params(got), jq.dequantize_params(want))
    errs = tq.quantization_error(mono3d_tree)
    assert errs == jq.quantization_error(mono3d_tree)
    assert len(errs) == 19 and max(errs.values()) < 0.01


def test_int8_files_cross_read(mono3d_tree, tmp_path):
    template = {"params": jax.tree.map(np.zeros_like, mono3d_tree["params"])}
    port_file = tq.save_quantized(str(tmp_path / "port" / "q.msgpack"), mono3d_tree)
    ref_file = jq.save_quantized(str(tmp_path / "ref.msgpack"), mono3d_tree)
    assert open(port_file, "rb").read() == open(ref_file, "rb").read()
    want = jq.dequantize_params(jq.quantize_params(mono3d_tree))
    for path in (port_file, ref_file):
        _assert_trees_equal(params_io.load_params(path), want)
        _assert_trees_equal(jax.device_get(jq.load_params_any(path, template)), want)


def test_save_params_is_flax_to_bytes(mono3d_tree, tmp_path):
    path = params_io.save_params(str(tmp_path / "a" / "w.msgpack"), mono3d_tree)
    blob = open(path, "rb").read()
    assert blob == serialization.to_bytes(mono3d_tree) == open("weights/mono3d.msgpack", "rb").read()
    _assert_trees_equal(serialization.msgpack_restore(blob), mono3d_tree)
    _assert_trees_equal(params_io.load_params(path), mono3d_tree)
    # a tree saved by the reference's save_params reads back the same
    ref_path = jsave(str(tmp_path / "r.msgpack"), mono3d_tree)
    assert open(ref_path, "rb").read() == blob


def test_writer_chunks_large_arrays_as_flax(monkeypatch, tmp_path):
    tree = {"b": {"x": np.arange(40, dtype=np.float32).reshape(5, 8), "s": np.float32(2.5)},
            "a": np.arange(6, dtype=np.int16), "n": [1, -3, 2 ** 40, None, True, "x", 1.5]}
    monkeypatch.setattr(params_io, "MAX_CHUNK_BYTES", 24)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 24)
    blob = params_io.msgpack_serialize(tree)
    assert blob == serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    back = serialization.msgpack_restore(blob)
    np.testing.assert_array_equal(back["b"]["x"], tree["b"]["x"])
    np.testing.assert_array_equal(params_io.msgpack_restore(blob)["b"]["x"], tree["b"]["x"])
    assert back["n"] == tree["n"] and params_io.msgpack_restore(blob)["n"] == tree["n"]


@pytest.mark.parametrize("shape", [(8, 64, 32), (3, 5, 24, 16), (40, 33, 17)])
def test_quantized_matmul_matches_jax(shape):
    *lead, k, n = shape
    rng = np.random.default_rng(1)
    x = rng.normal(size=(*lead, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    q = tq._quantize_leaf(w)
    ref = np.asarray(jq.quantized_matmul(jnp.asarray(x), jnp.asarray(q["q"]),
                                         jnp.asarray(q["scale"])))
    got = tq.quantized_matmul(torch.as_tensor(x), torch.as_tensor(q["q"]),
                              torch.as_tensor(q["scale"])).numpy()
    np.testing.assert_array_equal(got, ref)
    exact = x @ w
    assert float(np.abs(got - exact).max() / np.abs(exact).max()) < 0.05
    xs = torch.tensor(0.02)
    ref_c = np.asarray(jq.quantized_matmul(jnp.asarray(x), jnp.asarray(q["q"]),
                                           jnp.asarray(q["scale"]), jnp.float32(0.02)))
    np.testing.assert_array_equal(
        tq.quantized_matmul(torch.as_tensor(x), torch.as_tensor(q["q"]),
                            torch.as_tensor(q["scale"]), xs).numpy(), ref_c)


def test_quantized_mono3d_checkpoint_serves_close_to_float(mono3d_tree, tmp_path):
    path = tq.save_quantized(str(tmp_path / "m.int8.msgpack"), mono3d_tree)
    assert os.path.getsize(path) < 0.4 * os.path.getsize("weights/mono3d.msgpack")
    cfg = tm.Mono3DConfig(image_hw=(96, 160))
    img = torch.as_tensor(np.random.default_rng(0).random((1, 3, 96, 160)).astype(np.float32))
    heat = []
    for tree in (mono3d_tree, params_io.load_params(path)):
        model = tm.Mono3D(cfg)
        convert.load_camera_params(model, tree)
        with torch.no_grad():
            heat.append(model.eval()(img)["heat"])
    assert float((heat[1] - heat[0]).abs().max() / heat[0].abs().max()) < 0.15
