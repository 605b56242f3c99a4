"""Port parity for the deployment export (``lsd_tpu_torch/tools/export.py``
against ``lsd_tpu/tools/export.py``), on the CPU at ``tests/test_export.py``'s
``SMALL`` configuration with 4,096 points.

- The artifact (``torch.export``) against the port's eager module (forward,
  decode, postprocess) on the same frame: within rtol/atol 1e-5 (measured:
  equal).
- The float32 twin's artifact against the JAX package's float32 network
  (``tests/test_torch_detection.py:_jax_net``) with its ``decode`` and
  ``postprocess``, the same weights carried across by
  ``convert.detector_params_from_flax``: the same kept boxes, labels equal,
  boxes and scores within that file's float32 bar, 1e-4 of the largest
  magnitude.  (The bf16 networks of a random initialisation part by up to
  0.18 rad in heading on this frame, and kept boxes come and go, where
  rounding moves near-zero heading vectors and near-equal scores; the
  shipped checkpoints' bf16 agreement is
  ``tests/test_torch_detector_weights.py``'s.)
- A file with a bad magic, and an artifact the JAX package wrote
  (``jax.export``), are refused with ``ValueError``.
"""
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.detection import post as jpost
from lsd_tpu.models import CenterPointDetector as JDetector
from lsd_tpu.models import DetectorConfig as JConfig
from lsd_tpu.tools import export as jexport
from lsd_tpu_torch import convert
from lsd_tpu_torch.detection.post import PostProcessConfig
from lsd_tpu_torch.models import CenterPointDetector, DetectorConfig
from lsd_tpu_torch.tools import export as texport
from tests.test_torch_detection import REL, _close, _jax_net

SMALL = JConfig(pc_range=(-48.0, -48.0, -3.0, 48.0, 48.0, 3.0),
                voxel_size=(1.2, 1.2, 6.0), max_voxels=2048,
                max_points_per_voxel=8, max_boxes=64)
CAP = 4096


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(flax params, the port's eager bf16 module, its artifact's path, the
    float32 twin's artifact's path, a frame)."""
    root = tmp_path_factory.mktemp("export")
    model = JDetector(SMALL)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1024, 4), jnp.float32),
                                 jnp.zeros(1024, bool))
    # the heatmap head's bias at 0 instead of the focal prior's -2.19: a
    # random network then keeps boxes above the score thresholds
    hm_out = params["params"]["CenterHead_0"]["hm_out"]
    hm_out["bias"] = jnp.zeros_like(hm_out["bias"])
    tmodel = CenterPointDetector(DetectorConfig(**SMALL._asdict()))
    tmodel.load_state_dict(convert.detector_params_from_flax(params))
    path = texport.export_detector(tmodel.state_dict(), DetectorConfig(**SMALL._asdict()),
                                   point_capacity=CAP, out_path=str(root / "det.pt2"),
                                   device="cpu")
    path32 = texport.export_detector(tmodel.state_dict(), DetectorConfig(**SMALL._asdict()),
                                     point_capacity=CAP, out_path=str(root / "det32.pt2"),
                                     device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    pts = (rng.random((CAP, 4)) * [60, 60, 4, 1] - [30, 30, 2, 0]).astype(np.float32)
    eager = texport.DetectorInference(tmodel, PostProcessConfig()).eval()
    yield params, eager, path, path32, pts


def test_artifact_matches_eager(exported):
    _params, eager, path, _path32, pts = exported
    det = texport.ExportedDetector(path)
    assert det.meta["point_capacity"] == CAP and det.meta["dtype"] == "bfloat16"
    assert det.meta["format"] == "torch.export" and det.meta["device"] == "cpu"
    mask = np.ones(CAP, bool)
    got = det(pts, mask)
    with torch.no_grad():
        want = eager(torch.as_tensor(pts), torch.as_tensor(mask))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=1e-5, atol=1e-5)


def test_float32_artifact_matches_jax_network(exported):
    params, _eager, _path, path32, pts = exported
    mask = np.ones(CAP, bool)
    maps = _jax_net(SMALL, params["params"], pts, mask)[3]
    jo = [np.asarray(a) for a in jpost.postprocess(jpost.PostProcessConfig(),
                                                   *JDetector(SMALL).decode(maps))]
    det = texport.ExportedDetector(path32)
    assert det.meta["dtype"] == "float32"
    to = [a.numpy() for a in det(pts, mask)]
    assert jo[3].sum() >= 5
    np.testing.assert_array_equal(to[3], jo[3])
    np.testing.assert_array_equal(to[2][to[3]], jo[2][jo[3]])
    _close(to[0][to[3]], jo[0][jo[3]], REL)
    _close(to[1][to[3]], jo[1][jo[3]], REL)


def test_refuses_bad_magic(tmp_path):
    p = tmp_path / "junk.pt2"
    p.write_bytes(b"NOTANART" + b"\x00" * 100)
    with pytest.raises(ValueError, match="not an lsd_tpu export"):
        texport.ExportedDetector(str(p))


def test_refuses_a_jax_artifact(exported, tmp_path):
    params = exported[0]
    path = jexport.export_detector(params, SMALL, point_capacity=1024,
                                   out_path=str(tmp_path / "det.hlo"), platforms=("cpu",))
    raw = open(path, "rb").read()
    n = struct.unpack("<I", raw[8:12])[0]
    assert raw[:8] == b"LSDTPU01" and "format" not in json.loads(raw[12:12 + n])
    with pytest.raises(ValueError, match="jax.export"):
        texport.ExportedDetector(path)
