"""DSVT-Pillar on the CPU against ``lsd_tpu_torch/models/dsvt_plain.py``,
the plain float32 reference, on seeded random weights.

- The set partition: windows of 1, 35, 36, 37 and 73 pillars, both shifts
  and both axes, gives the reference's sets slot for slot, the repeated
  slots masked as keys and each pillar written from its first slot, once.
- One set-attention layer and the whole forward (d_model 192 on a 48 x 48
  grid of ~500 pillars, the BatchNorms' statistics and the norms' affine
  parameters drawn at random so that folding is exercised), the port's
  float32 twin within 1e-4 of each output's largest magnitude: the same
  float32 arithmetic, summed in another order.
- The dynamic encoder with a pillar of 300 points (no cap on the points a
  pillar) within 1e-5 of the largest feature.
- ``DetectModule`` serving ``detection.capacity: dsvt_pillar`` end to end
  (bf16, as served) from a checkpoint in the port's format.
"""
import numpy as np
import pytest
import torch

from lsd_tpu_torch.models import dsvt_plain
from lsd_tpu_torch.models.detector import (CenterPointDetector, DetectorConfig,
                                           init_detector_params)
from lsd_tpu_torch.models.dsvt import KEY, WRITE, DSVTConfig, SetAttentionLayer, partition_shift
from lsd_tpu_torch.ops.voxelize import pillarize_dynamic

SMALL = DetectorConfig.dsvt_pillar()._replace(
    pc_range=(-74.88, -74.88, -2.0, -74.88 + 15.36, -74.88 + 15.36, 4.0), max_voxels=1024)


def twin(cfg=SMALL, seed=0):
    """The float32 twin, its BatchNorm statistics and norm parameters
    drawn at random, folded."""
    model = CenterPointDetector(cfg, dtype=torch.float32)
    init_detector_params(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    return model.eval().fold()


def frame(n=4000, seed=0, heavy=300):
    """~500 pillars over the small grid and one pillar of ``heavy`` points."""
    rng = np.random.default_rng(seed)
    lo, hi = SMALL.pc_range[0], SMALL.pc_range[3]
    pts = np.concatenate([rng.uniform(lo, hi, (n, 2)), rng.uniform(-0.5, 2, (n, 1)),
                          rng.uniform(0, 1, (n, 1))], 1).astype(np.float32)
    pts = pts[(rng.uniform(0, 1, n) < 0.15) | (np.arange(n) < heavy)]
    pts[:heavy, :2] = [lo + 3.9, lo + 3.9] + rng.uniform(0, 0.2, (heavy, 2))   # one 0.32 m cell
    return pts


def rel_gap(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


@pytest.mark.parametrize("axis", ["x", "y"])
@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("n", [1, 35, 36, 37, 73])
def test_partition_follows_the_equations(n, shift, axis):
    window, sh = DSVTConfig().shifts()[shift]
    rng = np.random.default_rng(n)
    # n pillars in window (1, 1) of the shift, 5 in window (2, 1); cells (y, x)
    (wx, wy), (sx, sy) = window, sh
    cells = []
    for k, count in ((1, n), (2, 5)):
        off = rng.permutation(wx * wy)[:count]
        cells.append(np.stack([wy - sy + off // wx, k * wx - sx + off % wx], 1))
    cells = np.concatenate(cells)
    P = 128
    coords = torch.zeros(P, 3, dtype=torch.int32)
    coords[:len(cells), 1:] = torch.as_tensor(cells)
    pmask = torch.arange(P) < len(cells)
    parts = partition_shift(coords, pmask, window, sh, (96, 96), 36)
    part = parts[0 if axis == "x" else 1]
    want = dsvt_plain.sets_of(cells, window, sh, axis)
    S = int(part.n_sets)
    assert S == len(want) == -(-n // 36) + 1
    assert np.array_equal(part.inds[:S].numpy(), want)
    assert not part.flags[S:].any()
    inds = part.inds[:S].long()
    repeat = torch.zeros_like(inds, dtype=torch.bool)
    repeat[:, 1:] = inds[:, 1:] == inds[:, :-1]
    assert torch.equal((part.flags[:S] & KEY).bool(), ~repeat)
    assert int(part.repeats) == int(repeat.sum()) == S * 36 - len(cells)
    flat = inds.reshape(-1).numpy()
    _, first = np.unique(flat, return_index=True)
    written = np.zeros(flat.shape, bool)
    written[first] = True
    assert np.array_equal((part.flags[:S] & WRITE).bool().reshape(-1).numpy(), written)
    rel = parts[2][:len(cells)].numpy()
    x, y = cells[:, 1] + sh[0], cells[:, 0] + sh[1]
    assert np.array_equal(rel, np.stack([x % window[0] - window[0] / 2,
                                         y % window[1] - window[1] / 2], 1))


def test_set_attention_layer_matches_plain():
    torch.manual_seed(0)
    cells, _, _, _ = dsvt_plain.pillars(frame(), SMALL.pc_range)
    P = len(cells)
    coords = torch.zeros(P, 3, dtype=torch.int32)
    coords[:, 1:] = torch.as_tensor(cells)
    px, _, _ = partition_shift(coords, torch.ones(P, dtype=torch.bool), (12, 12), (0, 0),
                               SMALL.grid_hw, 36)
    layer = SetAttentionLayer(DSVTConfig())
    for name, p in layer.named_parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape) * (0.1 if p.dim() > 1 else 0.5) + (p.dim() == 1))
    for m in layer.modules():
        if hasattr(m, "fold"):
            m.fold(torch.float32)
    x, pe = torch.randn(P, 192), torch.randn(P, 192)
    with torch.no_grad():
        got = layer(x, pe, px)
        net = dsvt_plain._Net({f"l.{k}": v for k, v in layer.state_dict().items()}, "cpu", None)
        want = dsvt_plain.layer(net, x, pe, dsvt_plain.sets_of(cells, (12, 12), (0, 0), "x"), "l")
    assert rel_gap(got, want) <= 1e-4


def test_dynamic_encoder_matches_plain_with_a_300_point_pillar():
    model = twin()
    pts = frame()
    t = torch.as_tensor(pts)
    order, seg, cells, coords, pmask, found = pillarize_dynamic(
        t, torch.ones(len(t), dtype=torch.bool), SMALL.voxel_size, SMALL.pc_range,
        SMALL.max_voxels)
    assert int(torch.bincount(seg[seg < SMALL.max_voxels]).max()) >= 300
    with torch.no_grad():
        got = model.vfe(t[order], seg, cells, SMALL.max_voxels)
        net = dsvt_plain._Net(dict(model.state_dict()), "cpu", None)
        want, ref_cells, _ = dsvt_plain.pillar_features(net, pts, SMALL.pc_range)
    M = int(found)
    assert M == len(ref_cells) == int(pmask.sum())
    assert np.array_equal(coords[:M, 1:].numpy(), ref_cells)
    assert rel_gap(got[:M], want) <= 1e-5
    assert not got[M:].any()


def test_forward_matches_plain_at_d192():
    model = twin(seed=3)
    pts = frame(seed=3)
    kept = {}
    encode = model.encode
    model.encode = lambda p, m: kept.setdefault("features", encode(p, m))
    with torch.inference_mode():
        out = model(torch.as_tensor(pts), torch.ones(len(pts), dtype=torch.bool))
    ref = dsvt_plain.forward(dict(model.state_dict()), pts, "cpu", pc_range=SMALL.pc_range)
    assert 400 < int(model.dsvt.counters[2]) < 600
    assert rel_gap(kept["features"], ref["features"]) <= 1e-4
    for k, v in out.items():
        assert v.shape == ref[k].shape == (48, 48, v.shape[-1])
        assert rel_gap(v, ref[k]) <= 1e-4, k


def test_detect_module_serves_dsvt_pillar(monkeypatch, tmp_path):
    from lsd_tpu_torch.models.params_io import save_params, state_dict_to_tree
    from lsd_tpu_torch.runtime.config import AttrDict
    from lsd_tpu_torch.runtime.modules import DetectModule
    monkeypatch.setattr(DetectorConfig, "dsvt_pillar", classmethod(lambda cls: SMALL))
    path = save_params(str(tmp_path / "dsvt.msgpack"), state_dict_to_tree(twin().state_dict()))
    cfg = AttrDict(dict(input=dict(mode="offline"), detection=dict(
        enable=True, capacity="dsvt_pillar", accum_frames=1, weights=path)))
    module = DetectModule(cfg, device="cpu")
    module.setup(cfg)
    model = module.predict_fn.model
    assert module.accumulator is None and model.cfg.encoder == "dsvt"
    assert model.dtype == torch.bfloat16
    for k in range(2):
        motion = np.eye(4)
        motion[0, 3] = 1.0
        d = module.process(dict(lidar_valid=True, points={"lidar": frame(seed=k)},
                                frame_timestamp_monotonic=k * 100000, timestep=100000,
                                motion_t=motion if k else None, motion_valid=k > 0))
        assert isinstance(d["objects"], list)
        assert (d["freespace"]["y_num"], d["freespace"]["x_num"]) == (48, 48)
    assert int(model.dsvt.counters[0]) == 2
