"""The DSVT-Pillar cell on the CPU at a small size: a sound run is correct,
a run with one head's key mask dropped in the program is not; the counts
on a layout counted by hand; the cell's readers on a small trace table;
the reference loads nothing of the program, the driver neither JAX nor the
JAX package."""
import io
import json

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.counts import dsvt as counts
from port_bench.drivers import dsvt_drive
from port_bench.trace import STRETCH, Trace

SEED = 2 ** 31 + 77
CPU = torch.device("cpu")
SMALL = dict(pc_range=[-15.36, -15.36, -2.0, 15.36, 15.36, 4.0], max_pillars=4096)


@pytest.fixture
def dsvt_cell(monkeypatch):
    from lsd_tpu_torch.models.detector import DetectorConfig
    full = DetectorConfig.dsvt_pillar()
    monkeypatch.setattr(DetectorConfig, "dsvt_pillar", classmethod(
        lambda cls: full._replace(pc_range=tuple(SMALL["pc_range"]),
                                  max_voxels=SMALL["max_pillars"])))
    cell = harness.Cell("dsvt-drive")
    cell.config = dict(cell.config, **SMALL, roi_half_width_m=15.0)
    cell.traffic = dict(cell.traffic, frames=4, points_per_frame=8192, range_m=15.36,
                        objects_in_range=8, columns=128, warm_frames=1, traced_frames=1,
                        check_frames=2)
    return cell


def result(cell):
    out = io.StringIO()
    assert harness.run_cell(cell, dsvt_drive, SEED, 0.3, False, CPU, out=out) == 0
    return json.loads(out.getvalue().splitlines()[-1])


def test_sound_dsvt_run_is_correct(dsvt_cell):
    r = result(dsvt_cell)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"detect_frames_per_s", "setup_s"}


def test_dsvt_fault_is_caught(monkeypatch, dsvt_cell):
    """Head 0 of every layer attends to the repeated slots as well."""
    from lsd_tpu_torch.models import dsvt
    real = dsvt.set_attention

    def one_head_unmasked(q, k, v, part, heads):
        out = real(q, k, v, part, heads)
        used = (part.flags[:, :1] & dsvt.KEY).bool()
        all_keys = part._replace(flags=part.flags | (used * dsvt.KEY).to(torch.uint8))
        hd = v.shape[1] // heads
        out[:, :hd] = real(q, k, v, all_keys, heads)[:, :hd]
        return out
    one_head_unmasked.launches = 0
    monkeypatch.setattr(dsvt, "set_attention", one_head_unmasked)
    r = result(dsvt_cell)
    assert not r["correct"], r["checks"]
    share = r["checks"]["attention_unmasked_share"]
    assert share["value"] > share["limit"], r["checks"]


def test_counts_of_a_hand_counted_layout():
    cfg = dict(pc_range=[0.0, 0.0, -2.0, 2.56, 2.56, 4.0], voxel_size=[0.32, 0.32, 6.0],
               num_classes=3)
    # three pillars (y, x): two in window (0, 0) of the 12x12 shift and one
    # in window (1, 0); all three in window (0, 0) of the 24x24 shift (6, 6)
    cells = np.asarray([[0, 0], [0, 1], [0, 12]])
    assert counts.frame_partition(cells) == [(2, 36 - 2 + 36 - 1), (1, 36 - 3)]
    assert counts.attn_flops(2) == 2 * 2 * 36 * 36 * 192 * 2
    assert counts.attn_bytes(3, 2) == 3 * 4 * 192 * 2 + 2 * 36 * 5
    # an 8 x 8 grid: stages at 8^2, 4^2, 2^2
    s1 = (2 * 9 * 192 * 128 * 64 + 2 * 9 * 128 * 128 * 64 + 2 * 192 * 128 * 64
          + 2 * (2 * 9 * 128 * 128 * 64) + 2 * 128 * 128 * 64)
    s2 = (2 * 9 * 128 * 128 * 16 * 2 + 2 * 128 * 128 * 16 + 2 * 2 * 9 * 128 * 128 * 16 * 2
          + 2 * 4 * 128 * 128 * 16)
    s3 = (2 * 9 * 128 * 256 * 4 + 2 * 9 * 256 * 256 * 4 + 2 * 128 * 256 * 4
          + 2 * 2 * 9 * 256 * 256 * 4 * 2 + 2 * 16 * 256 * 128 * 4)
    head = 2 * 9 * 384 * 64 * 64 + 6 * 2 * 9 * 64 * 64 * 64 + 2 * 64 * 64 * (3 + 2 + 1 + 3 + 2 + 1)
    assert counts.dense_flops(cfg) == s1 + s2 + s3 + head
    vfe = 2 * 10 * (10 * 96 + 192 * 192)
    layer = 2 * 3 * (192 * 384 + 192 * 192 * 2 + 2 * 192 * 384)
    block = [2 * 3 * (2 * 192 + 192 * 192) + 2 * (layer + counts.attn_flops(s))
             for s in (2, 1, 2, 1)]
    dense = s1 + s2 + s3 + head
    assert counts.network_flops(cfg, 10, 3, [(2, 69), (1, 33)]) == vfe + sum(block) + dense


KERNEL = "(anonymous namespace)::dsvt_set_attn_kernel(__nv_bfloat16 const*, long long, ...)"
EVENTS = [
    (STRETCH, False, True, 0.0, 1.0),
    ("detect/dsvt", False, True, 0.1, 0.3),
    ("detect/dsvt/partition", False, True, 0.1, 0.15),
    ("detect/dsvt", False, True, 0.6, 0.7),
    ("detect/dsvt/partition", False, True, 0.6, 0.62),
] + [("cudaLaunchKernel", False, False, 0.2 + 0.03 * i, 0.205 + 0.03 * i) for i in range(6)] + [
    (KERNEL, True, False, 0.25, 0.25002),
    (KERNEL, True, False, 0.65, 0.65004),
]


def test_dsvt_readers_on_a_trace_table():
    run = harness.Run(harness.Cell("dsvt-drive"))
    run.trace = Trace(EVENTS, items=2)
    run.items, run.window_s = 40, 2.0
    run.device_kind = "NVIDIA H100 80GB HBM3"
    run.counts = dict(dsvt_flops=8e11, attn_bytes=8.5e7, attn_flops=2e9)

    def read(name):
        return harness.load_reader(name)(run)
    assert read("dsvt_backbone_ms") == pytest.approx((0.2 + 0.1) / 2 * 1e3)
    assert read("dsvt_partition_ms") == pytest.approx((0.05 + 0.02) / 2 * 1e3)
    # launches start at 0.20, 0.23, ..., 0.35 s: four inside the first detect/dsvt span
    assert read("dsvt_launches_per_frame") == 4 / 2
    assert read("dsvt_mfu_pct") == pytest.approx(100 * 8e11 * 20 / 989e12)
    assert read("dsvt_attn_roofline_pct") == pytest.approx(100 * (8.5e7 / 3.35e12) / 3e-5)
    # without a trace, or without the kernel in it, the trace's readers give nothing
    run.trace = Trace([e for e in EVENTS if e[0] != KERNEL and not e[0].startswith("detect/")], 2)
    for name in ("dsvt_backbone_ms", "dsvt_partition_ms", "dsvt_attn_roofline_pct",
                 "dsvt_launches_per_frame"):
        assert read(name) is None


def test_dsvt_reference_loads_nothing_of_the_program():
    from port_bench.tests.test_bench_layout import _modules_after
    mods = _modules_after("import port_bench.reference.dsvt")
    assert "lsd_tpu_torch" not in mods and not mods & set(harness.FORBIDDEN)
    assert not _modules_after("import port_bench.drivers.dsvt_drive") & set(harness.FORBIDDEN)
