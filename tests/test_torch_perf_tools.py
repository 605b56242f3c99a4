"""Port parity for the measurement tools ``lsd_tpu_torch/tools/{roofline,
schur_chip_bench,scaling,profile,bench_p2p}.py`` against their ``lsd_tpu``
counterparts, on the CPU at small sizes.

- ``roofline``: ``lio_traffic_model``, ``detection_traffic_model`` and
  ``stage_report`` give the reference's dicts (equal), every ``bound``
  case included; ``flop_count`` counts a matrix product's 2mnk.
- ``schur_chip_bench.build_merge_shaped_graph``: the reference's graph
  data, every array equal; rank 0's Schur round of a 4-rank plan of a
  120-node graph (32 interiors, 8 separators), run in a one-rank gloo
  group, within 1e-5 m of the reference's ``_build_round`` on one CPU
  device (one round from the same graph; measured 1.9e-6 m, an ulp at
  30 m.  At 64 separators the two float32 factorizations part by 4e-5 m).
- ``scaling``: ``lio_model`` and ``schur_model`` equal the reference's
  formula with its ``ICI_BW`` and ``PSUM_LAT`` set to the bandwidth and
  latency passed to the port (the port names them ``projected_*``);
  ``measure_virtual_cpu`` runs on groups of 1 and 2 gloo ranks.
- Smoke runs of ``profile.profile_lio_replay`` (with a trace),
  ``roofline.profile_lio_phases``, ``measure_peaks`` and ``bench_p2p.bench``:
  their report keys.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_tpu.models import DetectorConfig as JDetConfig
from lsd_tpu.parallel import schur_pgo as jschur
from lsd_tpu.slam import LioConfig as JLioConfig
from lsd_tpu.slam.posegraph import PgoConfig as JPgoConfig
from lsd_tpu.tools import roofline as jroof
from lsd_tpu.tools import scaling as jscaling
from lsd_tpu.tools import schur_chip_bench as jbench
from lsd_tpu_torch import convert
from lsd_tpu_torch.models import DetectorConfig
from lsd_tpu_torch.slam import LioConfig
from lsd_tpu_torch.slam.posegraph import PgoConfig
from lsd_tpu_torch.tools import roofline as troof
from lsd_tpu_torch.tools import scaling as tscaling
from lsd_tpu_torch.tools import schur_chip_bench as tbench


@pytest.mark.parametrize("kw,raw", [(dict(), 2 ** 15),
                                    (dict(ds_capacity=4096, map_capacity=2 ** 16, max_iters=3),
                                     8192)])
def test_lio_traffic_model_equal(kw, raw):
    assert troof.lio_traffic_model(LioConfig(**kw), raw) == \
        jroof.lio_traffic_model(JLioConfig(**kw), raw)


@pytest.mark.parametrize("factory", ["reference_capacity", "true_reference_capacity"])
def test_detection_traffic_model_equal(factory):
    j = getattr(JDetConfig, factory)()
    t = getattr(DetectorConfig, factory)()
    assert troof.detection_traffic_model(t, 2 ** 17, 1.5e7) == \
        jroof.detection_traffic_model(j, 2 ** 17, 1.5e7)


PEAKS = [dict(bf16_tflops=989.0, hbm_gbps=3350.0),
         dict(measured_mxu_tflops=700.0, measured_hbm_gbps=2900.0, bf16_tflops=989.0,
              hbm_gbps=3350.0)]


@pytest.mark.parametrize("peaks", PEAKS, ids=["datasheet", "measured"])
@pytest.mark.parametrize("ms,flops,nbytes", [(1.0, 5e11, 1e6),      # compute-bound
                                             (1.0, 1e6, 2e9),       # memory-bound
                                             (100.0, 1e6, 1e6),     # latency-bound
                                             (0.0, 1e6, 1e6)])
def test_stage_report_equal(peaks, ms, flops, nbytes):
    assert troof.stage_report("lio", ms, flops, nbytes, peaks, note="x") == \
        jroof.stage_report("lio", ms, flops, nbytes, peaks, note="x")


def test_flop_count_counts_a_matmul():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    assert troof.flop_count(lambda: a @ b) == 2 * 8 * 16 * 4


def test_merge_shaped_graph_equal():
    want = jbench.build_merge_shaped_graph(300, 40, 120, seed=3).to_data()
    got = convert.graph_to_numpy(
        tbench.build_merge_shaped_graph(300, 40, 120, seed=3).to_data(device="cpu"))
    assert list(got) == list(want._fields)
    for part, fields in got.items():
        for f, g in fields.items():
            w = np.asarray(getattr(getattr(want, part), f))
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=f"{part}.{f}")


def test_schur_round_matches_reference():
    from jax.sharding import Mesh

    from lsd_tpu_torch.parallel.mesh import single_rank
    ndev, cfg = 4, dict(outer_iters=2, cg_iters=80)
    jg = jbench.build_merge_shaped_graph(120, 10, 40, seed=1).to_data()
    plan = jschur.build_plan(jg, ndev)
    n = jg.nodes.quat.shape[0]
    rnd = jschur._build_round(Mesh(np.asarray(jax.devices()[:1]), ("d",)), JPgoConfig(**cfg),
                              plan.m_int, plan.n_sep, plan.e_rows.shape[1],
                              plan.g_rows.shape[1], plan.f_rows.shape[1],
                              plan.o_rows.shape[1], n)
    J = jnp.asarray
    rows = [J(plan.int_ids[:1].astype(np.int32)), J(plan.int_mask[:1]),
            J(plan.sep_ids.astype(np.int32)), J(plan.sep_mask)]
    for p in ("e", "g", "f", "o"):
        rows += [J(getattr(plan, f"{p}_rows")[:1].astype(np.int32)),
                 J(getattr(plan, f"{p}_slots")[:1].astype(np.int32)),
                 J(getattr(plan, f"{p}_mask")[:1])]
    free = (jg.nodes.mask & ~jg.nodes.fixed).astype(jnp.float32)
    nodes, gps_on = jg.nodes, jnp.ones_like(jg.gps.mask)
    nodes, gps_on = rnd(nodes, gps_on, free, *rows, jg.se3, jg.gps, jg.floor, jg.orient)

    tg = tbench.build_merge_shaped_graph(120, 10, 40, seed=1).to_data(device="cpu")
    with single_rank("gloo", device="cpu") as mesh:
        trnd, trows, tfree, tplan = tbench.rank0_round(tg, ndev, PgoConfig(**cfg), mesh)
        assert (tplan.m_int, tplan.n_sep) == (plan.m_int, plan.n_sep)
        tnodes, tgps = tg.nodes, torch.ones_like(tg.gps.mask)
        tnodes, tgps = trnd(tnodes, tgps, tfree, *trows, tg.se3, tg.gps, tg.floor, tg.orient)
    moved = float(np.abs(np.asarray(nodes.pos) - np.asarray(jg.nodes.pos)).max())
    assert moved > 5e-4                                   # the round did work
    np.testing.assert_allclose(tnodes.pos.numpy(), np.asarray(nodes.pos), atol=1e-5)
    np.testing.assert_allclose(tnodes.quat.numpy(), np.asarray(nodes.quat), atol=1e-5)
    np.testing.assert_array_equal(tgps.numpy(), np.asarray(gps_on))


@pytest.mark.parametrize("bw,lat", [(45e9, 10e-6), (450e9, 5e-6)])
def test_scaling_models_equal(monkeypatch, bw, lat):
    monkeypatch.setattr(jscaling, "ICI_BW", bw)
    monkeypatch.setattr(jscaling, "PSUM_LAT", lat)
    shard = {2: 0.07, 8: 0.03}
    pairs = [(tscaling.lio_model(0.1, 16384, 4, t_shard=shard, bw=bw, lat=lat),
              jscaling.lio_model(0.1, 16384, 4, t_shard=shard), "comm_bytes_per_scan"),
             (tscaling.schur_model(0.2, 64, t_shard=shard, bw=bw, lat=lat),
              jscaling.schur_model(0.2, 64, t_shard=shard), "comm_bytes_per_round")]
    names = dict(t_comm_us="projected_t_comm_us", efficiency="projected_efficiency",
                 speedup="projected_speedup")
    for got, want, key in pairs:
        assert got[key] == want[key]
        assert got["projected"].keys() == want["projected"].keys()
        for n, row in want["projected"].items():
            assert got["projected"][n] == {names.get(k, k): v for k, v in row.items()}


def test_measure_virtual_cpu_on_two_ranks():
    res = tscaling.measure_virtual_cpu(max_dev=2, cap=1024, ds=512, map_cap=2 ** 12,
                                       n_scans=2, reps=1)
    assert sorted(res) == [1, 2] and all(v > 0 for v in res.values())


def test_profile_lio_replay_runs(tmp_path):
    from lsd_tpu_torch import sim as tsim
    from lsd_tpu_torch.tools.profile import profile_lio_replay
    from lsd_tpu_torch.tools.recording import write_recording
    sim = tsim.CircleSim(tsim.SimConfig(n_scans=8, points_per_scan=2048, seed=7))
    rec = write_recording(str(tmp_path / "rec"), sim, sim.generate(capacity=2048))
    rep = profile_lio_replay(rec, str(tmp_path / "trace"), max_frames=8, point_capacity=2048,
                             device="cpu")
    assert rep["frames"] == 8 and rep["device"] == "cpu"
    for k in ("host_parse_ms", "device_step_ms"):
        assert set(rep[k]) == {"mean", "p50", "p95", "max"} and rep[k]["mean"] > 0
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_lio_phases_peaks_and_bench_p2p_run():
    from lsd_tpu_torch.slam import lio_init, lio_step
    from lsd_tpu_torch.tools import bench_p2p
    cfg = LioConfig(ds_capacity=1024, map_capacity=2 ** 14, scan_voxel=0.4, map_voxel=0.4,
                    max_iters=4)
    _, data = troof.bench_scans(3, 2048)
    scans = [tuple(torch.as_tensor(a) for a in d[:5]) for d in data]
    st = lio_init(cfg, device="cpu")
    for scan in scans[:2]:
        st, _ = lio_step(cfg, st, *scan)
    phases = troof.profile_lio_phases(cfg, st, *scans[2], n_rep=1)
    assert list(phases) == list(troof.PHASES) and all(v > 0 for v in phases.values())
    peaks = troof.measure_peaks(size_mm=64, size_copy_mb=1, inner=2, device="cpu")
    assert set(peaks) == {"measured_mxu_tflops", "measured_hbm_gbps", "bf16_tflops", "hbm_gbps"}
    rep = bench_p2p.bench(scans=2, points=2048, warm=2, n_rep=1, device="cpu")
    assert set(rep["per_call"]) == {"b1_ms", "reference_route_ms", "plain_ms"}
    assert rep["routes_gap"]["hth_rel"] < 1e-4 and rep["lio_step"]["finite"]
