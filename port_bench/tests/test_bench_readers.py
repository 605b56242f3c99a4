"""Each per-layer reader on a small recorded trace table."""
import pytest

from port_bench import harness
from port_bench.peaks import H100
from port_bench.trace import STRETCH, Trace

KERNEL = "void p2p_reduce_kernel<false, 16>(float const*, ...)"
# (name, on the device?, span?, start s, end s)
EVENTS = [
    (STRETCH, False, True, 0.0, 1.0),
    ("lio_step/front", False, True, 0.1, 0.2),
    ("lio_step/front", False, True, 0.5, 0.6),
    ("lio_step/front", True, True, 0.1, 0.2),          # the span's device shadow: no kernel
    ("aten::mul", False, False, 0.12, 0.18),
    ("bench/frame", False, True, 0.0, 0.4),
    ("bench/frame", False, True, 0.5, 0.9),
    ("bench/predict", False, True, 0.1, 0.2),
    ("bench/predict", False, True, 0.6, 0.7),
    ("detect/decode", False, True, 0.2, 0.25),
    ("detect/nms", False, True, 0.25, 0.3),
    ("detect/decode", False, True, 0.7, 0.75),
    ("detect/nms", False, True, 0.75, 0.8),
] + [("cudaLaunchKernel", False, False, 0.21 + 0.01 * i, 0.215 + 0.01 * i) for i in range(5)] + [
    (KERNEL, True, False, 0.25, 0.25001),
    (KERNEL, True, False, 0.26, 0.26001),
    ("void at::native::elementwise_kernel", True, False, 0.3, 0.4),
    ("Memcpy DtoH (Device -> Pinned)", True, False, 0.35, 0.45),
]


def run(workload):
    r = harness.Run(harness.Cell(workload))
    r.trace = Trace(EVENTS, items=2)
    r.items, r.window_s = 40, 2.0
    r.latencies_s = [0.001 * (i + 1) for i in range(40)]
    r.device_kind = "NVIDIA H100 80GB HBM3"
    r.counts = dict(b1_bytes=526_796, b1_flops=2_260_992, b1_calls_per_scan=4,
                    step_bytes=11.3e6, step_flops=9e6, network_flops=2e11)
    return r


def read(name, workload):
    return harness.load_reader(name)(run(workload))


def test_trace_sums():
    t = Trace(EVENTS, items=2)
    assert t.window_s == 1.0
    assert t.launches() == 5
    assert t.busy_s() == pytest.approx(0.15002)
    assert t.kernel_s("p2p_reduce") == (pytest.approx(2e-5), 2)
    gaps = dict(t.idle_gaps(min_s=1e-6))
    assert gaps["aten::mul"] == pytest.approx(0.25)    # the gap 0 .. 0.25: its middle is in it
    assert sum(gaps.values()) == pytest.approx(1.0 - 0.15002)


def test_slam_readers():
    assert read("lio_front_ms", "lio-replay") == pytest.approx(100.0)
    assert read("lio_launches_per_scan", "lio-replay") == pytest.approx(2.5)
    least = max(526_796 / H100["hbm_bytes_per_s"], 2_260_992 / H100["fp32_flops"])
    assert read("b1_roofline_pct", "lio-replay") == pytest.approx(100 * least / 1e-5)
    assert read("device_idle_pct.slam", "lio-replay") == pytest.approx(100 * (1 - 0.15002))
    assert read("lio_step_mfu_pct", "lio-replay") == pytest.approx(
        100 * 11.3e6 / H100["hbm_bytes_per_s"] * 20.0)


def test_detect_readers():
    assert read("detect_host_pct", "detect-drive") == pytest.approx(75.0)
    assert read("detect_nms_ms", "detect-drive") == pytest.approx(100.0)
    assert read("detect_mfu_pct", "detect-drive") == pytest.approx(100 * 2e11 * 20.0 / 989e12)
    assert read("device_idle_pct.detect", "detect-drive") == pytest.approx(100 * (1 - 0.15002))
    # numpy's linear percentile of 1 .. 40 ms: 38.05 ms
    assert read("detect_tail_ms_p95", "detect-drive") == pytest.approx(38.05)


def test_readers_without_a_trace_return_nothing():
    r = run("lio-replay")
    r.trace = None
    for name in ("lio_front_ms", "lio_launches_per_scan", "b1_roofline_pct",
                 "device_idle_pct.slam", "detect_nms_ms", "detect_host_pct"):
        assert harness.load_reader(name)(r) is None
