"""The readers of the program's inner spans and of host syncs per span, on a
small recorded trace table (the pattern of ``test_bench_readers.py``)."""
import pytest

from port_bench import harness
from port_bench.syncs import syncs_in_spans
from port_bench.trace import STRETCH, Trace

SYNC = "cudaStreamSynchronize"
# (name, on the device?, span?, start s, end s): two scans, then two frames
EVENTS = [
    (STRETCH, False, True, 0.0, 1.0),
    ("lio_step/front", False, True, 0.0, 0.2),
    ("lio_step/front/propagate", False, True, 0.01, 0.05),
    ("lio_step/front/undistort", False, True, 0.05, 0.07),
    ("lio_step/iterate", False, True, 0.2, 0.3),
    ("lio_step/iterate/gate", False, True, 0.21, 0.22),
    ("lio_step/map_update", False, True, 0.3, 0.35),
    ("lio_step/front", False, True, 0.5, 0.7),
    ("lio_step/front/propagate", False, True, 0.51, 0.56),
    ("lio_step/front/undistort", False, True, 0.56, 0.59),
    ("lio_step/iterate", False, True, 0.7, 0.8),
    ("lio_step/iterate/gate", False, True, 0.71, 0.72),
    ("detect/accumulate", False, True, 0.0, 0.004),
    ("detect/fetch", False, True, 0.4, 0.401),
    ("detect/tracker", False, True, 0.402, 0.405),
    ("detect/accumulate", False, True, 0.5, 0.506),
    ("detect/tracker", False, True, 0.9, 0.905),
    ("lio_step/iterate/gate", True, True, 0.21, 0.22),      # a span's device shadow
] + [(SYNC, False, False, t, t + 1e-4) for t in (
    0.215, 0.216, 0.25,          # in iterate/gate twice, in iterate once
    0.32,                        # in map_update
    0.45,                        # outside every program span
    0.4005,                      # in detect/fetch
    0.715,                       # in the second scan's gate
)] + [
    ("cudaMemcpyAsync", False, False, 0.217, 0.2171),       # not a sync by itself
    ("cudaMemcpy", False, False, 0.9025, 0.9026),           # in detect/tracker
    ("void at::native::elementwise_kernel", True, False, 0.3, 0.31),
]


def run(workload, events=EVENTS):
    r = harness.Run(harness.Cell(workload))
    r.trace = Trace(events, items=2)
    r.items, r.window_s = 40, 2.0
    return r


def read(name, workload, events=EVENTS):
    return harness.load_reader(name)(run(workload, events))


def test_a_sync_counts_inside_a_program_span_only():
    t = Trace(EVENTS, items=2)
    assert syncs_in_spans(t, lambda n: n.startswith("lio_step/")) == 5
    assert syncs_in_spans(t, lambda n: n == "lio_step/iterate/gate") == 3
    assert syncs_in_spans(t, lambda n: n.startswith("detect/")) == 2
    # the sync at 0.45 s lies in no span; it counts once the span covers it
    outside = [(SYNC, False, False, 0.45, 0.4501), (STRETCH, False, True, 0.0, 1.0)]
    assert syncs_in_spans(Trace(outside + [("detect/fetch", False, True, 0.3, 0.4)], 1),
                          lambda n: n.startswith("detect/")) == 0
    assert syncs_in_spans(Trace(outside + [("detect/fetch", False, True, 0.4, 0.5)], 1),
                          lambda n: n.startswith("detect/")) == 1


def test_sync_readers():
    assert read("lio_syncs_per_scan", "lio-replay") == pytest.approx(5 / 2)
    assert read("detect_syncs_per_frame", "detect-drive") == pytest.approx(2 / 2)


def test_lio_imu_ms_sums_both_children_over_the_scans():
    # (0.04 + 0.02 + 0.05 + 0.03) s over 2 scans
    assert read("lio_imu_ms", "lio-replay") == pytest.approx(70.0)


def test_detect_host_span_readers():
    assert read("detect_accumulate_ms", "detect-drive") == pytest.approx(5.0)
    assert read("detect_tracker_ms", "detect-drive") == pytest.approx(4.0)


NEW = (("lio_imu_ms", "lio-replay"), ("lio_syncs_per_scan", "lio-replay"),
       ("detect_accumulate_ms", "detect-drive"), ("detect_tracker_ms", "detect-drive"),
       ("detect_syncs_per_frame", "detect-drive"))


@pytest.mark.parametrize("name,workload", NEW)
def test_reader_without_its_spans_returns_nothing(name, workload):
    # a stretch with a sync and an operator, and no program span
    bare = [(STRETCH, False, True, 0.0, 1.0), (SYNC, False, False, 0.5, 0.5001),
            ("aten::mul", False, False, 0.4, 0.6)]
    assert read(name, workload, bare) is None
    r = run(workload)
    r.trace = None
    assert harness.load_reader(name)(r) is None
