"""Host ms per scan inside the program's spans ``lio_step/front/propagate``
(the IMU propagation loop over the scan's IMU slots) and
``lio_step/front/undistort``, over the profiled stretch."""

SPANS = ("lio_step/front/propagate", "lio_step/front/undistort")


def read(run):
    if run.trace is None or not any(len(run.trace.spans(n)) for n in SPANS):
        return None
    return sum(run.trace.span_s(n) for n in SPANS) / run.trace.items * 1e3
