"""Host ms per scan inside the program's span ``lio_step/front`` (IMU
propagation, undistortion, downsample, first plane match), over the
profiled stretch."""


def read(run):
    if run.trace is None or not len(run.trace.spans("lio_step/front")):
        return None
    return run.trace.span_s("lio_step/front") / run.trace.items * 1e3
