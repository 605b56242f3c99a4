"""Host ms per frame inside the program's span ``detect/accumulate``
(``DetectModule.process``'s ``FrameAccumulator.push``), over the profiled
stretch."""


def read(run):
    if run.trace is None or not len(run.trace.spans("detect/accumulate")):
        return None
    return run.trace.span_s("detect/accumulate") / run.trace.items * 1e3
