"""Host ms per frame inside the program's span ``detect/tracker``
(``DetectModule.process``'s ``Tracker3D.update``), over the profiled
stretch."""


def read(run):
    if run.trace is None or not len(run.trace.spans("detect/tracker")):
        return None
    return run.trace.span_s("detect/tracker") / run.trace.items * 1e3
