"""Host ms per frame inside the program's span ``detect/dsvt/partition``
(the four set partitions of a frame: two shifts, two axes), over the
profiled stretch."""


def read(run):
    if run.trace is None or not len(run.trace.spans("detect/dsvt/partition")):
        return None
    return run.trace.span_s("detect/dsvt/partition") / run.trace.items * 1e3
