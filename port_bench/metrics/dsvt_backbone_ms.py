"""Host ms per frame inside the program's span ``detect/dsvt`` (the DSVT
backbone: partition, position embeddings, the eight set-attention layers),
over the profiled stretch."""


def read(run):
    if run.trace is None or not len(run.trace.spans("detect/dsvt")):
        return None
    return run.trace.span_s("detect/dsvt") / run.trace.items * 1e3
