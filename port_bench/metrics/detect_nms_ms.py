"""Host ms per frame inside the program's spans ``detect/decode`` and
``detect/nms`` over the profiled stretch."""


def read(run):
    if run.trace is None:
        return None
    spans = [run.trace.spans(n) for n in ("detect/decode", "detect/nms")]
    if not any(len(s) for s in spans):
        return None
    return sum(run.trace.span_s(n) for n in ("detect/decode", "detect/nms")) / run.trace.items * 1e3
