"""Host syncs per frame inside any of the program's ``detect/*`` spans
(``DetectModule.process``, the predict function and the tracker), over the
profiled stretch (``syncs.py``)."""
from port_bench.syncs import syncs_in_spans


def read(run):
    if run.trace is None:
        return None
    n = syncs_in_spans(run.trace, lambda name: name.startswith("detect/"))
    return None if n is None else n / run.trace.items
