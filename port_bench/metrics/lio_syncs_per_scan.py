"""Host syncs per scan inside the LIO step's spans ``lio_step/front``,
``/iterate``, ``/covariance`` and ``/map_update`` (and their children),
over the profiled stretch (``syncs.py``)."""
from port_bench.syncs import syncs_in_spans

SPANS = ("lio_step/front", "lio_step/iterate", "lio_step/covariance", "lio_step/map_update")


def read(run):
    if run.trace is None:
        return None
    n = syncs_in_spans(run.trace, lambda name: name in SPANS)
    return None if n is None else n / run.trace.items
