"""Kernel launches the host made per frame inside the program's span
``detect/dsvt`` (the DSVT backbone: partition, position embeddings, the
eight set-attention layers) over the profiled stretch: a launch counts
where its start lies inside such a span."""
import numpy as np

from port_bench.trace import LAUNCH_PREFIXES


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    spans = t.spans("detect/dsvt")
    if not len(spans):
        return None
    starts = np.asarray([t.host_t[i, 0] for i, n in enumerate(t.host_names)
                         if n.startswith(LAUNCH_PREFIXES) and not t.host_annot[i]], float)
    inside = np.zeros(len(starts), bool)
    for s, e in spans:
        inside |= (starts >= s) & (starts <= e)
    return int(inside.sum()) / t.items
