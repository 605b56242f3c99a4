"""Host syncs in a traced stretch, counted at the program's span boundaries.

A host sync is a synchronising CUDA runtime call in the trace
(``SYNC_CALLS``): the host waits there for the card.  Most of the
program's syncs are implicit (inside ``linalg.eigh``'s solver and at its
error check, ``bool`` of a device tensor, a fetch); the trace records each
one, where ``torch.cuda.set_sync_debug_mode`` misses the solver's own, and
reading it costs nothing while tracing is off.  A call counts for the program where its
start lies inside one of the program's spans (``trace.Trace``'s host
annotations whose names a reader selects); nested spans count a call once.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

SYNC_CALLS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"))


def syncs_in_spans(trace, keep: Callable[[str], bool]) -> Optional[int]:
    """Synchronising runtime calls whose start lies inside a span of the
    stretch whose name ``keep`` selects; None where the stretch holds no
    such span."""
    sel = [i for i, n in enumerate(trace.host_names) if trace.host_annot[i] and keep(n)]
    spans = trace.host_t[sel]
    spans = spans[(spans[:, 0] >= trace.t0) & (spans[:, 1] <= trace.t1)]
    if not len(spans):
        return None
    starts = np.asarray([trace.host_t[i, 0] for i, n in enumerate(trace.host_names)
                         if n in SYNC_CALLS and not trace.host_annot[i]], float)
    inside = np.zeros(len(starts), bool)
    for s, e in spans:
        inside |= (starts >= s) & (starts <= e)
    return int(inside.sum())
