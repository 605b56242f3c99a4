"""B1's share of its roofline: the least time its bytes and operations
take at the card's data-sheet peaks (``counts/p2p.py``, at the cell's
residual point count), over B1's mean device time per call in the
profiled stretch."""
from port_bench.peaks import peaks


def read(run):
    if run.trace is None:
        return None
    t, n = run.trace.kernel_s("p2p_reduce")
    if not n or t <= 0:
        return None
    pk = peaks(run.device_kind)
    c = run.counts
    least = max(c["b1_bytes"] / pk["hbm_bytes_per_s"], c["b1_flops"] / pk["fp32_flops"])
    return 100.0 * least / (t / n)
