"""The set-attention kernel's share of its roofline: the least time its
counted bytes and operations take at the card's data-sheet peaks
(``counts/dsvt.py``, from the traced frames' sets and pillars; bf16
tensor-core peak for the operations), over the kernel's mean device time
per call in the profiled stretch."""
from port_bench.peaks import peaks


def read(run):
    if run.trace is None or "attn_bytes" not in run.counts:
        return None
    t, n = run.trace.kernel_s("dsvt_set_attn")
    if not n or t <= 0:
        return None
    pk = peaks(run.device_kind)
    c = run.counts
    least = max(c["attn_bytes"] / pk["hbm_bytes_per_s"], c["attn_flops"] / pk["bf16_flops"])
    return 100.0 * least / (t / n)
