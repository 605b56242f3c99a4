"""The whole LIO step's share of the card's peak: the least time of its
counted bytes and operations (``counts/lio_step.py``) at the data-sheet
peaks, over the measured time per scan of the untraced window."""
from port_bench.peaks import peaks


def read(run):
    if not run.items or "step_bytes" not in run.counts:
        return None
    pk = peaks(run.device_kind)
    c = run.counts
    least = max(c["step_bytes"] / pk["hbm_bytes_per_s"], c["step_flops"] / pk["fp32_flops"])
    return 100.0 * least * run.rate
