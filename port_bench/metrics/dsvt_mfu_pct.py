"""DSVT-Pillar's share of the card's bf16 peak: its operations per frame
counted from the layer shapes and the frames' real sets
(``counts/dsvt.py``), times the frames per second of the untraced window,
over the data-sheet peak."""
from port_bench.peaks import peaks


def read(run):
    if not run.items or "dsvt_flops" not in run.counts:
        return None
    return 100.0 * run.counts["dsvt_flops"] * run.rate / peaks(run.device_kind)["bf16_flops"]
