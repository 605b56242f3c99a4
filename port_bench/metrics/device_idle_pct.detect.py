"""The share of the profiled stretch in which no kernel, copy or set ran on
the card (detection cells)."""


def read(run):
    if run.trace is None or not len(run.trace.dev_t):
        return None
    return 100.0 * run.trace.idle_share()
