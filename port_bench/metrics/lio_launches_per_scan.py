"""Kernel launches the host made per scan over the profiled stretch."""


def read(run):
    if run.trace is None:
        return None
    n = run.trace.launches()
    return n / run.trace.items if n else None
