"""95th percentile (ms) of ``DetectModule.process`` over all frames of the
untraced rest of a traced run's window, by the host's clock."""
from port_bench.harness import percentile


def read(run):
    if not run.latencies_s:
        return None
    return percentile(run.latencies_s, 95) * 1e3
