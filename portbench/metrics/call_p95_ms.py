"""95th percentile (nearest rank) over every call of the window of one
synchronous call: from the call's entry until all it returned is in
host memory.  Traffic that does not read every call back has none."""
from portbench.stats import percentile


def read(run):
    if not run.window.latency_s:
        return None
    return percentile(run.window.latency_s, 95) * 1e3
