"""The share of the traced window in which the card was idle, in %: 1 -
(the union of its kernel, memcpy and memset intervals) / (the window's
seconds on the harness's clock), both from that window alone.  The
profiler's launch callbacks slow the host's enqueue, so a host-paced cell
idles more here than in the untraced window that the end-to-end metrics
measure."""


def read(run):
    t = run.trace
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
