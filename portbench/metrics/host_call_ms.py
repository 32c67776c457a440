"""Median host ms of a call of the measured window (untraced), from its
entry to its return, before the read-back: the enqueue path of the
engine's closure, the wrappers and the kernels' ctypes launches, and any
host synchronisation inside the call."""
import statistics


def read(run):
    return 1e3 * statistics.median(run.window.call_s)
