"""The least time of the traced window's tree-likelihood work (each call's
FLOPs at the configuration's peak, or its bytes at the card's bandwidth,
whichever is longer: portbench/work.py) over the device time of every
kernel that the program's own library launched in that window, in %."""
from portbench import work


def read(run):
    t = run.trace
    kernel_s = t.device_s(library=True)
    if not t.calls or kernel_s <= 0:
        return None
    least = work.least_s(run.config, run.patterns, run.batch,
                          run.gradients)
    return 100.0 * t.calls * least / kernel_s
