"""Trees evaluated over the measured window, divided by its seconds on the
host clock (from before the first call's draw until the device has
finished the last call)."""


def read(run):
    return run.evals / run.window.seconds
