"""Process start to the first measured call: imports, the card's start,
the kernel library's load (and its build, in a checkout's first run), the
inputs, the engine, its tapes, and the warm-up calls."""


def read(run):
    return run.setup_s
