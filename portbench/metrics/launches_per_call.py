"""Device operations (kernels, memcpys, memsets) a call in the traced
window, the harness's draws and read-back copies included: a count that
repeats exactly while the program launches the same work."""


def read(run):
    t = run.trace
    if not t.calls:
        return None
    return len(t.ops) / t.calls
