"""Device ms a call of every operation launched inside the program's call
that is not a kernel of the program's own library (the model prep: P and
dP in float64 and their casts, the wrappers' sums and copies), from the
traced window."""


def read(run):
    t = run.trace
    if not t.calls:
        return None
    return 1e3 * t.device_s(span="call", library=False) / t.calls
