"""The share of the traced window in which the card was idle while the
host was inside the program's model prep, in %: the idle gaps (as
device_idle.py counts them) whose middle lies inside a `prep` span of the
program, its `host_sync` children included (portbench/program.py).  The
profiler's launch callbacks slow the host's enqueue, so this reads above
the untraced window's.  None where the program records no spans."""
from portbench import program


def read(run):
    p = program.of(run)
    if p is None or run.trace.window_s <= 0:
        return None
    return 100.0 * p.idle_within("prep") / run.trace.window_s
