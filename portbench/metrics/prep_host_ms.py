"""Median host ms of a call inside the program's `prep` spans (P and dP
from the model ingredients, their casts, and the host reads among them),
over the traced window's calls (portbench/program.py).  The profiler's
launch callbacks slow the host in the traced window, so this reads above
an untraced call's.  None where the program records no spans."""
from portbench import program


def read(run):
    return program.median_host_ms(run, "prep")
