"""Launches of the tree kernels' global bodies a call, from the program's
own counter: `global_launches` (bito_tpu_torch.utils.timing, counted
inside the `launch` span by each global-body launcher, one a slice of
trees), summed over each call's spans, the mean over the traced window's
calls (portbench/program.py).  1.0 where the batch's scratch fits in one
slice, 0 where the on-chip bodies take the call.  None where the program
records no spans or counts no global launch in any call (a checkout
without the counter)."""
from portbench import program


def read(run):
    p = program.of(run)
    if p is None or not p.calls:
        return None
    counts = p.counts("global_launches")
    if not any(counts):
        return None
    return sum(counts) / len(counts)
