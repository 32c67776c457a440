"""Launches of the checkpointed grad body a call, from the program's own
counter: `checkpoint_launches` (bito_tpu_torch.utils.timing, counted
inside the `launch` span by paired.paired_grad_ckpt, one a slice of
trees), summed over each call's spans, the mean over the traced window's
calls (portbench/program.py).  1.0 where the batch's device tier fits in
one slice.  None where the program records no spans or counts no such
launch in any call (a checkout without the counter, or a call that the
on-chip or global bodies take)."""
from portbench import program


def read(run):
    p = program.of(run)
    if p is None or not p.calls:
        return None
    counts = p.counts("checkpoint_launches")
    if not any(counts):
        return None
    return sum(counts) / len(counts)
