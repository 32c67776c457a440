"""Host reads of device data a call, from the program's own counter:
`host_syncs` (bito_tpu_torch.utils.timing, counted at each point of a call
where the host reads from the card or waits on it), summed over each
call's spans, the mean over the traced window's calls (portbench/
program.py).  None where the program records no spans."""
from portbench import program


def read(run):
    p = program.of(run)
    if p is None or not p.calls:
        return None
    counts = p.counts("host_syncs")
    return sum(counts) / len(counts)
