"""python -m bito_tpu_torch.perflab [lab|pipe|static|chunk] [names ...]

Runs what bito_tpu's three perf-lab scripts ran, on the card, with the
scripts' own names:
  lab     scripts/perf_lab.py: base unroll resk4 resk8 nodot loop_resk4
  pipe    scripts/perf_pipe_lab.py: the nine experiments, or dma4d, or
          tiles (each experiment at every tile of the card's plan)
  static  scripts/perf_static_probe.py: the per-op slopes at every layout
          of the chain (1, 2, 4 warps a column), or sass (the SASS
          instructions of one chained op)
  chunk   scripts/perf_chunk_lab.py: v0 w2 w4 w8 norescale notips fixstore
          nodot unroll preponly fixedop (the chunked LL kernel's on-chip
          body with the script's knobs, evals/s at B = 200 x 40 calls)
It raises without a card.  The pipe cell and the chain are timed from the
device (perflab.graph_ms).  `python3 compare_first_design.py CHECKOUT`, at
the root of the repository, times both beside their first design, built
from another checkout's sources.
"""
import sys

from . import perf_chunk_lab, perf_lab, perf_pipe_lab, perf_static_probe

LABS = {"lab": perf_lab.main, "pipe": perf_pipe_lab.main,
        "static": perf_static_probe.main, "chunk": perf_chunk_lab.main}


def main(argv) -> None:
    if not argv or argv[0] not in LABS:
        raise SystemExit(__doc__)
    LABS[argv[0]](argv[1:])


if __name__ == "__main__":
    main(sys.argv[1:])
