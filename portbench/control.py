"""The readings that the limits of the check are set from, on the card.

    python3 -m portbench.control --workload <name> --seconds <s> SEED [SEED ...]

For each seed, in one process: the cell's set-up, a window of `--seconds`
at the cell's own traffic, then the check's numbers twice over the same
kept calls: the program's (the lower readings) and the control's, the
reference itself in float32 with every product's operands rounded to TF32
in the program's place (the upper readings).  It prints one JSON line a
seed and last the largest program reading and the smallest control
reading of each number.  The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import harness
from .run import fix_caches


def readings(cell, seed: int, seconds: float) -> dict:
    t0 = time.perf_counter()
    run, _, sample = harness.run_cell(cell, seed, seconds, False, t0=t0)
    return {"seed": seed, "calls": run.window.calls,
            "checked": len(sample.keeper.states),
            "program": harness.check(cell.config, sample),
            "control": harness.check(cell.config, sample, control=True)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("seeds", type=int, nargs="+")
    args = parser.parse_args(argv)
    fix_caches()
    if not torch.cuda.is_available():
        print("portbench.control runs on the card only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    rows = []
    for seed in args.seeds:
        rows.append(readings(cell, seed, args.seconds))
        print(json.dumps(rows[-1]), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    names = rows[0]["program"]
    print(json.dumps({
        "workload": args.workload, "seeds": len(rows),
        "lower": {k: max(r["program"][k] for r in rows) for k in names},
        "upper": {k: min(r["control"][k] for r in rows) for k in names},
        "limits": cell.config["limits"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
