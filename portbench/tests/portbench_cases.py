"""Small cells for the CPU tests: the benchmark's own cells with their
sizes cut, so that the harness, the program (the engine in float64 on the
CPU, where it runs its plain versions) and the reference run in seconds."""
from __future__ import annotations

import contextlib
import time

import torch

from portbench import harness

SMALL = {"taxa": 7, "columns": 48, "distinct_columns": 30, "trees": 5}


def small_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    cell.config.update(SMALL,
                       topologies=min(cell.config["topologies"], 5))
    cell.traffic["warmup_calls"] = 2
    return cell


@contextlib.contextmanager
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def cpu_run(cell: harness.Cell, seed: int, seconds: float = 0.3,
            wrap=lambda fn: fn):
    """(Run, Sample) of the cell on the CPU in float64."""
    run, _, sample = harness.run_cell(
        cell, seed, seconds, False, t0=time.perf_counter(), device="cpu",
        dtype=torch.float64, wrap=wrap)
    return run, sample


def correct(cell: harness.Cell, run, sample) -> bool:
    checks = harness.check(cell.config, sample)
    line = harness.result(run, checks, {"platform": "cpu"}, cell.end_to_end)
    return line["correct"]
