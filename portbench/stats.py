"""Percentiles of a run's samples, and the spread of a set of runs.

    python3 -m portbench.stats FILE [FILE ...]

reads the result lines (the JSON objects a run prints last) in each file,
one file a set of runs of one cell, and prints every metric's median and
spread: the distance between the first and third quartiles as Python's
statistics.quantiles(values, n=4) gives them, as a share of the median.
"""
from __future__ import annotations

import json
import math
import statistics
import sys
from typing import Dict, List, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile: the least value with at least q%
    of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median."""
    q1, median, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / median


def result_lines(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{") and '"metrics"' in line:
                out.append(json.loads(line))
    return out


def summary(runs: List[dict]) -> Dict[str, tuple]:
    """{metric: (median, spread, runs)} over the runs' result lines."""
    by_metric: Dict[str, List[float]] = {}
    for run in runs:
        for name, m in run["metrics"].items():
            by_metric.setdefault(name, []).append(m["value"])
    return {name: (statistics.median(v),
                   spread(v) if len(v) >= 2 else float("nan"), len(v))
            for name, v in by_metric.items()}


def main(paths: Sequence[str]) -> None:
    for path in paths:
        runs = result_lines(path)
        print(f"{path}: {len(runs)} runs, correct "
              f"{sum(r['correct'] for r in runs)}")
        for name, (median, sp, n) in sorted(summary(runs).items()):
            print(f"  {name}: median {median!r} spread {sp:.4%} ({n} runs)")


if __name__ == "__main__":
    main(sys.argv[1:])
