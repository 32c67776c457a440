"""Stopwatch, phase timer, progress bar and the card's profiling hooks.

Port of bito_tpu.utils.timing (a rebuild of the reference Stopwatch and
ProgressBar, src/stopwatch.hpp:3-12, src/ProgressBar.hpp:9-66, with laps
as in src/nni_engine.cpp:230-257).  Stopwatch, PhaseTimer and ProgressBar
are bito_tpu's host code, copied.  The device hooks are torch's:
device_trace records a torch.profiler trace of the host and the card and
writes it as a Chrome trace, and block_until_ready synchronises the card
of every tensor in a tree.

PhaseTimer reads the host clock only, as bito_tpu's does: the card runs
behind the host, so a phase that launches work on it is charged when a
later phase waits for that work.  To charge each phase its own device
work, synchronise at its edges (chip_smoke.py's SyncedPhases does).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


class Stopwatch:
    """Lap/total timer (reference Stopwatch semantics)."""

    def __init__(self, start: bool = True):
        self._start: Optional[float] = None
        self._laps: List[float] = []
        self._last: Optional[float] = None
        if start:
            self.start()

    def start(self):
        self._start = self._last = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        assert self._last is not None, "Stopwatch not started"
        lap = now - self._last
        self._laps.append(lap)
        self._last = now
        return lap

    def stop(self) -> float:
        return self.lap()

    def total(self) -> float:
        assert self._start is not None
        return time.perf_counter() - self._start

    @property
    def laps(self) -> List[float]:
        return list(self._laps)


class PhaseTimer:
    """Named-phase accumulator for engine loops (the NNI engine's per-stage
    lap report, reference src/nni_engine.cpp:230-257)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = ["# Timing Report"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name}: {total:.3f}s over {self.counts[name]} calls"
            )
        return "\n".join(lines)


class ProgressBar:
    """Terminal progress bar (reference src/ProgressBar.hpp:9-66, used by
    GenericSBNInstance's bulk loops): `bar = ProgressBar(total)`, `next()`
    or `+= 1` per tick, `display()` to redraw in place, `done()` to finish
    the line."""

    def __init__(self, total: int, width: int = 70,
                 complete: str = "=", incomplete: str = " "):
        self.total = max(int(total), 1)
        self.width = width
        self.complete_char = complete
        self.incomplete_char = incomplete
        self.ticks = 0
        self._start = time.perf_counter()

    def __iadd__(self, n: int) -> "ProgressBar":
        self.ticks += n
        return self

    def next(self) -> int:
        self.ticks += 1
        return self.ticks

    def seconds_elapsed(self) -> float:
        return time.perf_counter() - self._start

    def display(self, show_hours: bool = False, stream=None) -> None:
        import sys

        stream = stream or sys.stdout
        progress = self.ticks / self.total
        pos = int(self.width * progress)
        bar = "".join(
            self.complete_char if i < pos else
            (">" if i == pos else self.incomplete_char)
            for i in range(self.width)
        )
        secs = self.seconds_elapsed()
        tail = (f"s {secs / 60.0:.2f}m {secs / 3600.0:.4f}h"
                if show_hours else "s")
        stream.write(f"[{bar}] {int(progress * 100)}% {secs:.1f}{tail}\r")
        stream.flush()

    def done(self, stream=None) -> None:
        import sys

        stream = stream or sys.stdout
        self.display(stream=stream)
        stream.write("\n")
        stream.flush()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a torch.profiler trace of the host and, where a card is
    visible, the card, and write it to `log_dir` as a Chrome trace
    (trace.json, viewable in Perfetto).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def block_until_ready(tree):
    """Wait for the card's work on every tensor in `tree` (nested lists,
    tuples and dict values) and return the tree: a barrier for timing
    device work.  Tensors on the CPU need no wait."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(tree)
    for device in devices:
        torch.cuda.synchronize(device)
    return tree
