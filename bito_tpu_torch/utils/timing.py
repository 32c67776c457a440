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

The program's spans and counters (`span`, `count`, `recorded`) mark the
layers of an evaluation inside the package: `eval` around each public
evaluation, and inside it `bind`, `encode`, `tapes`, `ingredients`,
`prep`, `host_sync`, `launch` and `finish`; the counters `tape_builds`,
`host_syncs`, `prep_launches`, `global_launches` and
`checkpoint_launches`.  They record
exactly while a torch.profiler session is active
(torch.autograd.profiler._is_profiler_enabled, the flag torch keeps for
fast Python checks), in memory, on time.perf_counter_ns(), the clock of
time.perf_counter.  Outside a session a span site costs one
read of that flag and returns a shared null context.  A session's start
drops the previous session's records, so they hold one session at most;
device_trace writes them into its trace.  Nothing here launches work on
the card or reads from it.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, NamedTuple, Optional

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
    (trace.json, viewable in Perfetto), with the program's spans of the
    session as complete events of a process named bito_tpu_torch, their
    counts in `args`.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _export_spans(path)


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


# -- the program's spans and counters ---------------------------------------

_profiler = torch.autograd.profiler
_OFF = contextlib.nullcontext()
SPAN_PID = 1 << 30  # the exported spans' process id in a trace


class Record(NamedTuple):
    """One finished span: times in time.perf_counter_ns(); `parent` is
    None for a top span, and `top` is the id of the outermost span that
    was open, so every span of one call shares it."""
    name: str
    id: int
    parent: Optional[int]
    top: int
    start: int
    end: int
    counts: Dict[str, int]


def _anchor():
    """A (perf_counter_ns, time_ns) pair read at one instant: of a few
    wall-clock reads, the one bracketed most tightly by two perf_counter
    reads, whose midpoint it is paired with."""
    brackets = []
    for _ in range(5):
        before = time.perf_counter_ns()
        wall = time.time_ns()
        after = time.perf_counter_ns()
        brackets.append((after - before, (before + after) // 2, wall))
    return min(brackets)[1:]


class _Session:
    """The spans of one profiler session, and an _anchor() read at its
    start: the map from the spans' clock to the trace's wall clock."""

    def __init__(self):
        self.spans: List[_Span] = []
        self.open: List[_Span] = []
        self.anchor = _anchor()


class _Span:
    __slots__ = ("name", "id", "parent", "top", "start", "end", "counts")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        session = _session
        outer = session.open[-1] if session.open else None
        self.id = len(session.spans)
        self.parent = None if outer is None else outer.id
        self.top = self.id if outer is None else outer.top
        self.counts = {}
        self.end = None
        session.spans.append(self)
        session.open.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if _session.open and _session.open[-1] is self:
            _session.open.pop()
        return False


_session = _Session()


def _start_session(start=_profiler._run_on_profiler_start):
    """torch's own start hook, then a fresh record of spans."""
    global _session
    start()
    _session = _Session()


# Every torch.profiler session calls this module function of torch's as it
# starts (autograd.profiler.profile._start_trace).
_profiler._run_on_profiler_start = _start_session


def span(name: str, outermost: bool = False):
    """A context manager that records the span `name` while a profiler
    session is active; with `outermost`, only where no span is open."""
    if not _profiler._is_profiler_enabled or (outermost and _session.open):
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of the innermost open span, while a
    profiler session is active."""
    if _profiler._is_profiler_enabled and _session.open:
        counts = _session.open[-1].counts
        counts[name] = counts.get(name, 0) + n


def recorded() -> List[Record]:
    """The finished spans of the latest profiler session, oldest first."""
    return [Record(s.name, s.id, s.parent, s.top, s.start, s.end,
                   dict(s.counts))
            for s in _session.spans if s.end is not None]


def _export_spans(path: str) -> None:
    """Add the session's spans to the Chrome trace at `path`, on its
    clock: `ts` in microseconds past its baseTimeNanoseconds on the wall
    clock, which the session's anchor maps the spans onto."""
    with open(path) as f:
        trace = json.load(f)
    perf, wall = _session.anchor
    shift = wall - perf - int(trace.get("baseTimeNanoseconds", 0))
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": SPAN_PID,
                   "tid": 0, "args": {"name": "bito_tpu_torch"}})
    for r in recorded():
        events.append({
            "ph": "X", "cat": "bito_tpu_torch", "name": r.name,
            "pid": SPAN_PID, "tid": 0, "ts": (r.start + shift) / 1e3,
            "dur": (r.end - r.start) / 1e3,
            "args": {"id": r.id, "parent": r.parent, "top": r.top,
                     **r.counts}})
    with open(path, "w") as f:
        json.dump(trace, f)
