"""The program's own spans and counters in the traced window, on the
trace's clock.

bito_tpu_torch.utils.timing records spans (`eval` around each public
evaluation, and its layers inside it) while a profiler session is active,
which in a run is the traced window alone: `timing.recorded()` gives
their name, id, parent, top span, start and end in
time.perf_counter_ns(), and their counts.  The harness's spans lie on the
same clock, mapped onto the trace by an offset that `trace.read` does not
keep; it is found again from the calls.  The k-th top `eval` record lies
inside the k-th harness `call` span, so

    max_k(call_start_us - 1e6 eval_start) <= offset
                                          <= min_k(call_end_us - 1e6 eval_end)

and the midpoint of the two bounds lies within half their width of the
offset.  `of(run)` is None, and every reader here returns None, where the
program records no spans (a checkout without the recorder), where the
counts of evals and calls differ, where the bounds cross or where their
half-width passes MAX_HALF_US.

Each top record belongs to the harness call that holds its start.  A
call's host time of a span name sums the spans of that name that lie in
no span of the same name; idle gaps of the card are named by the
innermost program span open at their middle, as trace.Trace.idle_by_span
names them by the harness's spans.
"""
from __future__ import annotations

import bisect
import collections
import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from . import trace as trace_mod

MAX_HALF_US = 10.0
TOP = "eval"   # the program's span around each evaluation
CALL = "call"  # the harness's span around each call


@dataclass
class Span:
    """A program span on the trace's clock (us)."""
    name: str
    id: int
    parent: Optional[int]
    top: int
    start: float
    end: float
    counts: Dict[str, int]


def bounds(calls: Sequence[Tuple[float, float]],
           evals: Sequence[Tuple[float, float]]
           ) -> Optional[Tuple[float, float]]:
    """(lo, hi) of the offset from the evals' clock (s) to the calls' (us),
    or None where their counts differ or there are none."""
    if not calls or len(calls) != len(evals):
        return None
    lo = max(c0 - 1e6 * e0 for (c0, _), (e0, _) in zip(calls, evals))
    hi = min(c1 - 1e6 * e1 for (_, c1), (_, e1) in zip(calls, evals))
    return lo, hi


def recorded() -> Optional[list]:
    """The program's records of its latest profiler session, or None where
    it keeps none."""
    try:
        from bito_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "recorded", None)
    return read() if callable(read) else None


class Program:
    """The program's spans of one traced window, mapped onto its clock."""

    def __init__(self, trace: trace_mod.Trace, spans: List[Span],
                 offset_us: float, half_width_us: float):
        self.trace, self.spans = trace, spans
        self.offset_us, self.half_width_us = offset_us, half_width_us
        self.by_id = {s.id: s for s in spans}
        self.children: Dict[Optional[int], List[Span]] = \
            collections.defaultdict(list)
        for s in spans:  # the records come oldest first
            self.children[s.parent].append(s)
        self.tops = self.children[None]
        self.top_starts = [s.start for s in self.tops]
        harness = [s for s in trace.spans.spans if s[0] == CALL]
        starts = [s[1] for s in harness]
        self.calls: List[List[Span]] = [[] for _ in harness]
        owner = {}
        for top in self.tops:
            k = bisect.bisect_right(starts, top.start) - 1
            if k >= 0 and top.start < harness[k][2]:
                owner[top.id] = k
        for s in spans:
            if s.top in owner:
                self.calls[owner[s.top]].append(s)

    def counts(self, counter: str) -> List[int]:
        """Each call's sum of `counter` over its spans."""
        return [sum(s.counts.get(counter, 0) for s in call)
                for call in self.calls]

    def _outermost(self, s: Span) -> bool:
        parent = self.by_id.get(s.parent)
        while parent is not None:
            if parent.name == s.name:
                return False
            parent = self.by_id.get(parent.parent)
        return True

    def host_s(self, name: str) -> List[float]:
        """Each call's host seconds inside spans named `name`."""
        return [sum(s.end - s.start for s in call
                    if s.name == name and self._outermost(s)) / 1e6
                for call in self.calls]

    def path_at(self, t: float) -> List[str]:
        """The names of the program spans open at `t` (us), outermost
        first."""
        path, level = [], self.tops
        starts = self.top_starts
        while True:
            i = bisect.bisect_right(starts, t) - 1
            if i < 0 or not t < level[i].end:
                return path
            path.append(level[i].name)
            level = self.children.get(level[i].id, [])
            starts = [s.start for s in level]

    def _gaps(self):
        t = self.trace
        for a, b in trace_mod.gaps_us([(op.start, op.end) for op in t.ops],
                                      t.start, t.end):
            yield (b - a) / 1e6, self.path_at((a + b) / 2)

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds of the window by the innermost program span at
        each gap's middle (trace.OUTSIDE outside them)."""
        out: Dict[str, float] = collections.defaultdict(float)
        for seconds, path in self._gaps():
            out[path[-1] if path else trace_mod.OUTSIDE] += seconds
        return dict(out)

    def idle_within(self, name: str) -> float:
        """Idle seconds of the window whose gap's middle lies inside a
        program span named `name`, or inside its children."""
        return sum(seconds for seconds, path in self._gaps() if name in path)


def read(trace: trace_mod.Trace, records) -> Optional[Program]:
    """The records on the trace's clock, or None (see the module's
    docstring)."""
    if not records:
        return None
    calls = [(a, b) for name, a, b in trace.spans.spans if name == CALL]
    evals = [(r.start / 1e9, r.end / 1e9) for r in records
             if r.parent is None and r.name == TOP]
    found = bounds(calls, evals)
    if found is None or found[0] > found[1]:
        return None
    lo, hi = found
    if (hi - lo) / 2 > MAX_HALF_US:
        return None
    offset = (lo + hi) / 2
    spans = [Span(r.name, r.id, r.parent, r.top, r.start / 1e3 + offset,
                  r.end / 1e3 + offset, dict(r.counts)) for r in records]
    return Program(trace, spans, offset, (hi - lo) / 2)


_last: list = [None, None]  # (the trace read last, its Program)


def of(run) -> Optional[Program]:
    """The program's spans of `run`'s traced window, read once a run."""
    if run.trace is None:
        return None
    if _last[0] is not run.trace:
        _last[:] = [run.trace, read(run.trace, recorded())]
    return _last[1]


def median_host_ms(run, name: str) -> Optional[float]:
    """Median over the traced window's calls of a call's host ms inside
    spans named `name`."""
    program = of(run)
    if program is None or not program.calls:
        return None
    return 1e3 * statistics.median(program.host_s(name))
