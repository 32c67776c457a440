"""The device side of a traced window, from torch.profiler's Chrome trace.

The profiler records the card's activity alone (kernels, memcpys, memsets,
and the host's CUDA launch calls): recording every torch operator on the
host as well doubled the host's time a call and left the card idle for
it.  The harness keeps its own spans (`call`, `bl_draw`, `read_back`) on
its clock and brackets two marker launches with it, one before the window
and one after: matching those to the trace's first and last launch gives
the offset between the two clocks.  A device operation is tied by its
correlation id to the launch that issued it; the launch's time places it
in a harness span ("harness" outside them).  A kernel whose name is one of
the program library's (`library_kernels`: the kernels of
bito_tpu_torch/treelike/csrc) is a tree kernel.  Idle gaps are the window's
time outside the union of the device operations, named by the span the
host was in at the gap's middle.

The union arithmetic is a copy of profile_main_path.py's `union_us`
(lines 45-53); the window is the harness's own, not the span from the
first to the last device event.
"""
from __future__ import annotations

import bisect
import collections
import importlib.util
import json
import os
import re
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
OUTSIDE = "harness"
UNPLACED = "unplaced"  # an op whose launch event the trace lacks
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\("
                     r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")


def library_kernels() -> frozenset:
    """Names of the `__global__` functions of the program's tree kernels."""
    spec = importlib.util.find_spec("bito_tpu_torch")
    csrc = Path(spec.submodule_search_locations[0]) / "treelike" / "csrc"
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(path.read_text()))
    return frozenset(names)


def base_name(kernel: str) -> str:
    """A kernel's function name without its namespaces, template
    arguments and parameters."""
    head = re.split(r"[<(]", kernel.replace("(anonymous namespace)::", ""),
                    maxsplit=1)[0].split()
    return head[-1].split("::")[-1] if head else kernel


def union_us(intervals) -> float:
    """Total length of the union of [start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def gaps_us(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi) that no interval covers."""
    out, reach = [], lo
    for start, end in sorted(intervals):
        if start > reach:
            out.append((reach, min(start, hi)))
        reach = max(reach, end)
        if reach >= hi:
            break
    if reach < hi:
        out.append((reach, hi))
    return [(a, b) for a, b in out if b > a]


class Spans:
    """Sorted, non-overlapping host spans: which one holds a time."""

    def __init__(self, spans: Sequence[Tuple[str, float, float]]):
        self.spans = sorted(spans, key=lambda s: s[1])
        self.starts = [s[1] for s in self.spans]

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.spans[i][2]:
            return self.spans[i][0]
        return None


@dataclass
class DeviceOp:
    name: str
    start: float  # microseconds, the trace's clock
    end: float
    kind: str     # one of DEVICE_CATEGORIES
    span: str     # the harness span the launch fell in
    library: bool  # one of the program library's tree kernels


@dataclass
class Trace:
    """One traced window: its bounds (us), the calls in it, its device
    operations clipped to it, and the harness's host spans."""
    start: float
    end: float
    calls: int
    ops: List[DeviceOp]
    spans: Spans

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us((op.start, op.end) for op in self.ops) / 1e6

    def device_s(self, span: Optional[str] = None,
                 library: Optional[bool] = None) -> float:
        """Summed device seconds of the ops launched in `span` (any where
        None) that are (or are not) the program library's kernels."""
        return sum(op.end - op.start for op in self.ops
                   if (span is None or op.span == span)
                   and (library is None or op.library == library)) / 1e6

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds of the window by the host span at each gap."""
        out: Dict[str, float] = collections.defaultdict(float)
        for a, b in gaps_us([(op.start, op.end) for op in self.ops],
                            self.start, self.end):
            out[self.spans.at((a + b) / 2) or OUTSIDE] += (b - a) / 1e6
        return dict(out)

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        by_name: Dict[str, float] = collections.defaultdict(float)
        for op in self.ops:
            by_name[op.name[:120]] += (op.end - op.start) / 1e6
        return sorted(by_name.items(), key=lambda kv: -kv[1])[:n]


def parse(events: list, spans: Sequence[Tuple[str, float, float]],
          window: Tuple[float, float],
          anchors: Sequence[Tuple[float, float]],
          kernels: frozenset) -> Trace:
    """A Trace from the Chrome trace's events and the harness's clock:
    `spans` [(name, start, end)] and `window` (start, end) in seconds, and
    `anchors`, the (before, after) times of the two marker launches."""
    launches, device = {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATEGORIES and corr is not None:
            launches[corr] = float(e["ts"]) + float(e.get("dur", 0.0)) / 2
        elif e.get("cat") in DEVICE_CATEGORIES:
            device.append(e)
    marked = sorted(launches[e["args"]["correlation"]] for e in device
                    if e["cat"] == "kernel"
                    and e.get("args", {}).get("correlation") in launches)
    if len(marked) < 2:
        raise RuntimeError("the trace holds fewer than two kernel launches")
    offset = sum(t - 1e6 * (a + b) / 2 for t, (a, b) in
                 zip((marked[0], marked[-1]), anchors)) / 2

    def us(t: float) -> float:
        return 1e6 * t + offset

    lo, hi = us(window[0]), us(window[1])
    host = Spans([(name, us(a), us(b)) for name, a, b in spans])
    ops = []
    for e in device:
        ts = float(e["ts"])
        start, end = max(ts, lo), min(ts + float(e.get("dur", 0.0)), hi)
        if end <= start:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        ops.append(DeviceOp(
            e.get("name", ""), start, end, e["cat"],
            UNPLACED if launch is None else (host.at(launch) or OUTSIDE),
            e["cat"] == "kernel" and base_name(e.get("name", "")) in kernels))
    calls = sum(1 for s in host.spans if s[0] == "call")
    return Trace(lo, hi, calls, ops, host)


def read(prof, spans, window, anchors) -> Trace:
    """Export a finished torch.profiler session to a temporary file (under
    TMPDIR), parse it with the harness's spans and delete the file."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return parse(events, spans, window, anchors, library_kernels())
