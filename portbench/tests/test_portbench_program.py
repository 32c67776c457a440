"""The program's spans on the traced window's clock (portbench/program.py):
the offset's bounds from the calls and their None cases, each call's
counts and host time, idle gaps by program span, the four readers, and
the program's own recorder against the harness's spans on the CPU."""
import collections
import math
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, inputs, program, trace
from portbench.tests.portbench_cases import one_thread, small_cell

Record = collections.namedtuple(
    "Record", "name id parent top start end counts")
OFFSET = 5000.0  # us: the trace's clock ahead of the host's


def _records():
    """Two calls, host clock in ns: each an eval over prep (with a
    host_sync inside), launch and two finishes."""
    out = []
    for k, t0 in enumerate((10_000, 110_000)):  # ns
        i = 7 * k
        out += [
            Record("eval", i, None, i, t0 + 1_000, t0 + 61_000, {}),
            Record("prep", i + 1, i, i, t0 + 2_000, t0 + 22_000, {}),
            Record("host_sync", i + 2, i + 1, i, t0 + 5_000, t0 + 15_000,
                   {"host_syncs": 2}),
            Record("launch", i + 3, i, i, t0 + 22_000, t0 + 42_000, {}),
            Record("finish", i + 4, i, i, t0 + 42_000, t0 + 50_000, {}),
            Record("finish", i + 5, i, i, t0 + 55_000, t0 + 60_000,
                   {"host_syncs": 1}),
            Record("prep", i + 6, i + 1, i, t0 + 16_000, t0 + 17_000, {}),
        ]
    return out


def _trace(ops=()):
    """The harness's call spans 10.5-71.5 and 110.5-171.5 us on the host
    clock, on the trace's clock OFFSET ahead; window 0-200 us host."""
    spans = [("bl_draw", 0.0, 10.5), ("call", 10.5, 71.5),
             ("call", 110.5, 171.5)]
    shifted = [(n, a + OFFSET, b + OFFSET) for n, a, b in spans]
    calls = sum(1 for s in spans if s[0] == "call")
    return trace.Trace(OFFSET, OFFSET + 200.0, calls,
                       [trace.DeviceOp("k", OFFSET + a, OFFSET + b, "kernel",
                                       "call", True) for a, b in ops],
                       trace.Spans(shifted))


def test_the_offset_lies_between_the_calls_bounds():
    lo, hi = program.bounds([(10.5, 71.5), (110.5, 171.5)],
                            [(11e-6, 71e-6), (111e-6, 171e-6)])
    assert (lo, hi) == (pytest.approx(-0.5), pytest.approx(0.5))
    p = program.read(_trace(), _records())
    assert p.offset_us == pytest.approx(OFFSET)
    assert p.half_width_us == pytest.approx(0.5)
    eval0 = p.spans[0]
    assert (eval0.start, eval0.end) == (pytest.approx(OFFSET + 11.0),
                                        pytest.approx(OFFSET + 71.0))


def test_the_offset_is_none_where_calls_and_evals_do_not_pair():
    records = _records()
    assert program.read(_trace(), records[:7]) is None       # counts differ
    assert program.read(_trace(), []) is None                 # none recorded
    assert program.bounds([], []) is None
    late = [r._replace(start=r.start + 200_000, end=r.end + 200_000)
            if r.top == 7 else r for r in records]
    assert program.read(_trace(), late) is None               # bounds cross
    wide = [r._replace(start=r.start + 15_000, end=r.end - 15_000)
            if r.name == "eval" else r for r in records]
    found = program.bounds([(10.5, 71.5), (110.5, 171.5)],
                           [(26e-6, 56e-6), (126e-6, 156e-6)])
    assert found[0] < found[1] and (found[1] - found[0]) / 2 > 10
    assert program.read(_trace(), wide) is None               # too wide


def test_each_calls_counts_and_host_time():
    p = program.read(_trace(), _records())
    assert [len(c) for c in p.calls] == [7, 7]
    assert p.counts("host_syncs") == [3, 3]
    assert p.counts("tape_builds") == [0, 0]
    # prep inside prep counts once; the two finishes add up
    assert p.host_s("prep") == [pytest.approx(20e-6)] * 2
    assert p.host_s("finish") == [pytest.approx(13e-6)] * 2
    assert p.host_s("launch") == [pytest.approx(20e-6)] * 2


BUSY = [(0, 14), (16, 26.2), (26.8, 28), (30, 35), (37, 69), (71, 200)]


def test_idle_gaps_are_named_by_the_innermost_program_span():
    """Device busy on the trace's clock everywhere but five gaps, whose
    middles fall in host_sync, the inner prep, the outer prep, launch and
    eval; then one gap outside the program's spans."""
    p = program.read(_trace(BUSY), _records())
    idle = p.idle_by_span()
    assert idle == {"host_sync": pytest.approx(2e-6),
                    "prep": pytest.approx(0.6e-6 + 2e-6),
                    "launch": pytest.approx(2e-6),
                    "eval": pytest.approx(2e-6)}
    assert p.path_at(OFFSET + 26.5) == ["eval", "prep", "prep"]
    assert p.path_at(OFFSET + 10) == []
    assert p.idle_within("prep") == pytest.approx(4.6e-6)
    assert p.idle_within("eval") == pytest.approx(8.6e-6)
    p = program.read(_trace([(0, 180)]), _records())
    assert p.idle_by_span() == {trace.OUTSIDE: pytest.approx(20e-6)}


def _run(tr):
    return types.SimpleNamespace(trace=tr)


@pytest.fixture
def recorded(monkeypatch):
    """program.recorded() returns what the test sets."""
    box = {"records": _records()}
    monkeypatch.setattr(program, "recorded", lambda: box["records"])
    monkeypatch.setattr(program, "_last", [None, None])
    return box


def test_the_four_readers(recorded):
    run = _run(_trace(BUSY))
    read = {m: harness.reader(m) for m in (
        "host_syncs.evals", "prep_idle.evals", "prep_host_ms.sync",
        "launch_host_ms.sync")}
    assert read["host_syncs.evals"](run) == 3.0
    assert read["prep_idle.evals"](run) == pytest.approx(100 * 4.6 / 200)
    assert read["prep_host_ms.sync"](run) == pytest.approx(0.020)
    assert read["launch_host_ms.sync"](run) == pytest.approx(0.020)
    device_idle = harness.reader("device_idle.evals")(run)
    assert read["prep_idle.evals"](run) <= device_idle


@pytest.mark.parametrize("case", ["none", "empty", "no recorder"])
def test_the_readers_return_none_without_the_programs_records(
        monkeypatch, case):
    """A program that records nothing, or has no recorder (an older
    checkout of it), gives no value and no error."""
    monkeypatch.setattr(program, "_last", [None, None])
    if case == "no recorder":
        from bito_tpu_torch.utils import timing
        monkeypatch.delattr(timing, "recorded")
        assert program.recorded() is None
    else:
        monkeypatch.setattr(program, "recorded",
                            lambda: None if case == "none" else [])
    run = _run(_trace([(0, 100)]))
    for m in ("host_syncs.evals", "prep_idle.evals", "prep_host_ms.sync",
              "launch_host_ms.sync"):
        assert harness.reader(m)(run) is None
    assert program.of(types.SimpleNamespace(trace=None)) is None


def test_the_programs_records_pair_with_the_harness_calls_on_the_cpu(
        monkeypatch):
    """The engine's closure under a CPU profiler session, driven by the
    harness's loop with its spans: the offset found from the calls is the
    clocks' own (0 here, both on time.perf_counter) within its bound.
    (The bound's limit is the card host's: a loaded CPU runs past it.)"""
    monkeypatch.setattr(program, "MAX_HALF_US", math.inf)
    cell = small_cell("ds1_mg94.stream")
    config = cell.config
    inp = inputs.make_inputs(config, 5, harness.batch_of(cell), None)
    with one_thread():
        prog = harness.Program(config, inp, "branch_eval", True, "cpu",
                               torch.float64)
        base = torch.as_tensor(inp.trees.lengths, dtype=torch.float64)
        traffic = harness.Traffic(harness.Draws(base, 0.1, 7), None, 1,
                                  False, harness.batch_of(cell))
        spans = harness.HostSpans()
        with profile(activities=[ProfilerActivity.CPU]):
            win = harness.drive(prog.step, traffic, calls=4, spans=spans,
                                sync=lambda: None)
    host = trace.Spans([(n, 1e6 * a, 1e6 * b) for n, a, b in spans.spans])
    tr = trace.Trace(1e6 * win.start, 1e6 * win.end, 4, [], host)
    p = program.read(tr, program.recorded())
    assert p is not None and abs(p.offset_us) <= p.half_width_us
    # the scan tape (the CPU's route) builds P and dP apart, each reading
    # the largest q t and q and copying q back
    assert p.counts("host_syncs") == [6] * 4
    assert all(h > 0 for h in p.host_s("launch") + p.host_s("finish"))
    assert sum(p.host_s("eval")) < 1e-6 * (tr.end - tr.start)
