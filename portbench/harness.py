"""One run of one cell: set-up, the measured window, the check, the result.

A cell of BENCHMARK.json names a configuration (`configs/<name>.json`: the
sizes, the model and its parameters, the peak, the limits of the check)
and a traffic mix (`traffic/<name>.json`: data that the one generator here
reads).  The mix's `call` names the program's entry point that each call
drives (`calls/<call>.py`: `bind(engine, trees, params)` and `GRADIENTS`).
Every metric is read by `metrics/<name>.py`, or, for a name split by
cells as `<base>.<part>`, by `metrics/<base>.py`.  All are found by name,
so a configuration, a mix, an entry point or a metric is added with files
and entries alone.

The generator is a closed loop with one caller.  Each call
- draws its trees: the batch every call (the configuration's `trees`,
  times the mix's `repeat`, its topologies cycled), or with
  `topology_pool` that many distinct topologies out of a pool of that
  many made from the seed, the entry point bound anew to them;
- draws fresh branch lengths for them on the card: the trees' own lengths
  times exp(`bl_log_sd` z), z from a generator seeded by the run's seed;
- calls the entry point;
- reads back: every `read_every`-th call the batch's LL sum ("ll_sum"),
  or every call all that the call returned ("outputs").
A reservoir drawn from the seed keeps `checked_calls` calls of the window
(the generator's state before the draw, the trees, and the outputs); once
the window has closed their branch lengths are drawn again and the
reference (portbench/reference) evaluates them in float64.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import inputs, reference, trace
from .reference import patterns

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# Top-level module names that the process must not hold once the window
# has closed: the JAX stack and the JAX package beside the port.
BANNED = ("jax", "jaxlib", "flax", "bito_tpu")
TRACE_SECONDS = 2.0  # the traced window after the measured one
RESERVOIR_CHUNK = 1 << 16


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, bench_path: Path = REPO / "BENCHMARK.json") -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration, its traffic
    mix and the metrics it reports."""
    with open(bench_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {bench_path.name}; "
                         f"there are {sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(REPO / entry["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(name, w["chips"], config, traffic, e2e, per_layer)


def _module(path: Path, prefix: str):
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str) -> Callable:
    """`read(run)` of metrics/<metric>.py, or of metrics/<base>.py where
    the metric is `<base>.<part>` and has no file of its own."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    return _module(path, "portbench_metric_").read


def entry_point(call: str):
    """The module calls/<call>.py."""
    return _module(HERE / "calls" / f"{call}.py", "portbench_call_")


# -- the system under test -------------------------------------------------

class Program:
    """The engine (kernel "auto") over the configuration's alignment and
    model, and the mix's entry point bound to the batch of trees: `step(bl,
    pick)` is one call, over the trees `pick` of the pool, or over the
    batch where `pick` is None."""

    def __init__(self, config: dict, inp: inputs.CellInputs, call: str,
                 fixed: bool, device, dtype):
        from bito_tpu_torch.core.site_pattern import (CodonSitePattern,
                                                      SitePattern)
        from bito_tpu_torch.core.tree import Topology, Tree
        from bito_tpu_torch.models.phylo_model import (
            PhyloModel, PhyloModelSpecification)
        from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

        pattern_class = {"nucleotide": SitePattern,
                         "codon": CodonSitePattern}[config["alphabet"]]
        sp = pattern_class(inp.alignment, inp.names)
        spec = config["model"]
        model = PhyloModel(PhyloModelSpecification(
            spec["substitution"], spec["site"], spec.get("clock", "none")))
        self.engine = TreeLikelihoodEngine(sp, model, device=device,
                                           dtype=dtype)
        self.engine.kernel = "auto"
        self.patterns = sp.pattern_count
        self.call = entry_point(call)
        T = inp.trees.taxa
        self.trees = [Tree(Topology(p, T), t)
                      for p, t in zip(inp.trees.parents, inp.trees.lengths)]
        self.params = {k: torch.as_tensor(np.asarray(v, dtype=np.float64),
                                          device=device)
                       for k, v in config["params"].items()}
        self.bound = (self.call.bind(self.engine, self.trees, self.params)
                      if fixed else None)

    def step(self, bl: torch.Tensor, pick: Optional[np.ndarray]):
        if pick is None:
            return self.bound(bl)
        trees = [self.trees[i] for i in pick]
        return self.call.bind(self.engine, trees, self.params)(bl)


# -- the traffic -------------------------------------------------------------

class Draws:
    """Branch lengths of one call: base * exp(sd * z), z standard normal
    from a generator on the device seeded by the run's seed; base is the
    trees' own lengths, of the batch or of the pool's picked rows."""

    def __init__(self, base: torch.Tensor, sd: float, seed: int):
        self.base, self.sd = base, sd
        self.gen = torch.Generator(device=base.device)
        self.gen.manual_seed(seed)

    def draw(self, pick: Optional[np.ndarray] = None) -> torch.Tensor:
        base = self.base
        if pick is not None:
            base = base[torch.as_tensor(pick, device=base.device)]
        z = torch.randn(base.shape, generator=self.gen, device=base.device,
                        dtype=base.dtype)
        return z.mul_(self.sd).exp_().mul_(base)

    def again(self, state: torch.Tensor,
              pick: Optional[np.ndarray] = None) -> torch.Tensor:
        """The draw made from generator state `state`."""
        self.gen.set_state(state)
        return self.draw(pick)


class Picks:
    """Each call's `batch` distinct rows of a pool of `pool` topologies,
    drawn on the host from the seed."""

    def __init__(self, pool: int, batch: int, seed: int):
        self.pool, self.batch = pool, batch
        self.rng = np.random.default_rng(seed)

    def next(self) -> np.ndarray:
        return self.rng.choice(self.pool, size=self.batch, replace=False)


class Keeper:
    """A uniform sample of `k` calls of the window, drawn from the seed
    (reservoir sampling): each kept call's generator state, trees and
    outputs."""

    def __init__(self, k: int, seed: int, host: bool, shape, gradients: bool,
                 device, dtype):
        self.k, self.seen = k, 0
        self.rng = np.random.default_rng(seed)
        self.u = self.rng.random(RESERVOIR_CHUNK)
        self.host = host
        self.states: Dict[int, torch.Tensor] = {}
        self.picks: Dict[int, Optional[np.ndarray]] = {}
        B, N = shape
        self.ll: Dict[int, torch.Tensor] = {}
        self.grads: Dict[int, Optional[torch.Tensor]] = {}
        if not host:
            self.ll_buf = torch.empty((k, B), device=device, dtype=dtype)
            self.grads_buf = (torch.empty((k, B, N), device=device,
                                          dtype=dtype) if gradients else None)

    def offer(self) -> Optional[int]:
        """The slot of the next call, or None where it is not kept."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            return i
        if i % RESERVOIR_CHUNK == 0:
            self.u = self.rng.random(RESERVOIR_CHUNK)
        j = int(self.u[i % RESERVOIR_CHUNK] * (i + 1))
        return j if j < self.k else None

    def keep(self, slot: int, state, pick, ll, grads) -> None:
        self.states[slot], self.picks[slot] = state, pick
        if self.host:
            self.ll[slot], self.grads[slot] = ll, grads
        else:
            self.ll[slot] = self.ll_buf[slot].copy_(ll)
            self.grads[slot] = (None if grads is None
                                else self.grads_buf[slot].copy_(grads))


class HostSpans:
    """The harness's spans on its own clock: [(name, start, end)]."""

    def __init__(self):
        self.spans = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, start, time.perf_counter()))


@dataclass
class Window:
    """What the host clock saw of one window: from before the first draw
    to the return of the wait for the device after the last call."""
    start: float = 0.0
    end: float = 0.0
    seconds: float = 0.0
    calls: int = 0
    failed: int = 0
    call_s: List[float] = field(default_factory=list)
    latency_s: List[float] = field(default_factory=list)


@dataclass
class Traffic:
    """The per-call step of a mix: its draws, its picks (None for the
    fixed batch) and its read-back."""
    draws: Draws
    picks: Optional[Picks]
    read_every: int
    outputs: bool  # every call's outputs to the host, else the LL sum
    batch: int


def drive(fn, traffic: Traffic, *, seconds=None, calls=None,
          keeper: Optional[Keeper] = None, spans=None,
          sync=torch.cuda.synchronize) -> Window:
    """Run the closed loop for `seconds` (or `calls` calls), then wait for
    the device.  `fn(bl, pick)` is the call; `spans(name)` marks the
    harness's spans."""
    spans = spans or (lambda name: contextlib.nullcontext())
    draws, picks = traffic.draws, traffic.picks
    win = Window()
    clock = time.perf_counter
    win.start = clock()
    t_stop = win.start + (seconds if seconds is not None else math.inf)
    while True:
        slot = keeper.offer() if keeper is not None else None
        with spans("bl_draw"):
            pick = picks.next() if picks is not None else None
            state = draws.gen.get_state() if slot is not None else None
            bl = draws.draw(pick)
        with spans("call"):
            t0 = clock()
            ll, grads = fn(bl, pick)
            t1 = clock()
        win.call_s.append(t1 - t0)
        if traffic.outputs:
            with spans("read_back"):
                ll = ll.cpu()
                grads = grads.cpu() if grads is not None else None
            win.latency_s.append(clock() - t0)
            if not bool(torch.isfinite(ll).all()):
                win.failed += traffic.batch
        if slot is not None:
            keeper.keep(slot, state, pick, ll, grads)
        win.calls += 1
        if not traffic.outputs and win.calls % traffic.read_every == 0:
            with spans("read_back"):
                total = float(ll.sum())
            if not math.isfinite(total):
                win.failed += traffic.batch
        if clock() >= t_stop or (calls is not None and win.calls >= calls):
            break
    sync()
    win.end = clock()
    win.seconds = win.end - win.start
    return win


# -- the check -------------------------------------------------------------

@dataclass
class Sample:
    """The kept calls of a window, and what draws their inputs again."""
    inp: inputs.CellInputs
    draws: Draws
    keeper: Keeper


def check(config: dict, sample: Sample,
          control: bool = False) -> Dict[str, float]:
    """The largest gaps of the kept calls' outputs from the reference:
    ll_err, |ll - ref| / |ref| over trees, and, where the call returns
    gradients, grad_err, each tree's largest gradient gap over its largest
    reference gradient.  With `control` the reference in TF32 takes the
    program's place."""
    inp, draws, keeper = sample.inp, sample.draws, sample.keeper
    model = reference.model_of(config)
    tips, w = patterns.site_patterns(inp.alignment, inp.names,
                                     config["alphabet"])
    errs: Dict[str, float] = {}

    def worst(key, e):
        errs[key] = max(errs.get(key, 0.0), e if math.isfinite(e)
                        else math.inf)

    for slot in sorted(keeper.states):
        pick = keeper.picks[slot]
        bl = draws.again(keeper.states[slot], pick)
        parents = (inp.trees.parents if pick is None
                   else inp.trees.parents[pick])
        ref_ll, ref_g = reference.evaluate(model, tips, w, parents, bl)
        if control:
            ll, g = reference.evaluate(model, tips, w, parents, bl,
                                       control=True)
            if keeper.grads[slot] is None:
                g = None
        else:
            ll = keeper.ll[slot].to(ref_ll.device, torch.float64)
            g = keeper.grads[slot]
            g = None if g is None else g.to(ref_ll.device, torch.float64)
        worst("ll_err", float(((ll - ref_ll).abs() / ref_ll.abs()).max()))
        if g is not None:
            worst("grad_err", float(((g - ref_g).abs().amax(1)
                                     / ref_g.abs().amax(1)).max()))
    return errs


def banned_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(BANNED))


# -- a run -------------------------------------------------------------------

@dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    patterns: int
    gradients: bool  # whether a call returns branch gradients
    setup_s: float
    setup_phases: Dict[str, float]
    window: Window
    trace: Optional[trace.Trace] = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def batch(self) -> int:
        return batch_of(self.cell)

    @property
    def evals(self) -> int:
        return self.window.calls * self.batch


def batch_of(cell: Cell) -> int:
    """Trees a call: the configuration's, times the mix's `repeat`."""
    return cell.config["trees"] * int(cell.traffic.get("repeat", 1))


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, *,
             t0: float, device="cuda", dtype=torch.float32,
             wrap: Callable = lambda fn: fn):
    """Set up, warm up, measure: (Run, memory peak, Sample), the program
    freed.  `wrap` wraps the call fn(bl, pick) (the tests break it
    there)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    config, mix = cell.config, cell.traffic
    seed = seed % (1 << 62)
    phases = {"start": time.perf_counter() - t0}
    if mix["read_back"] not in ("ll_sum", "outputs"):
        raise ValueError(f"read_back {mix['read_back']!r}: 'll_sum' or "
                         f"'outputs'")
    pool = mix.get("topology_pool")
    B = batch_of(cell)
    inp = inputs.make_inputs(config, seed, B, pool)
    phases["inputs"] = time.perf_counter() - t0 - sum(phases.values())
    program = Program(config, inp, mix["call"], pool is None, device, dtype)
    fn = wrap(program.step)
    phases["program"] = time.perf_counter() - t0 - sum(phases.values())
    base = torch.as_tensor(inp.trees.lengths, device=device, dtype=dtype)
    traffic = Traffic(
        Draws(base, float(mix["bl_log_sd"]), seed + 2),
        None if pool is None else Picks(int(pool), B, seed + 4),
        int(mix["read_every"]), mix["read_back"] == "outputs", B)
    drive(fn, traffic, calls=int(mix["warmup_calls"]), sync=sync)
    keeper = Keeper(int(mix["checked_calls"]), seed + 3, traffic.outputs,
                    (B, base.shape[1]), program.call.GRADIENTS, device,
                    dtype)
    gc.collect()
    gc.freeze()
    phases["warmup"] = time.perf_counter() - t0 - sum(phases.values())
    setup_s = time.perf_counter() - t0
    window = drive(fn, traffic, seconds=seconds, keeper=keeper, sync=sync)
    run = Run(cell, program.patterns, program.call.GRADIENTS, setup_s,
              phases, window)
    if traced:
        run.trace = traced_window(fn, traffic, sync)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del fn, program
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return run, peak, Sample(inp, traffic.draws, keeper)


def traced_window(fn, traffic: Traffic, sync):
    """TRACE_SECONDS of the same loop under torch.profiler, recording the
    card's activity only, between two marker launches on the host clock."""
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device=traffic.draws.base.device)
    spans, anchors = HostSpans(), []

    def mark():
        before = time.perf_counter()
        marker.add_(1.0)
        anchors.append((before, time.perf_counter()))

    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mark()
        sync()
        win = drive(fn, traffic, seconds=TRACE_SECONDS, spans=spans,
                    sync=sync)
        mark()
        sync()
    return trace.read(prof, spans.spans, (win.start, win.end), anchors)


def card(chips: int, peak: int) -> dict:
    """The result's `device`: the card's name, the cards used and the peak
    of allocated memory."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}


def result(run: Run, checks: Dict[str, float], device: dict,
           metrics: List[dict]) -> dict:
    """The result line: `correct`, the counts, the metrics read by their
    readers, the device, the breakdown of a traced run, and last the
    numbers compared beside their limits."""
    limits = run.config["limits"]
    correct = (run.window.failed == 0 and run.window.calls > 0
               and bool(checks)
               and all(checks[k] <= limits[k] for k in checks))
    values = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": run.evals,
           "failed": run.window.failed, "metrics": values,
           "device": dict(device)}
    if run.trace is not None:
        t = run.trace
        out["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        out["breakdown"] = {
            "device_ops": [list(kv) for kv in t.top_ops()],
            "idle_gaps": sorted(([k, v] for k, v in
                                 t.idle_by_span().items()),
                                key=lambda kv: -kv[1])[:10]}
    out["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                     for k in checks}
    return out


def emit(line: dict, out=None, err=None) -> int:
    """Print the result line, the numbers compared last on standard error,
    unless the process holds a module of BANNED: then print no result and
    return non-zero."""
    out, err = out or sys.stdout, err or sys.stderr
    found = banned_modules()
    if found:
        print(f"portbench: the process holds {found} after the window; "
              f"no result", file=err)
        return 3
    print(json.dumps(line), file=out)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err)
    return 0


def cards_missing(chips: int) -> Optional[str]:
    """Why this process cannot run a cell on `chips` cards, or None."""
    if not torch.cuda.is_available():
        return ("torch.cuda.is_available() is False; this benchmark runs "
                "on the card only")
    if torch.cuda.device_count() < chips:
        return f"{chips} cards needed, {torch.cuda.device_count()} visible"
    return None


def main(workload: str, seed: int, seconds: float, traced: bool,
         t0: float) -> int:
    cell = load_cell(workload)
    missing = cards_missing(cell.chips)
    if missing:
        print(f"portbench: {workload}: {missing}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    run, peak, sample = run_cell(cell, seed, seconds, traced, t0=t0)
    if traced and run.trace.busy_s <= 0:
        print("portbench: the trace holds no device activity",
              file=sys.stderr)
        return 4
    checks = check(cell.config, sample)
    line = result(run, checks, card(cell.chips, peak),
                  cell.per_layer if traced else cell.end_to_end)
    print("setup " + " ".join(f"{k} {v:.3f}"
                              for k, v in run.setup_phases.items()),
          file=sys.stderr)
    return emit(line)
