"""BENCHMARK.json against the benchmark's contract: names and units, every
cell's configuration, traffic and metric readers found by name, what each
cell reports, and the data-driven layout (a cell, a mix and a metric added
by new files and entries alone)."""
import contextlib
import importlib
import json
import re
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.tests.portbench_cases import SMALL, one_thread

REPO = Path(harness.REPO)
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "-m", "portbench.run"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units_keep_to_the_allowed_characters(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    for entry in BENCH[kind]:
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200
                assert "\n" not in entry[key] and "\t" not in entry[key]


def test_metric_entries_have_the_contract_keys():
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_finds_its_configuration_traffic_and_readers():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.config["reduced"] == []
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        call = harness.entry_point(cell.traffic["call"])
        assert callable(call.bind) and call.GRADIENTS in (True, False)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader(m["name"]))
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert w["chips"] == 1


def test_every_per_layer_metric_names_cells_that_report_what_it_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", cells)


def test_config_files_lie_under_paths_and_are_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("portbench/configs/") and (REPO / f).is_file()
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@contextlib.contextmanager
def checkout(tmp_path):
    """A copy of the benchmark under tmp_path: (root, BENCHMARK.json as a
    dict, a function that writes it and imports the copy's harness in the
    place of this one)."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    saved = {k: v for k, v in sys.modules.items()
             if k == "portbench" or k.startswith("portbench.")}

    def load():
        (root / "BENCHMARK.json").write_text(json.dumps(bench))
        for k in saved:
            sys.modules.pop(k, None)
        sys.path.insert(0, str(root))
        copy = importlib.import_module("portbench.harness")
        assert Path(copy.__file__).parent == root / "portbench"
        return copy

    try:
        yield root, bench, load
    finally:
        if str(root) in sys.path:
            sys.path.remove(str(root))
        for k in [k for k in sys.modules
                  if k == "portbench" or k.startswith("portbench.")]:
            del sys.modules[k]
        sys.modules.update(saved)


def _tiny_config(root):
    config = json.loads((root / "portbench/configs/ds1_gtr_gamma4.json")
                        .read_text())
    config.update(SMALL, name="tiny_gtr", topologies=5)
    (root / "portbench/configs/tiny_gtr.json").write_text(json.dumps(config))
    return {"name": "tiny_gtr", "source": "a test",
            "file": "portbench/configs/tiny_gtr.json", "reduced": [],
            "why": "a test"}


def _cpu_line(copy, cell, seed):
    with one_thread():
        run, _, sample = copy.run_cell(
            cell, seed, 0.2, False, t0=time.perf_counter(), device="cpu",
            dtype=torch.float64)
    return run, copy.result(run, copy.check(cell.config, sample),
                            {"platform": "cpu"},
                            cell.end_to_end + cell.per_layer)


def test_a_cell_a_mix_and_a_metric_are_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, two traffic mixes
    (LL alone over a pool of topologies, every call a new batch; and LL
    and gradients of each tree twice a call through a new entry point),
    a metric read by a split
    name, and their cells, through new files and new entries, and runs
    those cells on the CPU with no edit to a file it had."""
    with checkout(tmp_path) as (root, bench, load):
        bench["configs"].append(_tiny_config(root))
        (root / "portbench/traffic/ll_pool.json").write_text(json.dumps(
            {"call": "ll_eval", "topology_pool": 12, "read_every": 3,
             "read_back": "ll_sum", "bl_log_sd": 0.2, "warmup_calls": 2,
             "checked_calls": 3}))
        (root / "portbench/calls/grads_twice.py").write_text(
            "GRADIENTS = True\n\n\n"
            "def bind(engine, trees, params):\n"
            "    fn = engine.branch_eval_fn(trees, params)\n"
            "    return lambda bl: fn(bl) and fn(bl)\n")
        (root / "portbench/traffic/twice.json").write_text(json.dumps(
            {"call": "grads_twice", "repeat": 2, "read_every": 1,
             "read_back": "outputs", "bl_log_sd": 0.2, "warmup_calls": 2,
             "checked_calls": 2}))
        (root / "portbench/metrics/calls_per_window.py").write_text(
            "def read(run):\n    return run.window.calls\n")
        cells = {"tiny_gtr.ll_pool": "ll_pool", "tiny_gtr.twice": "twice"}
        for name, mix in cells.items():
            bench["workloads"].append({"name": name, "config": "tiny_gtr",
                                       "traffic": mix, "chips": 1,
                                       "why": "a test"})
        bench["per_layer"].append({"name": "calls_per_window.tiny",
                                   "unit": "calls", "better": "higher",
                                   "source": "host_clock",
                                   "layer": "harness",
                                   "moves": "evals_per_s",
                                   "workloads": list(cells)})
        bench["end_to_end"][0]["workloads"].extend(cells)
        copy = load()
        for name, seed in zip(cells, (5, 6)):
            cell = copy.load_cell(name)
            assert [m["name"] for m in cell.per_layer] == [
                "calls_per_window.tiny"]
            run, line = _cpu_line(copy, cell, seed)
            assert line["correct"], line
            assert line["metrics"]["calls_per_window.tiny"]["value"] == \
                run.window.calls > 0
            assert set(line["metrics"]) == {"evals_per_s", "setup_s",
                                            "calls_per_window.tiny"}
            assert set(line["checks"]) == (
                {"ll_err"} if name.endswith("ll_pool")
                else {"ll_err", "grad_err"})
            repeat = 1 if name.endswith("ll_pool") else 2
            assert run.batch == repeat * SMALL["trees"]
            assert line["attempted"] == run.window.calls * run.batch


def test_a_pooled_mix_draws_a_new_batch_every_call(tmp_path):
    """With `topology_pool`, the kept calls hold distinct batches, and a
    batch altered where it is produced comes out not correct."""
    with checkout(tmp_path) as (root, bench, load):
        bench["configs"].append(_tiny_config(root))
        (root / "portbench/traffic/pool.json").write_text(json.dumps(
            {"call": "branch_eval", "topology_pool": 12, "read_every": 1,
             "read_back": "outputs", "bl_log_sd": 0.2, "warmup_calls": 2,
             "checked_calls": 4}))
        bench["workloads"].append({"name": "tiny_gtr.pool",
                                   "config": "tiny_gtr", "traffic": "pool",
                                   "chips": 1, "why": "a test"})
        copy = load()
        cell = copy.load_cell("tiny_gtr.pool")
        with one_thread():
            _, _, sample = copy.run_cell(
                cell, 7, 0.2, False, t0=time.perf_counter(), device="cpu",
                dtype=torch.float64)
            picks = {tuple(p) for p in sample.keeper.picks.values()}
            assert len(picks) == len(sample.keeper.picks) == 4
            assert all(len(set(p)) == SMALL["trees"] for p in picks)
            assert copy.check(cell.config, sample)["grad_err"] < 1e-10

            def shifted(fn):
                def broken(bl, pick):
                    return fn(bl, (pick + 1) % 12)
                return broken

            _, _, sample = copy.run_cell(
                cell, 8, 0.2, False, t0=time.perf_counter(), device="cpu",
                dtype=torch.float64, wrap=shifted)
            assert copy.check(cell.config, sample)["ll_err"] > 1e-3


def test_a_run_that_loads_jax_after_the_window_prints_no_result(
        tmp_path, monkeypatch, capsys):
    """A metric reader that imports a module named `jax` loads it after the
    window: the run exits non-zero and prints no result line."""
    stubs = tmp_path / "stubs" / "jax"
    stubs.mkdir(parents=True)
    (stubs / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(stubs.parent))
    with checkout(tmp_path) as (root, bench, load):
        bench["configs"].append(_tiny_config(root))
        bench["workloads"].append({"name": "tiny_gtr.stream",
                                   "config": "tiny_gtr", "traffic": "stream",
                                   "chips": 1, "why": "a test"})
        (root / "portbench/metrics/jax_probe.py").write_text(
            "import jax  # noqa: F401\n\n\ndef read(run):\n"
            "    return 1.0\n")
        bench["end_to_end"].append({"name": "jax_probe", "unit": "1",
                                    "better": "lower", "bound": 0.25,
                                    "source": "host_clock",
                                    "workloads": ["tiny_gtr.stream"]})
        copy = load()
        monkeypatch.setattr(copy, "cards_missing", lambda chips: None)
        monkeypatch.setattr(copy, "card",
                            lambda chips, peak: {"platform": "cpu"})
        run_cell = copy.run_cell
        monkeypatch.setattr(
            copy, "run_cell", lambda *a, **k: run_cell(
                *a, **k, device="cpu", dtype=torch.float64))
        try:
            with one_thread():
                rc = copy.main("tiny_gtr.stream", 9, 0.2, False,
                               time.perf_counter())
        finally:
            sys.modules.pop("jax", None)
    out, err = capsys.readouterr()
    assert rc != 0
    assert "{" not in out
    assert "jax" in err
