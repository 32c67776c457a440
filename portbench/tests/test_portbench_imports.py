"""What the command imports, compared by whole top-level module names: not
`jax`, `jaxlib`, `flax` or `bito_tpu` (whose name `bito_tpu_torch` only
begins with); and the reference imports nothing of the program."""
import json
import subprocess
import sys

from portbench import harness

PROBE = r"""
import json, sys, time, torch
from portbench import harness, run, control, stats, trace
from portbench.tests.portbench_cases import small_cell
for name in %r:
    cell = small_cell(name)
    for m in cell.end_to_end + cell.per_layer:
        harness.reader(m["name"])
    r, _, sample = harness.run_cell(cell, 1, 0.05, False,
                                    t0=time.perf_counter(), device="cpu",
                                    dtype=torch.float64)
    harness.check(cell.config, sample)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
                              "PYTHONPATH": str(harness.REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_no_jax_and_no_bito_tpu():
    cells = [w["name"] for w in json.loads(
        (harness.REPO / "BENCHMARK.json").read_text())["workloads"]]
    names = top_level_modules(PROBE % cells)
    assert "bito_tpu_torch" in names
    assert not names & set(harness.BANNED), names & set(harness.BANNED)


def test_the_reference_imports_nothing_of_the_program():
    names = top_level_modules(
        "import json, sys; import portbench.reference; "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "torch" in names
    assert not names & {"bito_tpu_torch", *harness.BANNED}


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "bito_tpu_torch_probe", sys)
    assert "bito_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "bito_tpu.core", sys)
    assert "bito_tpu" in harness.banned_modules()
