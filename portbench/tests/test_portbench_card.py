"""On the card: every cell runs as the driver runs it and comes out
correct, with its numbers beside their limits; the control, at the cell's
own size, comes out above them.  Skipped where there is no card.

    python3 -m pytest --noconftest -m cuda portbench/tests/test_portbench_card.py
"""
import json
import subprocess
import sys

import pytest
import torch

from portbench import harness

CELLS = [w["name"] for w in json.loads(
    (harness.REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")


def _run(args, timeout=600):
    out = subprocess.run([sys.executable, "-m", *args], cwd=harness.REPO,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.strip().splitlines()


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, name, trace):
    line = json.loads(_run(["portbench.run", "--workload", name, "--seed",
                            "2147483659", "--seconds", "3", "--trace",
                            str(trace)])[-1])
    assert line["correct"] and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ds1_gtr_gamma4.stream",
                                  "ds1_mg94.stream"])
def test_the_control_fails_and_the_program_passes_at_the_cells_size(
        card, name):
    summary = json.loads(_run(["portbench.control", "--workload", name,
                               "--seconds", "1", "21", "22", "23"])[-1])
    limits = summary["limits"]
    assert all(summary["lower"][k] <= limits[k] for k in limits)
    assert any(summary["upper"][k] > limits[k] for k in limits)
