"""The port's VBPI benchmark and command line (bito_tpu_torch/vi/benchmark.py,
vi/cli.py) against bito_tpu's (vi/benchmark.py with pandas, vi/cli.py
with click), on the CPU in float64, on a synthetic data directory X with
X_out.t (_synthetic.mcmc_nexus) and X.fasta (random_alignment): two steps
of the trainer from one seed, the optimizer's ELBO trace and the final
ELBO within 1e-8 (the bound tests/test_torch_vi.py holds Burrito steps
to), the fitting results row for row."""
import csv
import os

import numpy as np
import pytest
import torch

from bito_tpu.vi.benchmark import fixed as jax_fixed
from bito_tpu_torch import _synthetic
from bito_tpu_torch.vi import benchmark, cli

from torch_port_cases import one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


BOUND = 1e-8
TAXA, TREES, SITES = 6, 10, 120
RUN = dict(branch_model_name="split", scalar_model_name="lognormal",
           step_count=2, particle_count=3, final_elbo_particle_count=8)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("runs") / "synth"
    d.mkdir()
    (d / "synth_out.t").write_text(_synthetic.mcmc_nexus(31, TAXA, TREES))
    (d / "synth.fasta").write_text(_synthetic.fasta_text(
        _synthetic.random_alignment(32, _synthetic.taxon_names(TAXA),
                                    SITES)))
    return str(d)


def test_fixed_matches_bito_tpu(data_dir):
    """The bump optimizer, which records an ELBO a step: the trace and the
    final ELBO within BOUND, the fitting results' rows in bito_tpu's order
    with their values within BOUND relative."""
    want = jax_fixed(data_dir, optimizer_name="bump", **RUN)
    got = benchmark.fixed(data_dir, optimizer_name="bump", device="cpu",
                          dtype=torch.float64, **RUN)
    details, trace, fitting = got
    assert set(details) == {"gradient_time", "final_elbo"}
    assert details["gradient_time"] > 0
    assert abs(details["final_elbo"] - want[0]["final_elbo"]) <= BOUND
    assert trace.dtype.names == ("index", "elbo")
    assert len(trace) == RUN["step_count"]
    np.testing.assert_array_equal(trace["index"], want[1]["index"])
    np.testing.assert_allclose(trace["elbo"], want[1]["elbo"], rtol=0,
                               atol=BOUND)
    frame = want[2]
    assert fitting.dtype.names == tuple(frame.columns) == ("type",
                                                           "variable",
                                                           "value")
    assert list(fitting["type"]) == list(frame["type"])
    assert list(fitting["variable"]) == list(frame["variable"])
    np.testing.assert_allclose(fitting["value"], frame["value"], rtol=BOUND)


def test_cli_benchmark_and_dag_to_dot(data_dir, tmp_path, capsys):
    """`benchmark` with bito_tpu's defaults but the step count and sizes
    (the simple optimizer: an empty trace, as bito_tpu's) writes both CSVs
    with bito_tpu's columns and prints the run details; `dag-to-dot`
    writes the DAG's .dot and, without graphviz, says it wrote only that."""
    prefix = str(tmp_path / "run")
    cli.main(["benchmark", "--step-count", "2", "--particle-count", "3",
              "--final-elbo-particle-count", "8", "--device", "cpu",
              "--dtype", "float64", "--out-prefix", prefix, data_dir])
    out = capsys.readouterr().out
    assert "Starting validation:" in out and "final_elbo" in out
    with open(prefix + "_opt_trace.csv") as f:
        assert list(csv.reader(f)) == [["index", "elbo"]]
    with open(prefix + "_fitting_results.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["type", "variable", "value"]
    assert {r[0] for r in rows[1:]} == {"vb", "mcmc"}
    assert all(np.isfinite(float(r[2])) for r in rows[1:])

    text = _synthetic.credible_set_newick(4, TAXA)
    newick = tmp_path / "trees.nwk"
    newick.write_text(text)
    fasta = os.path.join(data_dir, "synth.fasta")
    dot = str(tmp_path / "dag.dot")
    cli.main(["dag-to-dot", "-fasta", fasta, "-newick", str(newick),
              "-output", dot, "-edges", "true"])
    assert open(dot).read().startswith("digraph")
    out = capsys.readouterr().out
    try:
        import graphviz  # noqa: F401
    except ImportError:
        assert f"wrote {dot} only" in out
    with pytest.raises(SystemExit):
        cli.main(["benchmark", "--optimizer", "adam", data_dir])
