"""The port's utils/ (timing.py, checkpoint.py) against bito_tpu's: the
copied host code pinned by AST, the torch hooks (device_trace,
block_until_ready, a PhaseTimer handed to Burrito.gradient_step), and
checkpoints carried both ways between the packages for an SBN instance,
a GP instance and a Burrito, on the CPU in float64."""
import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from bito_tpu.api.gp import gp_instance as jax_gp_instance
from bito_tpu.api.instances import unrooted_instance as jax_instance
from bito_tpu.models.phylo_model import PhyloModelSpecification as JaxSpec
from bito_tpu.utils import checkpoint as jax_checkpoint
from bito_tpu.vi.burrito import Burrito as JaxBurrito
from bito_tpu_torch import _synthetic
from bito_tpu_torch.api.gp import gp_instance
from bito_tpu_torch.api.instances import unrooted_instance
from bito_tpu_torch.models.phylo_model import PhyloModelSpecification
from bito_tpu_torch.utils import checkpoint, timing
from bito_tpu_torch.vi.burrito import Burrito

from torch_port_cases import without_docstrings

ROOT = pathlib.Path(__file__).resolve().parent.parent
F64 = dict(device="cpu", dtype=torch.float64)
TAXA, TREES, SITES = 6, 10, 80


def _top_level(path, name):
    """The AST dump of module `path`'s top-level class or function `name`,
    docstrings removed."""
    for node in ast.parse(pathlib.Path(path).read_text()).body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)) and (
                node.name == name):
            for sub in ast.walk(node):
                body = getattr(sub, "body", None)
                if (isinstance(body, list) and body
                        and isinstance(body[0], ast.Expr)
                        and isinstance(body[0].value, ast.Constant)
                        and isinstance(body[0].value.value, str)):
                    sub.body = body[1:]
            return ast.dump(node)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["Stopwatch", "PhaseTimer", "ProgressBar"])
def test_timing_classes_are_bito_tpus_code(name):
    assert (_top_level(ROOT / "bito_tpu_torch/utils/timing.py", name)
            == _top_level(ROOT / "bito_tpu/utils/timing.py", name))


def test_checkpoint_is_bito_tpus_code_but_restore_gp():
    """Apart from docstrings, checkpoint.py is bito_tpu's but for
    restore_gp, which puts q on the engine's device in its dtype."""
    drop = ("restore_gp",)
    assert (without_docstrings(ROOT / "bito_tpu_torch/utils/checkpoint.py",
                               drop)
            == without_docstrings(ROOT / "bito_tpu/utils/checkpoint.py", drop))


def test_timing_hooks(tmp_path, capsys):
    watch = timing.Stopwatch()
    assert watch.lap() >= 0 and len(watch.laps) == 1
    timer = timing.PhaseTimer()
    for _ in range(2):
        with timer.phase("a"):
            pass
    assert timer.counts == {"a": 2} and "a:" in timer.report()
    bar = timing.ProgressBar(4)
    bar += 2
    bar.done()
    assert "50%" in capsys.readouterr().out
    x = torch.ones(3)
    tree = {"x": [x, (x + 1, "label")]}
    assert timing.block_until_ready(tree) is tree
    with timing.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).sum()
    assert prof is not None
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.fixture(scope="module")
def vbpi_files(tmp_path_factory):
    return _synthetic.write_vbpi_inputs(tmp_path_factory.mktemp("vbpi"), 7,
                                        TAXA, TREES, SITES)


def _instances(nexus, fasta):
    out = []
    for inst, spec in ((jax_instance("ckpt"), JaxSpec("GTR", "gamma+4")),
                       (unrooted_instance("ckpt", **F64),
                        PhyloModelSpecification("GTR", "gamma+4"))):
        inst.read_nexus_file(nexus)
        inst.process_loaded_trees()
        inst.read_fasta_file(fasta)
        inst.prepare_for_phylo_likelihood(spec, 1)
        out.append(inst)
    return out


@pytest.mark.parametrize("direction", ["bito_tpu->port", "port->bito_tpu"])
def test_instance_checkpoint_carries_between_packages(vbpi_files, tmp_path,
                                                      direction):
    nexus, fasta = vbpi_files
    j, t = _instances(nexus, fasta)
    src, dst = (j, t) if direction == "bito_tpu->port" else (t, j)
    rng = np.random.default_rng(3)
    src.sbn_parameters[:] = rng.normal(size=src.sbn_parameters.shape)
    src.phylo_model_params[:] = rng.uniform(
        0.1, 1.0, size=src.phylo_model_params.shape)
    path = str(tmp_path / "inst.npz")
    (jax_checkpoint if src is j else checkpoint).checkpoint_instance(
        src, path, extra={"step": 4})
    extra = (checkpoint if dst is t else jax_checkpoint).restore_instance(
        dst, path)
    assert extra == {"step": 4}
    assert dst.pretty_indexer() == src.pretty_indexer()
    np.testing.assert_array_equal(dst.sbn_parameters, src.sbn_parameters)
    np.testing.assert_array_equal(dst.phylo_model_params,
                                  src.phylo_model_params)


@pytest.mark.parametrize("direction", ["bito_tpu->port", "port->bito_tpu"])
def test_gp_checkpoint_carries_between_packages(tmp_path, direction):
    newick = tmp_path / "credible.nwk"
    newick.write_text(_synthetic.credible_set_newick(8, TAXA))
    fasta = tmp_path / "aln.fasta"
    fasta.write_text(_synthetic.fasta_text(_synthetic.random_alignment(
        9, _synthetic.taxon_names(TAXA), SITES)))
    insts = [jax_gp_instance(""), gp_instance(**F64)]
    for inst in insts:
        inst.read_fasta_file(str(fasta))
        inst.read_newick_file(str(newick))
        inst.make_dag()
        inst.make_gp_engine()
    j, t = insts
    src, dst = (j, t) if direction == "bito_tpu->port" else (t, j)
    E = src.get_dag().edge_count()
    rng = np.random.default_rng(4)
    src.set_branch_lengths(rng.uniform(0.01, 0.5, E))
    q = rng.uniform(0.1, 1.0, E)
    src.get_gp_engine().q = q
    path = str(tmp_path / "gp.npz")
    (jax_checkpoint if src is j else checkpoint).checkpoint_gp(src, path)
    (checkpoint if dst is t else jax_checkpoint).restore_gp(dst, path)
    assert dst.get_dag().pretty_edges() == src.get_dag().pretty_edges()
    np.testing.assert_array_equal(np.asarray(dst.get_branch_lengths()),
                                  np.asarray(src.get_branch_lengths()))
    np.testing.assert_array_equal(np.asarray(dst.get_sbn_parameters()), q)
    if dst is t:
        engine = t.get_gp_engine()
        assert engine.q.device == engine.device
        assert engine.q.dtype == torch.float64


def _burritos(nexus, fasta):
    kw = dict(mcmc_nexus_path=nexus, burn_in_fraction=0.1, fasta_path=fasta,
              branch_model_name="split", scalar_model_name="lognormal",
              optimizer_name="simple", particle_count=3)
    return (JaxBurrito(phylo_model_specification=JaxSpec("JC69"), **kw),
            Burrito(phylo_model_specification=PhyloModelSpecification("JC69"),
                    **kw, **F64))


def _burrito_state(b):
    opt = b.opt
    return (b.branch_model.scalar_model.q_params, b.inst.sbn_parameters,
            np.asarray(opt.step_size), opt.sbn_step_size, opt.adam_count,
            opt.adam_mu, opt.adam_nu)


@pytest.mark.parametrize("direction", ["bito_tpu->port", "port->bito_tpu"])
def test_burrito_checkpoint_carries_between_packages(vbpi_files, tmp_path,
                                                     direction):
    nexus, fasta = vbpi_files
    j, t = _burritos(nexus, fasta)
    src, dst = (j, t) if direction == "bito_tpu->port" else (t, j)
    rng = np.random.default_rng(5)
    src.branch_model.scalar_model.q_params[:] = rng.normal(
        size=src.branch_model.scalar_model.q_params.shape)
    src.inst.sbn_parameters[:] = rng.normal(size=src.inst.sbn_parameters.shape)
    src.opt.step_size = src.opt.step_size * 0.5
    src.opt.sbn_step_size = 0.003
    mu = {k: rng.normal(size=v.shape) for k, v in src.opt.adam_mu.items()}
    nu = {k: rng.uniform(size=v.shape) for k, v in src.opt.adam_nu.items()}
    src.opt.set_adam_state(7, mu, nu)
    path = str(tmp_path / "burrito.npz")
    (jax_checkpoint if src is j else checkpoint).checkpoint_burrito(
        src, path, step=7)
    step = (checkpoint if dst is t else jax_checkpoint).restore_burrito(
        dst, path)
    assert step == 7
    want, got = _burrito_state(src), _burrito_state(dst)
    for w, g in zip(want[:4], got[:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4] == 7
    for w, g in zip(want[5:], got[5:]):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_legacy_json_snapshot_loads(tmp_path):
    path = tmp_path / "old.json"
    path.write_text(json.dumps({"kind": "gp_instance", "nested": {
        "bl": {"__ndarray__": [0.5, 0.25], "dtype": "float64"}}}))
    state = checkpoint.load_state(str(path))
    assert state["kind"] == "gp_instance"
    np.testing.assert_array_equal(state["nested"]["bl"], [0.5, 0.25])


def test_burrito_step_takes_a_phase_timer(vbpi_files):
    """bito_tpu's config4 hands Burrito.gradient_step a PhaseTimer: the
    port's step takes the port's and fills every phase once."""
    nexus, fasta = vbpi_files
    burrito = _burritos(nexus, fasta)[1]
    timer = timing.PhaseTimer()
    burrito.gradient_step(timer=timer)
    assert set(timer.counts) == {
        "sample_topologies", "branch_representation", "branch_sample",
        "device_ll_grad", "scalar_grad", "px_log_f", "topology_gradients",
        "adam"}
    assert all(n == 1 for n in timer.counts.values())
