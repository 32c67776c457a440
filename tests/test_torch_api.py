"""The port's top-level API (bito_tpu_torch/__init__.py) against
bito_tpu's: every public name that bito_tpu/__init__.py binds (read from
its source by AST, so that bito_tpu is not imported for it) is in
bito_tpu_torch.__all__ and an attribute of the package, beside the device
constants; the instances start from the package; and gp_instance on the
CPU in float64 reaches bito_tpu.gp_instance()'s log marginal on a
synthetic credible set."""
import ast
import pathlib

import numpy as np
import pytest
import torch

import bito_tpu_torch as bito
from bito_tpu_torch import _synthetic

from torch_port_cases import one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


ROOT = pathlib.Path(__file__).resolve().parent.parent


def _public_names(path) -> set:
    """The public names a module's top level binds: imports, functions,
    classes and assignments (not those starting with an underscore)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_every_name_of_bito_tpu_is_exported():
    names = _public_names(ROOT / "bito_tpu" / "__init__.py")
    assert {"gp_instance", "GPInstance", "unrooted_instance",
            "rooted_instance", "phylo_flags", "git_commit", "to_hash_string",
            "phylo_gradient_mapkeys"} <= names
    missing = sorted(n for n in names if n not in bito.__all__
                     or not hasattr(bito, n))
    assert not missing
    for name in ("PRODUCT_DEVICE", "PRODUCT_DTYPE", "TEST_DEVICE",
                 "TEST_DTYPE"):
        assert name in bito.__all__ and hasattr(bito, name)
    assert all(hasattr(bito, n) for n in bito.__all__)
    assert bito.PRODUCT_DEVICE == "cuda" and bito.PRODUCT_DTYPE == torch.float32


def test_constants_and_helpers_match_bito_tpu():
    import bito_tpu

    for cls in ("phylo_gradient_mapkeys", "phylo_model_mapkeys"):
        ours, theirs = getattr(bito, cls), getattr(bito_tpu, cls)
        assert ({k: v for k, v in vars(ours).items() if k.isupper()}
                == {k: v for k, v in vars(theirs).items() if k.isupper()})
    flags = [n for n in dir(bito_tpu.phylo_flags) if n.isupper()]
    assert flags and all(getattr(bito.phylo_flags, n)
                         == getattr(bito_tpu.phylo_flags, n) for n in flags)
    ss = bito.subsplit("0011", "1100")
    assert bito.subsplit_to_string(ss) == bito_tpu.subsplit_to_string(
        bito_tpu.subsplit("0011", "1100"))
    assert bito.git_commit() == bito_tpu.git_commit()


def test_instances_start_from_the_package():
    for make in (bito.unrooted_instance, bito.rooted_instance):
        inst = make("api", device="cpu", dtype=torch.float64)
        assert inst.device == torch.device("cpu")
        assert inst.dtype == torch.float64
    inst = bito.gp_instance(device="cpu", dtype=torch.float64)
    assert isinstance(inst, bito.GPInstance) and inst.dtype == torch.float64


def test_gp_instance_reaches_bito_tpus_marginal(tmp_path):
    import bito_tpu

    nwk, fasta = tmp_path / "trees.nwk", tmp_path / "aln.fasta"
    nwk.write_text(_synthetic.credible_set_newick(21, 7, 4, 2))
    fasta.write_text(_synthetic.fasta_text(_synthetic.random_alignment(
        22, _synthetic.taxon_names(7), 90)))
    marginals = []
    for inst in (bito_tpu.gp_instance(),
                 bito.gp_instance(device="cpu", dtype=torch.float64)):
        inst.read_fasta_file(str(fasta))
        inst.read_newick_file(str(nwk))
        inst.make_gp_engine()
        inst.take_first_branch_length()
        inst.populate_plvs()
        inst.compute_likelihoods()
        marginals.append(inst.get_log_marginal_likelihood())
        inst.estimate_branch_lengths(1e-4, 4)
        marginals.append(inst.get_log_marginal_likelihood())
    j0, j1, t0, t1 = marginals
    assert abs(t0 - j0) < 1e-10 * abs(j0)
    assert abs(t1 - j1) < 1e-8 * abs(j1) and t1 > t0
    assert np.isfinite(t1)


def test_gp_instance_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bito.gp_instance()
