"""The reference against the port's float64 scan tape at a small size,
and the TF32 control against the reference.  Only this test imports both:
portbench/reference imports nothing of the program."""
import numpy as np
import pytest
import torch

from portbench import inputs, reference
from portbench.reference import patterns
from portbench.tests.portbench_cases import one_thread, small_cell

CELLS = ["ds1_gtr_gamma4.stream", "ds1_mg94.stream"]


def port_float64(config, inp, bl):
    from bito_tpu_torch.core.site_pattern import CodonSitePattern, SitePattern
    from bito_tpu_torch.core.tree import Topology, Tree
    from bito_tpu_torch.models.phylo_model import (PhyloModel,
                                                   PhyloModelSpecification)
    from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

    sp = (SitePattern if config["alphabet"] == "nucleotide"
          else CodonSitePattern)(inp.alignment, inp.names)
    spec = config["model"]
    eng = TreeLikelihoodEngine(
        sp, PhyloModel(PhyloModelSpecification(spec["substitution"],
                                               spec["site"])),
        device="cpu", dtype=torch.float64)
    eng.kernel = "scan"
    T = inp.trees.taxa
    trees = [Tree(Topology(p, T), t)
             for p, t in zip(inp.trees.parents, inp.trees.lengths)]
    params = {k: torch.tensor(v, dtype=torch.float64)
              for k, v in config["params"].items()}
    return eng.branch_eval_fn(trees, params)(bl), sp.pattern_count


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_the_port_in_float64(name):
    config = small_cell(name).config
    inp = inputs.make_inputs(config, 3, config["trees"])
    bl = torch.as_tensor(inp.trees.lengths) * torch.exp(
        0.3 * torch.randn(inp.trees.lengths.shape,
                          generator=torch.Generator().manual_seed(1),
                          dtype=torch.float64))
    with one_thread():
        (ll, grads), S = port_float64(config, inp, bl)
        tips, w = patterns.site_patterns(inp.alignment, inp.names,
                                         config["alphabet"])
        ref_ll, ref_g = reference.evaluate(reference.model_of(config), tips,
                                           w, inp.trees.parents, bl)
    assert tips.shape[1] == S
    assert torch.allclose(ll, ref_ll, rtol=1e-12, atol=0)
    assert float((grads - ref_g).abs().max()) <= 1e-10 * float(
        ref_g.abs().max())
    assert np.all(ref_g[:, -1].numpy() == 0)


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_misses_the_limits(name):
    """The reference in float32 with TF32 products, in the program's place,
    fails the cell's check at this size too."""
    config = small_cell(name).config
    inp = inputs.make_inputs(config, 4, config["trees"])
    bl = torch.as_tensor(inp.trees.lengths)
    tips, w = patterns.site_patterns(inp.alignment, inp.names,
                                     config["alphabet"])
    model = reference.model_of(config)
    with one_thread():
        ref_ll, ref_g = reference.evaluate(model, tips, w, inp.trees.parents,
                                           bl)
        ll, g = reference.evaluate(model, tips, w, inp.trees.parents, bl,
                                   control=True)
    ll_err = float(((ll - ref_ll).abs() / ref_ll.abs()).max())
    grad_err = float(((g - ref_g).abs().amax(1)
                      / ref_g.abs().amax(1)).max())
    limits = config["limits"]
    assert ll_err > limits["ll_err"] or grad_err > limits["grad_err"]


def test_tf32_rounds_to_ten_mantissa_bits_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -11], dtype=torch.float32)
    assert reference.tree.tf32(x).tolist() == [
        1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10), 1.0 + 2 * 2.0 ** -10]


def test_trees_are_numbered_as_the_programs_newick_reader_numbers_them():
    from bito_tpu_torch.core.newick import parse_newick_text

    trees = inputs.random_trees(9, 11, 6)
    newick = "\n".join(
        _newick(p, t, 11) for p, t in zip(trees.parents, trees.lengths))
    coll = parse_newick_text(newick, taxon_names=inputs.taxon_names(11))
    for b, tree in enumerate(coll.trees):
        assert tree.topology.parents.tolist() == trees.parents[b].tolist()
        assert np.allclose(tree.branch_lengths, trees.lengths[b])


def _newick(parents, lengths, taxa):
    children = {}
    for v, p in enumerate(parents[:-1]):
        children.setdefault(int(p), []).append(v)

    def text(v):
        if v < taxa:
            return f"t{v}"
        return "(" + ",".join(f"{text(c)}:{float(lengths[c])!r}"
                              for c in children[v]) + ")"

    return text(len(parents) - 1) + ";"
