"""The port's Sankoff parsimony (parsimony/sankoff.py) against bito_tpu's,
and against a brute-force minimum over every assignment of internal
states, on the CPU.

Scores are sums of small integers, exact in float64 and in float32 alike:
they are held equal, not close."""
import itertools

import numpy as np
import pytest
import torch

from bito_tpu.core.newick import parse_newick_text as jax_parse
from bito_tpu.core.site_pattern import SitePattern as JaxSitePattern
from bito_tpu.parsimony.sankoff import SankoffHandler as JaxSankoff
from bito_tpu_torch import _synthetic
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.core.site_pattern import SitePattern
from bito_tpu_torch.parsimony.sankoff import BIG, SankoffHandler, leaf_partials

ASYMMETRIC = np.array([[0., 2., 3., 4.], [5., 0., 7., 8.],
                       [9., 10., 0., 12.], [13., 14., 15., 0.]])


def _inputs(seed, taxa, sites, trees, rooted):
    text = _synthetic.random_trees_newick(seed, taxa, trees, rooted)
    jc, tc = jax_parse(text), parse_newick_text(text)
    aln = _synthetic.random_alignment(seed + 1, tc.taxon_names, sites)
    return (jc, JaxSitePattern(aln, jc.taxon_names), tc,
            SitePattern(aln, tc.taxon_names))


@pytest.mark.parametrize("rooted", [False, True])
@pytest.mark.parametrize("cost", [None, ASYMMETRIC], ids=["unit", "asym"])
def test_sankoff_equals_bito_tpu(rooted, cost):
    jc, jsp, tc, tsp = _inputs(3, 9, 200, 6, rooted)
    ref = JaxSankoff(jsp, cost)
    got = SankoffHandler(tsp, cost, device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(got.run_sankoff(tc.trees),
                                  ref.run_sankoff(jc.trees))
    np.testing.assert_array_equal(got.parsimony_score(),
                                  ref.parsimony_score())
    assert got.parsimony_score(5) == ref.parsimony_score(5)


def test_float32_equals_float64():
    """BIG rounds to 2^31 in float32 and is clamped there; the scores,
    integer sums, are the same."""
    _, _, tc, tsp = _inputs(4, 12, 300, 5, False)
    f64 = SankoffHandler(tsp, ASYMMETRIC, device="cpu", dtype=torch.float64)
    f32 = SankoffHandler(tsp, ASYMMETRIC, device="cpu", dtype=torch.float32)
    assert float(f32.tips.max()) == 2.0 ** 31 and BIG == 2.0 ** 31 - 1
    np.testing.assert_array_equal(f32.run_sankoff(tc.trees),
                                  f64.run_sankoff(tc.trees))


def _brute_force(tree, tip_states, cost):
    """The least cost over every assignment of internal states, a pattern
    at a time; a gap takes its cheapest state."""
    topo = tree.topology
    n = topo.num_taxa
    internals = list(range(n, topo.num_nodes))
    total = []
    for s in range(tip_states.shape[1]):
        best = np.inf
        for assign in itertools.product(range(4), repeat=len(internals)):
            state = dict(zip(internals, assign))
            sc = 0.0
            for v in range(topo.num_nodes - 1):
                p = state[int(topo.parents[v])]
                if v < n and tip_states[v, s] == 4:
                    sc += min(cost[p])
                else:
                    sc += cost[p, tip_states[v, s] if v < n else state[v]]
            best = min(best, sc)
        total.append(best)
    return np.array(total)


@pytest.mark.parametrize("cost", [None, ASYMMETRIC], ids=["unit", "asym"])
def test_sankoff_equals_brute_force(cost):
    """Five taxa, rooted and unrooted trees: each pattern's score is the
    least cost over the 4^(internal nodes) assignments."""
    for rooted in (False, True):
        _, _, tc, tsp = _inputs(7, 5, 40, 3, rooted)
        c = cost if cost is not None else 1.0 - np.eye(4)
        h = SankoffHandler(tsp, cost, device="cpu", dtype=torch.float64)
        totals = h.run_sankoff(tc.trees)
        per_pattern = h.parsimony_score()
        states = tsp.tip_states()
        for b, tree in enumerate(tc.trees):
            want = _brute_force(tree, states, c)
            np.testing.assert_array_equal(per_pattern[b], want)
            assert totals[b] == want @ tsp.weights


def test_leaf_partials():
    _, jsp, _, tsp = _inputs(8, 6, 100, 1, False)
    from bito_tpu.parsimony.sankoff import leaf_partials as jax_leaf

    np.testing.assert_array_equal(leaf_partials(tsp), jax_leaf(jsp))


def test_gp_instance_parsimony(tmp_path):
    """compute_tree_parsimony (and its alias) through the port's
    gp_instance, against bito_tpu's."""
    from bito_tpu.api.gp import gp_instance as jax_gp
    from bito_tpu_torch.api.gp import gp_instance

    paths = _synthetic.write_nni_inputs(tmp_path, 2, 7, 150)
    out = []
    for inst in (jax_gp(""), gp_instance(device="cpu", dtype=torch.float64)):
        inst.read_fasta_file(paths["alignment.fasta"])
        inst.read_newick_file(paths["credible.nwk"])
        out.append((inst.compute_tree_parsimony(),
                    inst.compute_parsimony(inst.tree_collection.trees[1])))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    np.testing.assert_array_equal(out[1][1], out[0][1])
    assert out[1][0].shape == (_synthetic.CREDIBLE_TREES,)
