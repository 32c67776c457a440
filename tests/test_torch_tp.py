"""The TP engine's pieces in the port against bito_tpu's, on the CPU in
float64: the scan tape's preorder_pass and branch_length_gradients, the
engine's optimize_selected_branches (with and without `bucket`), the
choice map (a copy, pinned by AST) and the TP engine (tp/engine.py): its
top-tree log likelihoods and parsimony scores, one optimize_branch_lengths
and the API-compat maps.

Bounds: outside vectors and gradients within 1e-10 (relative to the
largest), branch lengths after Brent within 1e-8 relative and the log
likelihoods they reach within 1e-10 relative.  No Brent tie decides a
length here: every length is held to 1e-8."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu.api.gp import gp_instance as jax_gp
from bito_tpu.treelike import pruning as jpr
from bito_tpu_torch import _synthetic
from bito_tpu_torch.api.gp import gp_instance
from bito_tpu_torch.tp.engine import TPEngine
from bito_tpu_torch.treelike import pruning as tpr

from torch_port_cases import (MODELS, jax_engine, jax_params, make_case,
                              max_norm, max_rel, torch_engine, torch_params,
                              without_docstrings)

ROOT = pathlib.Path(__file__).resolve().parent.parent
F64 = dict(device="cpu", dtype=torch.float64)


def test_choice_map_code_is_identical():
    """Apart from docstrings, tp/choice_map.py is bito_tpu's code."""
    assert (without_docstrings(ROOT / "bito_tpu_torch/tp/choice_map.py")
            == without_docstrings(ROOT / "bito_tpu/tp/choice_map.py"))


def _n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _tapes(model, rooted, seed=11):
    case = make_case(seed=seed, num_taxa=8, num_trees=4, rooted=rooted)
    params = MODELS[model][1]
    je, te = jax_engine(case, model), torch_engine(case, model)
    jenc, tenc = je.encode(case.jax_trees), te.encode(case.torch_trees)
    jbl = je.branch_length_matrix(case.jax_trees, jenc)
    tbl = te.branch_length_matrix(case.torch_trees, tenc)
    jing = je._model_ingredients(jax_params(params), 4)
    ting = te._model_ingredients(torch_params(params), 4)
    return case, params, je, te, jenc, tenc, jbl, tbl, jing, ting


@pytest.mark.parametrize("model,rooted", [("gtr_gamma4", False),
                                          ("jc69", True),
                                          ("hky_weibull4", False)])
def test_preorder_pass_and_branch_length_gradients(model, rooted):
    """The outside vectors and, from them, the branch gradients; the
    gradients also equal ll_and_branch_gradients_impl's (edge_adjoints,
    the same recursion)."""
    (case, params, je, te, jenc, tenc, jbl, tbl,
     (jeig, jr, jp, jc), (teig, tr, tp, tc)) = _tapes(model, rooted)
    C = te.model.category_count
    jP = jpr.transition_matrices_ext(jeig, jbl, jr, jc)
    jdP = jpr.transition_matrices_ext(jeig, jbl, jr, jc, derivative=True)
    tP = tpr.transition_matrices_ext(teig, tbl, tr, tc)
    tdP = tpr.transition_matrices_ext(teig, tbl, tr, tc, derivative=True)
    jbuf, jls = jpr.init_partials(je.tip_partials, 4, jenc.num_slots, C,
                                  je.pattern_pad)
    jbuf, _ = jpr.postorder_pass(jnp.asarray(jenc.post_ops), jP, jbuf, jls)
    post, pre, root, mask = te._scan_tapes(tenc)
    tbuf, tls = tpr.init_partials(te.tip_partials, 4, tenc.num_slots, C,
                                  te.pattern_pad)
    tbuf, _ = tpr.postorder_pass(post, tP, tbuf, tls)
    ref = jpr.preorder_pass(jnp.asarray(jenc.pre_ops), jP, jbuf,
                            jnp.asarray(jenc.root), jeig.pi)
    got = tpr.preorder_pass(pre, tP, tbuf, root, teig.pi)
    assert got.shape == tbuf.shape
    assert max_norm(_n(got), _n(ref)) < 1e-10
    jmask = jnp.asarray(jenc.edge_mask, jnp.float64)
    g_ref = jpr.branch_length_gradients(ref, jbuf, jP, jdP, jp, je.weights,
                                        jmask)
    g = tpr.branch_length_gradients(got, tbuf, tP, tdP, tp, te.weights, mask)
    assert max_norm(_n(g), _n(g_ref)) < 1e-10
    _, g_adj = te.ll_and_branch_gradients(case.torch_trees,
                                          torch_params(params))
    assert max_norm(_n(g), _n(g_adj)) < 1e-10


def _selected(case, seed):
    """A few random non-root nodes of each tree (none for the last)."""
    rng = np.random.default_rng(seed)
    out = []
    for b, tree in enumerate(case.torch_trees):
        n = tree.topology.num_nodes - 1
        k = 0 if b == len(case.torch_trees) - 1 else int(rng.integers(1, 4))
        out.append(sorted(rng.choice(n, size=k, replace=False).tolist()))
    return out


@pytest.mark.parametrize("model,rooted", [("jc69", False),
                                          ("gtr_gamma4", True)])
def test_optimize_selected_branches(model, rooted):
    """The port's lengths equal bito_tpu's within 1e-8 relative, the log
    likelihoods they reach within 1e-10; `bucket` changes no row."""
    case, params, je, te, *_ = _tapes(model, rooted, seed=5)
    sel = _selected(case, 9)
    ref = np.asarray(je.optimize_selected_branches(
        case.jax_trees, jax_params(params), sel, iterations=2))
    tp = torch_params(params)
    got = te.optimize_selected_branches(case.torch_trees, tp, sel,
                                        iterations=2)
    bucketed = te.optimize_selected_branches(case.torch_trees, tp, sel,
                                             iterations=2, bucket=True)
    np.testing.assert_array_equal(bucketed, got)
    assert got.shape == ref.shape
    moved = 0
    for b, nodes in enumerate(sel):
        before = case.torch_trees[b].branch_lengths
        n = len(before)
        np.testing.assert_allclose(got[b, :n], ref[b, :n], rtol=1e-8, atol=0)
        rest = np.setdiff1d(np.arange(n), nodes)
        np.testing.assert_array_equal(got[b, rest], before[rest])
        moved += int(np.sum(got[b, nodes] != before[nodes]))
    assert moved > 0
    ll_ref = np.asarray(je.log_likelihoods(case.jax_trees, jax_params(params),
                                           jnp.asarray(ref)))
    ll = te.log_likelihoods(case.torch_trees, tp, torch.as_tensor(got))
    assert max_rel(_n(ll), ll_ref) < 1e-10
    before = te.log_likelihoods(case.torch_trees, tp)
    assert bool((ll[:-1] > before[:-1]).all())


def test_log_likelihoods_bucket_keyword():
    case, params, _, te, *_ = _tapes("jc69", False)
    tp = torch_params(params)
    np.testing.assert_array_equal(
        _n(te.log_likelihoods(case.torch_trees, tp, bucket=True)),
        _n(te.log_likelihoods(case.torch_trees, tp)))


def _engines(tmp_path, seed=3, taxa=7, sites=200):
    """bito_tpu's and the port's TP engines from gp_instance on the same
    synthetic NNI inputs, the DAG of the credible set."""
    paths = _synthetic.write_nni_inputs(tmp_path, seed, taxa, sites)
    out = []
    for inst in (jax_gp(""), gp_instance(**F64)):
        inst.read_fasta_file(paths["alignment.fasta"])
        inst.read_newick_file(paths["credible.nwk"])
        inst.make_dag()
        eng = inst.make_tp_engine()
        assert inst.get_tp_engine() is eng
        inst.tp_engine_set_branch_lengths_by_taking_first()
        inst.tp_engine_set_choice_map_by_taking_first()
        out.append(eng)
    return out


def test_tp_engine_scores_and_optimization(tmp_path):
    jeng, teng = _engines(tmp_path)
    assert isinstance(teng, TPEngine) and teng.like_engine.device.type == "cpu"
    np.testing.assert_array_equal(teng.branch_lengths, jeng.branch_lengths)
    assert ([t.topology.key() for t in teng.top_trees()]
            == [t.topology.key() for t in jeng.top_trees()])
    assert max_rel(teng.top_tree_log_likelihoods(),
                   jeng.top_tree_log_likelihoods()) < 1e-10
    np.testing.assert_array_equal(teng.top_tree_parsimony_scores(),
                                  jeng.top_tree_parsimony_scores())
    for eng in (jeng, teng):
        eng.optimize_branch_lengths(max_iter=1)
    np.testing.assert_allclose(teng.branch_lengths, jeng.branch_lengths,
                               rtol=1e-8, atol=0)
    assert max_rel(teng.top_tree_log_likelihoods(),
                   jeng.top_tree_log_likelihoods()) < 1e-10


def test_tp_engine_compat_maps(tmp_path):
    jeng, teng = _engines(tmp_path, seed=4, taxa=6, sites=120)
    for name in ("build_map_from_pcsp_to_branch_length",
                 "build_map_from_pcsp_to_edge_choice_pcsps",
                 "build_map_of_tree_id_to_top_topologies",
                 "to_newick_of_top_trees", "to_newick_of_top_topologies",
                 "plv_count", "get_use_best_edge_map"):
        assert getattr(teng, name)() == getattr(jeng, name)(), name
    for use_parsimony in (False, True):
        got = teng.build_map_from_pcsp_to_score(use_parsimony)
        want = jeng.build_map_from_pcsp_to_score(use_parsimony)
        assert got.keys() == want.keys()
        assert max_rel(list(got.values()), list(want.values())) < 1e-10
    for e in (0, 3):
        assert teng.get_central_edge_pcsp(e) == jeng.get_central_edge_pcsp(e)
        assert (teng.get_top_tree_topology_with_edge(e).key()
                == jeng.get_top_tree_topology_with_edge(e).key())
        for use_parsimony in (False, True):
            assert abs(teng.get_top_tree_score(e, use_parsimony)
                       - jeng.get_top_tree_score(e, use_parsimony)) <= (
                1e-10 * abs(jeng.get_top_tree_score(e, use_parsimony)))
