"""The port's levelized tapes (pruning.*_leveled, the engine's use_leveled)
against bito_tpu's leveled impls within 1e-10, and against the port's own
scan tape, on the CPU in float64: unrooted trees (a trifurcating root,
whose third child takes an op of its own) and rooted ones, a shared model
and per-tree rows."""
import numpy as np
import pytest
import torch

from bito_tpu.treelike import pruning as jax_pruning
from bito_tpu_torch.treelike import pruning

from torch_port_cases import (MODELS, jax_engine, jax_params, make_case,
                              one_torch_thread, per_tree_rows, torch_engine,
                              torch_params)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


BOUND = 1e-10
# (case, per-tree parameter rows): unrooted trees with a shared model,
# rooted ones with a row a tree.
CASES = [(dict(seed=11, num_taxa=8, num_trees=4, rooted=False), False),
         (dict(seed=12, num_taxa=9, num_trees=3, rooted=True), True)]


@pytest.mark.parametrize("kw,per_tree", CASES)
def test_engine_leveled_matches_bito_tpu_and_the_scan_tape(kw, per_tree):
    case = make_case(**kw)
    params = MODELS["gtr_gamma4"][1]
    if per_tree:
        params = per_tree_rows(params, kw["num_trees"], kw["seed"])
    je, te = jax_engine(case, "gtr_gamma4"), torch_engine(case, "gtr_gamma4")
    je.use_leveled = te.use_leveled = True
    te.kernel = "cuda"  # leveled takes the scan route whatever kernel says
    jp, tp = jax_params(params), torch_params(params)
    j_ll = np.asarray(je.log_likelihoods(case.jax_trees, jp))
    j_g = np.asarray(je.ll_and_branch_gradients(case.jax_trees, jp)[1])
    t_ll = te.log_likelihoods(case.torch_trees, tp).numpy()
    t_ll2, t_g = (x.numpy() for x in te.ll_and_branch_gradients(
        case.torch_trees, tp))
    np.testing.assert_allclose(t_ll, j_ll, rtol=0, atol=BOUND)
    np.testing.assert_allclose(t_ll2, j_ll, rtol=0, atol=BOUND)
    np.testing.assert_allclose(t_g, j_g, rtol=0, atol=BOUND)
    assert te._route(not per_tree) == "scan"
    te.use_leveled = False
    te.kernel = "scan"
    s_ll, s_g = (x.numpy() for x in te.ll_and_branch_gradients(
        case.torch_trees, tp))
    np.testing.assert_allclose(t_ll, s_ll, rtol=0, atol=BOUND)
    np.testing.assert_allclose(t_g, s_g, rtol=0, atol=BOUND)


@pytest.mark.parametrize("rescale", [True, False])
def test_leveled_impls_match_bito_tpus(rescale):
    """The impls themselves on one encoding, with and without rescaling:
    the levelized tapes are bito_tpu's (encode.py is a pinned copy)."""
    case = make_case(seed=13, num_taxa=7, num_trees=3)
    params = MODELS["hky_weibull4"][1]
    je, te = jax_engine(case, "hky_weibull4"), torch_engine(case,
                                                            "hky_weibull4")
    jlev, lev = (e.encode_leveled(t) for e, t in ((je, case.jax_trees),
                                                  (te, case.torch_trees)))
    np.testing.assert_array_equal(jlev.post_levels, lev.post_levels)
    B, N = len(case.torch_trees), lev.num_slots
    jeig = je._model_ingredients(jax_params(params), B)
    teig = te._model_ingredients(torch_params(params), B)
    bl = te.branch_length_matrix(case.torch_trees, te.encode(case.torch_trees))
    kw = dict(num_slots=N, pattern_pad=te.pattern_pad,
              category_count=te.model.category_count, rescale=rescale)
    j_ll, j_g = jax_pruning.ll_and_branch_gradients_leveled_impl(
        jlev.post_levels, jlev.pre_levels, jlev.root,
        np.asarray(jlev.edge_mask, dtype=np.float64), je.tip_partials,
        je.weights, bl.numpy(), *jeig, **kw)
    j_ll_only = jax_pruning.log_likelihoods_leveled_impl(
        jlev.post_levels, jlev.root, je.tip_partials, je.weights,
        bl.numpy(), *jeig, **kw)
    ints = [torch.as_tensor(x, dtype=torch.long) for x in (
        lev.post_levels, lev.pre_levels, lev.root)]
    mask = torch.as_tensor(lev.edge_mask, dtype=torch.float64)
    t_ll, t_g = pruning.ll_and_branch_gradients_leveled_impl(
        *ints, mask, te.tip_partials, te.weights, bl, *teig, **kw)
    t_ll_only = pruning.log_likelihoods_leveled_impl(
        ints[0], ints[2], te.tip_partials, te.weights, bl, *teig, **kw)
    np.testing.assert_allclose(t_ll.numpy(), np.asarray(j_ll), rtol=0,
                               atol=BOUND)
    np.testing.assert_allclose(t_ll_only.numpy(), np.asarray(j_ll_only),
                               rtol=0, atol=BOUND)
    np.testing.assert_allclose(t_g.numpy(), np.asarray(j_g), rtol=0,
                               atol=BOUND)
