"""The port's scan tape (treelike/pruning.py) against bito_tpu's, function
by function, on the same tapes and model ingredients, in float64.

Tolerances: P and the buffers within 1e-12 absolute (their entries are
O(1)); log likelihoods and gradients within 1e-10 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu.treelike import pruning as jpr
from bito_tpu_torch.treelike import pruning as tpr

from torch_port_cases import (MODELS, jax_engine, jax_params, make_case,
                              max_norm, max_rel, per_tree_rows, torch_engine,
                              torch_params)

CASES = [("gtr_gamma4", False), ("gtr_gamma4", True), ("jc69", False),
         ("hky_weibull4", True)]


def _setup(model, rooted, per_tree=False):
    case = make_case(seed=11, num_taxa=8, num_trees=4, rooted=rooted)
    params = MODELS[model][1]
    if per_tree:
        params = per_tree_rows(params, 4, seed=3)
    je, te = jax_engine(case, model), torch_engine(case, model)
    jenc, tenc = je.encode(case.jax_trees), te.encode(case.torch_trees)
    jbl = je.branch_length_matrix(case.jax_trees, jenc)
    tbl = te.branch_length_matrix(case.torch_trees, tenc)
    jing = je._model_ingredients(jax_params(params), 4)
    ting = te._model_ingredients(torch_params(params), 4)
    return je, te, jenc, tenc, jbl, tbl, jing, ting


def _n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("model,rooted", CASES)
def test_transition_matrices_ext(model, rooted):
    *_, jbl, tbl, (jeig, jr, _jp, jc), (teig, tr, _tp, tc) = _setup(model, rooted)
    for derivative in (False, True):
        ref = jpr.transition_matrices_ext(jeig, jbl, jr, jc,
                                          derivative=derivative)
        got = tpr.transition_matrices_ext(teig, tbl, tr, tc,
                                          derivative=derivative)
        np.testing.assert_allclose(_n(got), _n(ref), rtol=0, atol=1e-12)


@pytest.mark.parametrize("model,rooted", CASES)
def test_postorder_and_root(model, rooted):
    je, te, jenc, tenc, jbl, tbl, jing, ting = _setup(model, rooted)
    (jeig, jr, jp, jc), (teig, tr, tp, tc) = jing, ting
    C = te.model.category_count
    jP = jpr.transition_matrices_ext(jeig, jbl, jr, jc)
    tP = tpr.transition_matrices_ext(teig, tbl, tr, tc)
    jbuf, jls = jpr.init_partials(je.tip_partials, 4, jenc.num_slots, C,
                                  je.pattern_pad)
    tbuf, tls = tpr.init_partials(te.tip_partials, 4, tenc.num_slots, C,
                                  te.pattern_pad)
    np.testing.assert_array_equal(_n(tbuf), _n(jbuf))
    jbuf, jls = jpr.postorder_pass(jnp.asarray(jenc.post_ops), jP, jbuf, jls)
    post_ops = torch.as_tensor(tenc.post_ops, dtype=torch.long)
    tbuf, tls = tpr.postorder_pass(post_ops, tP, tbuf, tls)
    np.testing.assert_allclose(_n(tbuf), _n(jbuf), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_n(tls), _n(jls), rtol=0, atol=1e-10)
    root = torch.as_tensor(tenc.root, dtype=torch.long)
    ref = jpr.root_log_likelihood(jbuf, jls, jnp.asarray(jenc.root),
                                  jeig.pi, jp)
    got = tpr.root_log_likelihood(tbuf, tls, root, teig.pi, tp)
    assert max_rel(_n(got)[:, :je.site_pattern.pattern_count],
                   _n(ref)[:, :je.site_pattern.pattern_count]) < 1e-10


# Per-tree rows for every model that has parameters (JC69 has none).
IMPL_CASES = [(m, r, pt) for m, r in CASES for pt in (False, True)
              if MODELS[m][1] or not pt]


@pytest.mark.parametrize("model,rooted,per_tree", IMPL_CASES)
def test_impls(model, rooted, per_tree):
    je, te, jenc, tenc, jbl, tbl, jing, ting = _setup(model, rooted, per_tree)
    C = te.model.category_count
    kw = dict(num_slots=tenc.num_slots, pattern_pad=te.pattern_pad,
              category_count=C)
    post, pre, root = (torch.as_tensor(x, dtype=torch.long)
                       for x in (tenc.post_ops, tenc.pre_ops, tenc.root))
    mask = torch.as_tensor(tenc.edge_mask, dtype=torch.float64)
    ll_ref = jpr.log_likelihoods_impl(
        jnp.asarray(jenc.post_ops), jnp.asarray(jenc.root), je.tip_partials,
        je.weights, jbl, *jing, None, **kw)
    ll = tpr.log_likelihoods_impl(post, root, te.tip_partials, te.weights,
                                  tbl, *ting, **kw)
    assert max_rel(_n(ll), _n(ll_ref)) < 1e-10
    ll_ref, g_ref = jpr.ll_and_branch_gradients_impl(
        jnp.asarray(jenc.post_ops), jnp.asarray(jenc.pre_ops),
        jnp.asarray(jenc.root), jnp.asarray(jenc.edge_mask, jnp.float64),
        je.tip_partials, je.weights, jbl, *jing, None, **kw)
    ll, g = tpr.ll_and_branch_gradients_impl(
        post, pre, root, mask, te.tip_partials, te.weights, tbl, *ting, **kw)
    assert max_rel(_n(ll), _n(ll_ref)) < 1e-10
    assert max_norm(_n(g), _n(g_ref)) < 1e-10


@pytest.mark.parametrize("model,rooted", CASES)
def test_differentiable_log_likelihoods_match_autograd(model, rooted):
    """log_likelihoods_differentiable: log_likelihoods_impl's values, and
    its adjoint backward (one preorder) equal to autograd through the
    tape, for the rate matrix's ingredients, pi, the proportions, the
    category rates and the branch lengths, per tree."""
    _, te, _, tenc, _, tbl, _, ting = _setup(model, rooted)
    post, pre, root, _ = te._scan_tapes(tenc)
    kw = dict(num_slots=tenc.num_slots, pattern_pad=te.pattern_pad)
    eig, rates, props, clock = ting
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (eig.U, eig.values, eig.U_inv, eig.pi, rates, props,
                        tbl)]
    U, values, U_inv, pi, rates, props, bl = leaves
    eig = type(eig)(U, values, U_inv, pi)
    weights = torch.randn(4, dtype=tbl.dtype)  # a cotangent per tree
    got = tpr.log_likelihoods_differentiable(
        post, pre, root, te.tip_partials, te.weights, bl, eig, rates, props,
        clock, **kw)
    want = tpr.log_likelihoods_impl(
        post, root, te.tip_partials, te.weights, bl, eig, rates, props,
        clock, category_count=te.model.category_count, **kw)
    assert max_rel(got.detach().numpy(), want.detach().numpy()) < 1e-12
    g_got = torch.autograd.grad(got @ weights, leaves)
    g_want = torch.autograd.grad(want @ weights, leaves)
    for a, b in zip(g_got, g_want, strict=True):
        assert max_norm(a.numpy(), b.numpy()) < 1e-10
