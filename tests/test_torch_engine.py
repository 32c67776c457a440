"""The port's TreeLikelihoodEngine against bito_tpu's scan engine on the
same trees, alignment and parameters.

In float64 on the CPU the two must agree within 1e-10 relative on log
likelihoods and within 1e-10 of the largest gradient on gradients (the
same arithmetic in another order).  kernel="cuda" on the CPU runs the
paired kernels' plain versions in float32: within 1e-5 relative on log
likelihoods and 5e-5 of the largest gradient (bench.py's guard)."""
import numpy as np
import pytest
import torch

from bito_tpu_torch.treelike import paired

from torch_port_cases import (MODELS, jax_engine, jax_params, make_case,
                              max_norm, max_rel, per_tree_rows,
                              torch_engine, torch_params)

# (model, rooted, per-tree parameter rows, batch size)
CASES = [
    ("gtr_gamma4", False, False, 4),
    ("gtr_gamma4", False, True, 4),
    ("gtr_gamma4", True, False, 3),
    ("gtr_gamma4", True, True, 3),
    ("jc69", False, False, 3),
    ("hky_weibull4", False, True, 4),
    ("hky_weibull4", True, False, 4),
]


def _engines(model, rooted, per_tree, batch, seed=21):
    case = make_case(seed=seed, num_taxa=8, num_trees=batch, rooted=rooted)
    params = MODELS[model][1]
    if per_tree:
        params = per_tree_rows(params, batch, seed=seed)
    return case, params, jax_engine(case, model), torch_engine(case, model)


@pytest.mark.parametrize("model,rooted,per_tree,batch", CASES)
def test_engine_matches_bito_tpu_scan(model, rooted, per_tree, batch):
    case, params, je, te = _engines(model, rooted, per_tree, batch)
    jp, tp = jax_params(params), torch_params(params)
    assert not te._use_cuda(te._shared_model(tp))  # auto: scan on the CPU

    ll_ref = np.asarray(je.log_likelihoods(case.jax_trees, jp))
    ll = te.log_likelihoods(case.torch_trees, tp).numpy()
    assert max_rel(ll, ll_ref) < 1e-10

    ll_ref, g_ref = (np.asarray(x) for x in
                     je.ll_and_branch_gradients(case.jax_trees, jp))
    ll, g = (x.numpy() for x in te.ll_and_branch_gradients(case.torch_trees, tp))
    assert g.shape == g_ref.shape == (batch, te.encode(case.torch_trees).num_slots)
    assert max_rel(ll, ll_ref) < 1e-10
    assert max_norm(g, g_ref) < 1e-10

    # branch_eval_fn / ll_eval_fn on scaled branch lengths.
    jenc = je.encode(case.jax_trees)
    jbl = je.branch_length_matrix(case.jax_trees, jenc) * 1.1
    tbl = te.branch_length_matrix(case.torch_trees,
                                  te.encode(case.torch_trees)) * 1.1
    ll_ref, g_ref = (np.asarray(x) for x in je.branch_eval_fn(case.jax_trees, jp)(jbl))
    ll, g = (x.numpy() for x in te.branch_eval_fn(case.torch_trees, tp)(tbl))
    assert max_rel(ll, ll_ref) < 1e-10
    assert max_norm(g, g_ref) < 1e-10
    ll = te.ll_eval_fn(case.torch_trees, tp)(tbl).numpy()
    assert max_rel(ll, np.asarray(je.ll_eval_fn(case.jax_trees, jp)(jbl))) < 1e-10


@pytest.mark.parametrize("model", ["gtr_gamma4", "hky_weibull4"])
def test_gradient_matches_finite_difference(model):
    """d logL / d t against a central difference, 1e-6 relative."""
    case, params, _je, te = _engines(model, rooted=False, per_tree=False,
                                     batch=2)
    tp = torch_params(params)
    enc = te.encode(case.torch_trees)
    bl = te.branch_length_matrix(case.torch_trees, enc)
    _, g = te.ll_and_branch_gradients(case.torch_trees, tp)
    h = 1e-6
    for node in (0, 5, 9):
        step = torch.zeros_like(bl)
        step[:, node] = h
        fd = (te.log_likelihoods(case.torch_trees, tp, bl + step)
              - te.log_likelihoods(case.torch_trees, tp, bl - step)) / (2 * h)
        np.testing.assert_allclose(g[:, node].numpy(), fd.numpy(), rtol=1e-6)


@pytest.mark.parametrize("model,rooted,batch", [
    ("gtr_gamma4", False, 4), ("gtr_gamma4", True, 3), ("jc69", False, 4)])
def test_kernel_path_on_cpu_runs_the_plain_versions(model, rooted, batch):
    """kernel="cuda" with CPU tensors takes the paired kernels' plain
    versions (float32) and launches nothing."""
    case, params, je, te = _engines(model, rooted, False, batch)
    te.kernel = "cuda"
    launches = (paired.paired_log_likelihoods.launches,
                paired.paired_ll_and_gradients.launches)
    jp, tp = jax_params(params), torch_params(params)
    ll_ref, g_ref = (np.asarray(x) for x in
                     je.ll_and_branch_gradients(case.jax_trees, jp))
    ll, g = (x.numpy() for x in te.ll_and_branch_gradients(case.torch_trees, tp))
    assert max_rel(ll, ll_ref) < 1e-5
    assert max_norm(g, g_ref) < 5e-5
    ll = te.log_likelihoods(case.torch_trees, tp).numpy()
    assert max_rel(ll, ll_ref) < 1e-5
    assert (paired.paired_log_likelihoods.launches,
            paired.paired_ll_and_gradients.launches) == launches


def test_kernel_choice():
    case, params, _je, te = _engines("gtr_gamma4", False, False, 2)
    shared = te._shared_model(torch_params(params))
    assert shared and not te._use_cuda(shared)  # CPU: the scan tape
    per_tree = torch_params(per_tree_rows(params, 2, seed=0))
    assert not te._shared_model(per_tree)
    te.kernel = "cuda"
    assert te._use_cuda(shared)
    with pytest.raises(ValueError, match="per-tree"):
        te.log_likelihoods(case.torch_trees, per_tree)
    te.kernel = "pallas"
    with pytest.raises(ValueError):
        te._use_cuda(shared)
    with pytest.raises(ValueError):
        torch_engine(case, "gtr_gamma4", dtype=torch.float16)

