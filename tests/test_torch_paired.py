"""The plain versions of the two paired kernels (treelike/paired.py)
against bito_tpu's Pallas kernels run in interpret mode on the CPU, on the
same trees, alignment and parameters.

The port's plain versions run in float32, as the kernels do.  Bounds: log
likelihoods within 1e-5 relative; gradients within 5e-5 of the largest
gradient (bench.py's parity metric and guard).  The Pallas kernels' own
error against the float64 scan is about 5e-7 (LL) and 3e-6 (gradients) at
this size."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu.treelike import pallas_paired, pallas_pruning
from bito_tpu_torch.models.substitution import rate_matrix_of
from bito_tpu_torch.treelike import paired, prep, pruning

from torch_port_cases import (GTR, MODELS, jax_engine, jax_params, make_case,
                              max_norm, max_rel, torch_engine, torch_params)

B = 4


def _port_operands(te, case, params, dtype=torch.float32):
    enc = te.encode(case.torch_trees)
    bl = te.branch_length_matrix(case.torch_trees, enc)
    eig, rates, props, clock = te._model_ingredients(torch_params(params), B)
    dst, tip, src, e, mask = te._paired_tapes(enc)
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl)
    ops = dict(post_dst=dst, tip_slot=tip, post_e=e, P=P.to(dtype),
               tips=te._kernel_tips.to(dtype), pi=pi.to(dtype),
               props=prop.to(dtype), weights=te._kernel_weights.to(dtype))
    return ops, dict(post_src=src, edge_mask=mask, dP=dP.to(dtype))


@pytest.fixture(scope="module")
def pallas_case():
    """9 taxa x 150 patterns x 4 trees, GTR+Gamma4: the Pallas kernels in
    interpret mode, the float64 scan engine, and the port's operands."""
    case = make_case(seed=31, num_taxa=9, num_sites=150, num_trees=B)
    je = jax_engine(case, "gtr_gamma4")
    jp = jax_params(GTR)
    enc = je.encode(case.jax_trees)
    bl = je.branch_length_matrix(case.jax_trees, enc)
    eig, rates, props, clock = je._model_ingredients(jp, B)
    sp = je.site_pattern
    P_blk, dP_blk, tips_flat, pivec, propvec, w = (
        pallas_pruning.prepare_inputs_grad_q(
            enc, jnp.asarray(sp.tip_partials(), jnp.float32), sp.weights,
            eig, rates, props, clock, bl, je.pattern_pad))
    pe = pallas_paired.build_paired_encoding(enc)
    tapes = [jnp.asarray(x) for x in (pe.post_dst, pe.tip_slot, pe.post_src,
                                      pe.post_e)]
    static = dict(M=pe.M, T=pe.num_taxa, CA=pivec.shape[1],
                  n_pair_slots=pe.n_pair_slots, s_tile=je._pallas_s_tile(),
                  group=1, interpret=True)
    ll_pl, g_pl = pallas_paired.paired_ll_and_gradients(
        *tapes, jnp.asarray(enc.edge_mask, jnp.float32), P_blk, dP_blk,
        tips_flat, pivec, propvec, w, num_slots=enc.num_slots, **static)
    llo_pl = pallas_paired.paired_log_likelihoods(
        tapes[0], tapes[1], P_blk, tapes[3], tips_flat, pivec * propvec, w,
        **static)
    ll_ref, g_ref = je.ll_and_branch_gradients(case.jax_trees, jp)
    te = torch_engine(case, "gtr_gamma4")
    return dict(
        pallas=(np.asarray(ll_pl), np.asarray(g_pl), np.asarray(llo_pl)),
        scan=(np.asarray(ll_ref), np.asarray(g_ref)),
        operands=_port_operands(te, case, GTR))


def test_ll_plain_matches_pallas_interpret(pallas_case):
    ops, _ = pallas_case["operands"]
    ll = paired.paired_log_likelihoods_ref(**ops)
    assert ll.dtype == torch.float32
    ll_pl, _, llo_pl = pallas_case["pallas"]
    assert max_rel(ll.numpy(), llo_pl) < 1e-5
    assert max_rel(ll.numpy(), ll_pl) < 1e-5
    assert max_rel(ll.numpy(), pallas_case["scan"][0]) < 1e-5


def test_grad_plain_matches_pallas_interpret(pallas_case):
    ops, extra = pallas_case["operands"]
    ll, g = paired.paired_ll_and_gradients_ref(**ops, **extra)
    ll_pl, g_pl, _ = pallas_case["pallas"]
    assert max_rel(ll.numpy(), ll_pl) < 1e-5
    assert max_norm(g.numpy(), g_pl) < 5e-5
    ll_ref, g_ref = pallas_case["scan"]
    assert max_rel(ll.numpy(), ll_ref) < 1e-5
    assert max_norm(g.numpy(), g_ref) < 5e-5


@pytest.mark.parametrize("model,rooted", [
    ("gtr_gamma4", False), ("gtr_gamma4", True), ("jc69", False),
    ("hky_weibull4", True)])
def test_plain_in_float64_matches_scan(model, rooted):
    """The paired-slot algorithm itself, without f32 rounding: in float64
    the plain versions agree with the port's scan tape within 1e-10."""
    case = make_case(seed=41, num_taxa=8, num_trees=B, rooted=rooted)
    te = torch_engine(case, model)
    params = MODELS[model][1]
    ops, extra = _port_operands(te, case, params, dtype=torch.float64)
    # Replace the float32-rounded model operands by float64 ones.
    enc = te.encode(case.torch_trees)
    bl = te.branch_length_matrix(case.torch_trees, enc)
    eig, rates, props, clock = te._model_ingredients(torch_params(params), B)
    P = pruning.transition_matrices_ext(eig, bl, rates, clock)
    QC = (rates * clock[:, None])[:, :, None, None] * rate_matrix_of(eig)[:, None]
    dP = QC[:, None] @ P
    dP[:, -1] = 0.0
    ops.update(P=P, pi=eig.pi[0], props=props[0])
    extra.update(dP=dP)
    ll_ref, g_ref = (x.numpy() for x in te.ll_and_branch_gradients(
        case.torch_trees, torch_params(params)))
    ll, g = paired.paired_ll_and_gradients_ref(**ops, **extra)
    assert max_rel(ll.numpy(), ll_ref) < 1e-10
    assert max_norm(g.numpy(), g_ref) < 1e-10
    assert max_rel(paired.paired_log_likelihoods_ref(**ops).numpy(),
                   ll_ref) < 1e-10


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    case = make_case(seed=51, num_taxa=8, num_trees=B)
    ops, extra = _port_operands(torch_engine(case, "gtr_gamma4"), case, GTR)
    before = (paired.paired_log_likelihoods.launches,
              paired.paired_ll_and_gradients.launches)
    torch.testing.assert_close(paired.paired_log_likelihoods(**ops),
                               paired.paired_log_likelihoods_ref(**ops),
                               rtol=0, atol=0)
    got = paired.paired_ll_and_gradients(**ops, **extra)
    want = paired.paired_ll_and_gradients_ref(**ops, **extra)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (paired.paired_log_likelihoods.launches,
            paired.paired_ll_and_gradients.launches) == before


def test_operand_shapes_are_checked():
    case = make_case(seed=51, num_taxa=8, num_trees=B)
    ops, _ = _port_operands(torch_engine(case, "gtr_gamma4"), case, GTR)
    paired._check_shapes(**ops)
    bad = dict(ops, weights=ops["weights"][:-1])
    with pytest.raises(ValueError, match="weights"):
        paired._check_shapes(**bad)
    with pytest.raises(ValueError, match="categories"):
        paired._check_cuda_operands({}, {}, C=paired.MAX_CATEGORIES + 1, A=4)
