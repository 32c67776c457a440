"""The per-node kernels' plain versions (treelike/pernode.py) against
bito_tpu's pallas_pruning kernels (`pallas_log_likelihoods`,
`pallas_ll_and_gradients`) run in interpret mode on the CPU, on the same
trees, alignment and parameters, with operands prepared as
scripts/bench_kernel_race.py prepares them (dP from the eigen
derivative).  Both root shapes: trifurcating (unrooted trees, whose tape
has an accumulator op) and binary (rooted trees, whose root's children
read the dummy slot as their missing sibling).

Bounds: the float32 plain versions within 1e-5 relative of the Pallas
kernels on log likelihoods and within 5e-5 of the largest gradient
(bench.py's guard); in float64 the plain versions agree with the port's
scan tape within 1e-10."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu.treelike import pallas_pruning
from bito_tpu_torch.treelike import pernode

from torch_port_cases import (GTR, MODELS, jax_engine, jax_params, make_case,
                              max_norm, max_rel, pernode_operands,
                              torch_engine, torch_params)

B = 4


@pytest.fixture(scope="module", params=[False, True], ids=["trifurcating",
                                                            "binary"])
def pallas_case(request):
    """9 taxa x 150 patterns x 4 trees, GTR+Gamma4: the Pallas kernels in
    interpret mode, the float64 scan engine, and the port's operands."""
    case = make_case(seed=31, num_taxa=9, num_sites=150, num_trees=B,
                     rooted=request.param)
    je = jax_engine(case, "gtr_gamma4")
    jp = jax_params(GTR)
    enc = je.encode(case.jax_trees)
    bl = je.branch_length_matrix(case.jax_trees, enc)
    eig, rates, props, clock = je._model_ingredients(jp, B)
    sp = je.site_pattern
    tips = jnp.asarray(sp.tip_partials(), jnp.float32)
    tapes = [jnp.asarray(x) for x in (enc.post_ops, enc.pre_ops, enc.root)]
    static = dict(num_slots=enc.num_slots, category_count=4,
                  s_tile=je._pallas_s_tile(), interpret=True)
    P_blk, tips_flat, piprop, w = pallas_pruning.prepare_inputs(
        enc, tips, sp.weights, eig, rates, props, clock, bl, je.pattern_pad)
    llo_pl = pallas_pruning.pallas_log_likelihoods(
        tapes[0], tapes[2], P_blk, tips_flat, piprop, w, **static)
    ll_pl, g_pl = pallas_pruning.pallas_ll_and_gradients(
        *tapes, jnp.asarray(enc.edge_mask, jnp.float32),
        *pallas_pruning.prepare_inputs_grad(
            enc, tips, sp.weights, eig, rates, props, clock, bl,
            je.pattern_pad),
        **static)
    ll_ref, g_ref = je.ll_and_branch_gradients(case.jax_trees, jp)
    te = torch_engine(case, "gtr_gamma4")
    return dict(
        pallas=(np.asarray(ll_pl), np.asarray(g_pl), np.asarray(llo_pl)),
        scan=(np.asarray(ll_ref), np.asarray(g_ref)),
        operands=pernode_operands(te, case, GTR))


def test_ll_plain_matches_pallas_interpret(pallas_case):
    ops, _ = pallas_case["operands"]
    ll = pernode.pernode_log_likelihoods_ref(**ops)
    assert ll.dtype == torch.float32
    ll_pl, _, llo_pl = pallas_case["pallas"]
    assert max_rel(ll.numpy(), llo_pl) < 1e-5
    assert max_rel(ll.numpy(), ll_pl) < 1e-5
    assert max_rel(ll.numpy(), pallas_case["scan"][0]) < 1e-5


def test_grad_plain_matches_pallas_interpret(pallas_case):
    ops, extra = pallas_case["operands"]
    ll, g = pernode.pernode_ll_and_gradients_ref(**ops, **extra)
    ll_pl, g_pl, _ = pallas_case["pallas"]
    assert g.shape == g_pl.shape
    assert max_rel(ll.numpy(), ll_pl) < 1e-5
    assert max_norm(g.numpy(), g_pl) < 5e-5
    ll_ref, g_ref = pallas_case["scan"]
    assert max_rel(ll.numpy(), ll_ref) < 1e-5
    assert max_norm(g.numpy(), g_ref) < 5e-5


@pytest.mark.parametrize("model,rooted", [
    ("gtr_gamma4", False), ("gtr_gamma4", True), ("jc69", True),
    ("hky_weibull4", True)])
def test_plain_in_float64_matches_scan(model, rooted):
    """In float64 the plain versions agree with the port's scan engine
    within 1e-10."""
    case = make_case(seed=41, num_taxa=8, num_trees=B, rooted=rooted)
    te = torch_engine(case, model)
    params = MODELS[model][1]
    ops, extra = pernode_operands(te, case, params, dtype=torch.float64)
    ll_ref, g_ref = (x.numpy() for x in te.ll_and_branch_gradients(
        case.torch_trees, torch_params(params)))
    ll, g = pernode.pernode_ll_and_gradients_ref(**ops, **extra)
    assert max_rel(ll.numpy(), ll_ref) < 1e-10
    assert max_norm(g.numpy(), g_ref) < 1e-10
    assert max_rel(pernode.pernode_log_likelihoods_ref(**ops).numpy(),
                   ll_ref) < 1e-10


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    case = make_case(seed=51, num_taxa=8, num_trees=B, rooted=True)
    ops, extra = pernode_operands(torch_engine(case, "gtr_gamma4"), case, GTR)
    launchers = (pernode.pernode_ll_onchip, pernode.pernode_ll_global,
                 pernode.pernode_grad_onchip, pernode.pernode_grad_global)
    before = [f.launches for f in launchers]
    torch.testing.assert_close(pernode.pernode_log_likelihoods(**ops),
                               pernode.pernode_log_likelihoods_ref(**ops),
                               rtol=0, atol=0)
    got = pernode.pernode_ll_and_gradients(**ops, **extra)
    want = pernode.pernode_ll_and_gradients_ref(**ops, **extra)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [f.launches for f in launchers] == before


def test_operand_shapes_are_checked():
    case = make_case(seed=51, num_taxa=8, num_trees=B)
    ops, _ = pernode_operands(torch_engine(case, "gtr_gamma4"), case, GTR)
    pernode._check_shapes(**ops)
    with pytest.raises(ValueError, match="root"):
        pernode._check_shapes(**dict(ops, root=ops["root"][:-1]))
    with pytest.raises(ValueError, match="post_ops"):
        pernode._check_shapes(**dict(ops, post_ops=ops["post_ops"][..., :4]))
