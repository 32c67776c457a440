"""The paired kernels at 9-32 rate categories, on the CPU: what runs here
of them.

  - the float64 emulation of the on-chip bodies' schedule
    (tests/torch_port_cases.py) at G = 16 and 32 lanes a pattern (C = 9,
    16, 32) against the plain versions, within 1e-10;
  - the plain versions at C = 12 against bito_tpu's Pallas paired kernels
    in interpret mode (CA = 48 needs no category padding there), within
    1e-5 (LL, relative) and 5e-5 (gradients, of the largest), bench.py's
    guard;
  - the port's float64 engine at gamma+12 and weibull+16, on the paired
    route (the plain versions) and the scan tape, against bito_tpu's
    float64 scan engine, within 1e-10;
  - the on-chip plans and shared-memory sizes at 16 and 32 lanes;
  - the engine's route: auto takes the paired kernels on a card for a
    shared 4-state model of 1-32 categories and the scan tape past 32
    (and past 8 at 64 states), decided without a card;
  - the chunked, per-node and A=64 kernels' own limits of 8 categories.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu.models.phylo_model import PhyloModel as JaxModel
from bito_tpu.models.phylo_model import PhyloModelSpecification as JaxSpec
from bito_tpu.treelike import pallas_paired, pallas_pruning
from bito_tpu.treelike.engine import TreeLikelihoodEngine as JaxEngine
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.treelike import chunked, paired, pernode, prep
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

from torch_port_cases import (GTR, emulate_grad, emulate_ll, jax_params,
                              make_case, max_norm, max_rel, torch_params)

F64 = torch.float64


def _engines(case, spec, dtype=F64):
    """bito_tpu's float64 scan engine and the port's engine, on the CPU."""
    je = JaxEngine(case.jax_pattern, JaxModel(JaxSpec(*spec)))
    je.kernel = "scan"
    te = TreeLikelihoodEngine(case.torch_pattern,
                              PhyloModel(PhyloModelSpecification(*spec)),
                              device="cpu", dtype=dtype)
    return je, te


def _operands(te, trees, params, dtype=F64):
    """The paired kernels' operands of the port's engine in `dtype`, and
    the on-chip tape."""
    enc = te.encode(trees)
    bl = te.branch_length_matrix(trees, enc)
    eig, rates, props, clock = te._model_ingredients(params, len(trees))
    dst, tip, src, e, mask = te._paired_tapes(enc)
    pi, prop = prep.kernel_model(eig, props, dtype)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl, dtype)
    ops = dict(post_dst=dst, tip_slot=tip, post_e=e, P=P,
               tips=te._kernel_tips.to(dtype), pi=pi, props=prop,
               weights=te._kernel_weights.to(dtype))
    extra = dict(post_src=src, edge_mask=mask.to(dtype), dP=dP)
    return ops, extra, paired.onchip_tape(dst.numpy(), tip.numpy(), "cpu")


@pytest.mark.parametrize("C", [9, 16, 32])
def test_emulation_matches_the_plain_versions_past_8_categories(C):
    """The on-chip bodies' schedule (rows by liveness and by producer op,
    tips in place, one power-of-two rescale over all of a pattern's
    lanes) in float64 against the plain versions, within 1e-10."""
    case = make_case(seed=90 + C, num_taxa=7, num_sites=30, num_trees=2)
    _, te = _engines(case, ("GTR", f"gamma+{C}"))
    ops, extra, onchip = _operands(te, case.torch_trees, torch_params(GTR))
    assert paired.lanes(C) == (16 if C <= 16 else 32)
    ll = emulate_ll(ops["post_dst"], onchip.child, onchip.live_row,
                    ops["post_e"], ops["P"], ops["tips"], ops["pi"],
                    ops["props"], ops["weights"])
    ll2, g = emulate_grad(ops["post_dst"], onchip.child, extra["post_src"],
                          ops["post_e"], extra["edge_mask"], ops["P"],
                          extra["dP"], ops["tips"], ops["pi"], ops["props"],
                          ops["weights"])
    ll_ref, g_ref = paired.paired_ll_and_gradients_ref(**ops, **extra)
    assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10
    assert max_rel(ll2.numpy(), ll_ref.numpy()) < 1e-10
    assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10


def test_plain_versions_match_pallas_interpret_at_12_categories():
    """5 taxa x 32 patterns x 2 trees, GTR+Gamma12: bito_tpu's Pallas
    paired kernels in interpret mode against the port's plain versions in
    float32 on the port's operands."""
    B, spec = 2, ("GTR", "gamma+12")
    case = make_case(seed=17, num_taxa=5, num_sites=32, num_trees=B)
    je, te = _engines(case, spec)
    assert je._padded_categories() == 12
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
    assert static["CA"] == 48
    ll_pl, g_pl = pallas_paired.paired_ll_and_gradients(
        *tapes, jnp.asarray(enc.edge_mask, jnp.float32), P_blk, dP_blk,
        tips_flat, pivec, propvec, w, num_slots=enc.num_slots, **static)
    llo_pl = pallas_paired.paired_log_likelihoods(
        tapes[0], tapes[1], P_blk, tapes[3], tips_flat, pivec * propvec, w,
        **static)
    ops, extra, _ = _operands(te, case.torch_trees, torch_params(GTR),
                              torch.float32)
    ll = paired.paired_log_likelihoods(**ops)
    ll2, g = paired.paired_ll_and_gradients(**ops, **extra)
    assert ll.dtype == torch.float32
    assert max_rel(ll.numpy(), np.asarray(llo_pl)) < 1e-5
    assert max_rel(ll2.numpy(), np.asarray(ll_pl)) < 1e-5
    assert max_norm(g.numpy(), np.asarray(g_pl)) < 5e-5


@pytest.mark.parametrize("spec", [("GTR", "gamma+12"), ("GTR", "weibull+16")],
                         ids=["gamma12", "weibull16"])
def test_float64_engine_matches_bito_tpu_past_8_categories(spec):
    """The port's float64 engine on its paired route (kernel='cuda': the
    plain versions on the CPU) and on the scan tape, against bito_tpu's
    float64 scan engine: LL and branch gradients within 1e-10."""
    case = make_case(seed=23, num_taxa=6, num_sites=60, num_trees=3)
    je, te = _engines(case, spec)
    ll_ref, g_ref = (np.asarray(x) for x in je.ll_and_branch_gradients(
        case.jax_trees, jax_params(GTR)))
    for kernel in ("cuda", "scan"):
        te.kernel = kernel
        ll = te.log_likelihoods(case.torch_trees, torch_params(GTR))
        ll2, g = te.ll_and_branch_gradients(case.torch_trees,
                                            torch_params(GTR))
        assert max_rel(ll.numpy(), ll_ref) < 1e-10, kernel
        assert max_rel(ll2.numpy(), ll_ref) < 1e-10, kernel
        assert max_norm(g.numpy(), g_ref) < 1e-10, kernel


@pytest.mark.parametrize("C", [9, 16, 17, 32])
def test_plan_at_16_and_32_lanes(C):
    """A block takes whole warps of 32 / G patterns (one at G = 32) within
    227 KB and 512 threads; at the flagship (M = 28 ops, N1 = 53 edges,
    25 grad rows, 6 LL rows) the LL body stages the tree's matrices at
    both lane counts, the grad body at G = 16 (9 warps: 106 matrices of
    1 KB) and takes the ring at G = 32 (the matrices alone would take
    217 KB)."""
    G = paired.lanes(C)
    assert G == (16 if C <= 16 else 32)
    ll = paired.onchip_plan("ll", 6, 28, 53, C)
    grad = paired.onchip_plan("grad", 25, 28, 53, C)
    for kernel, rows, plan in (("ll", 6, ll), ("grad", 25, grad)):
        assert plan.lanes == G and plan.cols % (32 // G) == 0
        assert plan.cols * G <= paired.MAX_THREADS
        assert plan.smem == paired.smem_bytes(kernel, rows, 28, 53, C,
                                              plan.cols, plan.ring)
        assert plan.smem <= paired.SMEM_BYTES
        per_op = 2 if kernel == "ll" else 4  # P (and dP) of both children
        mats = 2 * per_op if plan.ring else 53 * per_op // 2
        assert plan.smem == (rows * plan.cols * G * 16 + mats * G * 64
                             + (6 if kernel == "ll" else 7) * 28 * 4)
    assert not ll.ring and ll.cols * G == paired.MAX_THREADS
    assert grad.ring == (G == 32)
    assert grad.cols * G // 32 == (9 if G == 16 else 16)
    assert paired.smem_bytes("grad", 0, 28, 53, C, 0, False) == (
        106 * G * 64 + 784)
    with pytest.raises(ValueError, match="1..32"):
        paired.onchip_plan("ll", 6, 28, 53, 33)


def test_route_takes_the_paired_kernels_to_32_categories():
    """_route on a card device in float32 (the engine built on the CPU and
    then pointed at the card, which is all _route reads): the paired
    kernels for a shared 4-state model of 1-32 categories, the scan tape
    past 32, for per-tree rows and in float64; kernel='cuda' takes the
    paired route at any count (its wrappers raise past 32 on the card)."""
    case = make_case(seed=5, num_taxa=5, num_sites=20, num_trees=1)
    for C, want in ((1, "paired"), (4, "paired"), (9, "paired"),
                    (16, "paired"), (32, "paired"), (33, "scan")):
        te = TreeLikelihoodEngine(
            case.torch_pattern, PhyloModel(PhyloModelSpecification(
                "GTR", "constant" if C == 1 else f"gamma+{C}")),
            device="cpu", dtype=torch.float32)
        assert te._route(True) == "scan"  # on the CPU
        te.device = torch.device("cuda")
        assert te._route(True) == want, C
        assert te._route(False) == "scan"
        te.kernel = "cuda"
        assert te._route(True) == "paired"
        te.kernel, te.dtype = "auto", F64
        assert te._route(True) == "scan"
    assert paired.max_categories(4) == paired.PAIRED_CATEGORIES == 32
    assert paired.max_categories(64) == paired.MAX_CATEGORIES == 8


def test_other_kernel_families_keep_8_categories():
    """The chunked, per-node and A=64 kernels refuse a 9th category, as
    before: their plans, and the operand check their wrappers run on the
    card (paired._check_cuda_operands: 8 by default, max_categories(64)
    for the A=64 kernels), while the 4-state paired kernels' check takes
    32."""
    with pytest.raises(ValueError, match="1..8"):
        chunked.onchip_plan(10, 12, 14, 9)
    with pytest.raises(ValueError, match="1..8"):
        pernode.onchip_plan(25, 232, 53, 9)
    with pytest.raises(ValueError, match="1..8"):
        paired._check_cuda_operands({}, {}, 9, 4)
    with pytest.raises(ValueError, match="1..8"):
        paired._check_cuda_operands({}, {}, 9, 64, paired.KERNEL_STATES,
                                    paired.max_categories(64))
    paired._check_cuda_operands({}, {}, 32, 4, paired.KERNEL_STATES,
                                paired.max_categories(4))
    with pytest.raises(ValueError, match="1..32"):
        paired._check_cuda_operands({}, {}, 33, 4, paired.KERNEL_STATES,
                                    paired.max_categories(4))
