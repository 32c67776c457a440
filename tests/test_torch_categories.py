"""The kernels at 9-32 rate categories, on the CPU: what runs here of
them.

  - the float64 emulation of the paired on-chip bodies' schedule
    (tests/torch_port_cases.py) at G = 16 and 32 lanes a pattern (C = 9,
    16, 32) against the plain versions, within 1e-10 (the chunked and
    per-node on-chip bodies' emulations: test_torch_chunked_onchip.py and
    test_torch_pernode_onchip.py);
  - the float64 emulations of the global lane bodies of the chunked tape
    (csrc/paired_lanes.cuh, which walks it as a paired tape by child code)
    and of the per-node tapes (csrc/pernode_lanes.cuh) against the plain
    versions, within 1e-10, and the slots of the chunked tape that the
    first reads;
  - the plain versions at C = 12 against bito_tpu's Pallas paired,
    chunked and per-node kernels in interpret mode (CA = 48 needs no
    category padding there), within 1e-5 (LL, relative) and 5e-5
    (gradients, of the largest), bench.py's guard;
  - the port's float64 engine at gamma+12 and weibull+16, on the paired
    and chunked routes (the plain versions) and the scan tape, against
    bito_tpu's float64 scan engine, within 1e-10;
  - the on-chip plans and shared-memory sizes at 16 and 32 lanes, of the
    paired, chunked and per-node kernels;
  - the engine's route: auto takes the paired kernels on a card for a
    shared model of 4 or 64 states at any category count, decided
    without a card;
  - the limits: every 4-state family and the A=64 kernels take any count
    C >= 1; the on-chip bodies 1..32, the global bodies past it.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu.models.phylo_model import PhyloModel as JaxModel
from bito_tpu.models.phylo_model import PhyloModelSpecification as JaxSpec
from bito_tpu.treelike import pallas_chunked, pallas_paired, pallas_pruning
from bito_tpu.treelike.engine import TreeLikelihoodEngine as JaxEngine
from bito_tpu_torch import _synthetic
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.core.site_pattern import CodonSitePattern
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.treelike import chunked, paired, pernode, prep
from bito_tpu_torch.treelike.encode import encode_trees
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

from torch_port_cases import (GTR, dummy_child_encoding, emulate_grad,
                              emulate_lanes_chunked, emulate_lanes_pernode,
                              emulate_ll, jax_params, make_case, max_norm,
                              max_rel, one_torch_thread, pernode_operands,
                              torch_params)

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


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
    return ops, extra, paired.onchip_tape(
        dst.numpy(), tip.numpy(), "cpu", post_src=src.numpy(),
        post_e=e.numpy(), edges=P.shape[1])


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
    """The port's float64 engine on its paired and chunked routes
    (kernel='cuda' and 'chunked': the plain versions on the CPU) and on
    the scan tape, against bito_tpu's float64 scan engine: LL and branch
    gradients within 1e-10."""
    case = make_case(seed=23, num_taxa=6, num_sites=60, num_trees=3)
    je, te = _engines(case, spec)
    ll_ref, g_ref = (np.asarray(x) for x in je.ll_and_branch_gradients(
        case.jax_trees, jax_params(GTR)))
    for kernel in ("cuda", "chunked", "scan"):
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
    # Past the largest K (128 categories) the global bodies take every
    # tree; no count below 1.
    assert paired.onchip_plan("ll", 6, 28, 53,
                              paired.ONCHIP_MAX_CATEGORIES + 1) is None
    with pytest.raises(ValueError, match="1 or more"):
        paired.onchip_plan("ll", 6, 28, 53, 0)


def test_route_takes_the_paired_kernels_to_32_categories():
    """_route on a card device in float32 (the engine built on the CPU and
    then pointed at the card, which is all _route reads): the paired
    kernels for a shared model of 4 or 64 states (MG94) at every count,
    33 included (before, auto took the scan tape past 32); the scan tape
    for per-tree rows and in float64; kernel='cuda' takes the paired
    route at any count."""
    case = make_case(seed=5, num_taxa=5, num_sites=20, num_trees=1)
    names = list(case.alignment)
    codons = CodonSitePattern(_synthetic.codon_alignment(6, names, 20, 15),
                              names)
    for (model, sp), (C, want) in itertools.product(
            (("GTR", case.torch_pattern), ("MG94", codons)),
            ((1, "paired"), (4, "paired"), (9, "paired"), (16, "paired"),
             (32, "paired"), (33, "paired"))):
        te = TreeLikelihoodEngine(
            sp, PhyloModel(PhyloModelSpecification(
                model, "constant" if C == 1 else f"gamma+{C}")),
            device="cpu", dtype=torch.float32)
        assert te._route(True) == "scan"  # on the CPU
        te.device = torch.device("cuda")
        assert te._route(True) == want, C
        assert te._route(False) == "scan"
        te.kernel = "cuda"
        assert te._route(True) == "paired"
        te.kernel, te.dtype = "auto", F64
        assert te._route(True) == "scan"
    assert not hasattr(paired, "max_categories")
    assert not hasattr(paired, "PAIRED_CATEGORIES")


def test_other_kernel_families_keep_8_categories():
    """The chunked and per-node kernels take any count, as the 4-state
    paired kernels do: their on-chip plans 1..32 (past it None: the
    global bodies take the tree), and the operand check their wrappers
    run on the card (paired._check_cuda_operands) every count C >= 1 at
    4 and 64 states; a count below 1 raises everywhere."""
    for C in (1, 9, 16, 32, 33, 64, 100):
        on = C <= paired.ONCHIP_CATEGORIES
        assert (chunked.onchip_plan(10, 12, 14, C, least=1) is not None) == on
        assert (pernode.onchip_plan(3, 40, 9, C, least=1) is not None) == on
        paired._check_cuda_operands({}, {}, C, 4, paired.KERNEL_STATES)
        paired._check_cuda_operands({}, {}, C, 64, paired.KERNEL_STATES)
    with pytest.raises(ValueError, match="1 or more"):
        chunked.onchip_plan(10, 12, 14, 0)
    with pytest.raises(ValueError, match="1 or more"):
        pernode.onchip_plan(25, 232, 53, 0)
    with pytest.raises(ValueError, match="1 or more"):
        paired._check_cuda_operands({}, {}, 0, 4, paired.KERNEL_STATES)
    with pytest.raises(ValueError, match="1 or more"):
        paired._check_cuda_operands({}, {}, 0, 64, paired.KERNEL_STATES)
    with pytest.raises(ValueError, match="4-state"):
        paired._check_cuda_operands({}, {}, 9, 64)


# ---------------------------------------------------------------------------
# The chunked and per-node kernels (rows 3-6) past 8 categories
# ---------------------------------------------------------------------------

PALLAS_W = 4  # the chunked Pallas kernels' width, as test_torch_chunked.py's


def _jax_operands(je, case, B):
    """bito_tpu's Pallas operands (P, dP, tips, pi, props, w blocks) of the
    case's trees, and its encoding."""
    enc = je.encode(case.jax_trees)
    bl = je.branch_length_matrix(case.jax_trees, enc)
    eig, rates, props, clock = je._model_ingredients(jax_params(GTR), B)
    sp = je.site_pattern
    return enc, (eig, rates, props, clock, bl), sp


def _chunked_operands(te, trees, params, W, dtype):
    """The chunked tapes at width W and the port's operands in `dtype`,
    with the on-chip tape."""
    enc = te.encode(trees)
    bl = te.branch_length_matrix(trees, enc)
    eig, rates, props, clock = te._model_ingredients(params, len(trees))
    ce = chunked.build_chunked_encoding(enc, W)
    dst, tip, e, row = (torch.as_tensor(x, dtype=torch.int32) for x in (
        ce.post_dst, ce.tip_slot, ce.post_e, ce.node_row))
    pi, prop = prep.kernel_model(eig, props, dtype)
    P, dP = prep.prepare_inputs_grad(eig, rates, clock, bl, dtype)
    ops = dict(post_dst=dst, tip_slot=tip, post_e=e, P=P,
               tips=te._kernel_tips.to(dtype), pi=pi, props=prop,
               weights=te._kernel_weights.to(dtype))
    extra = dict(node_row=row, dP=dP,
                 edge_mask=torch.as_tensor(enc.edge_mask, dtype=dtype))
    return ops, extra, chunked.onchip_tape(ce.post_dst, ce.tip_slot, "cpu")


def test_chunked_plain_versions_match_pallas_interpret_at_12_categories():
    """5 taxa x 32 patterns x 2 trees, GTR+Gamma12, chunk width 4:
    bito_tpu's Pallas chunked kernels in interpret mode (CA = 48) against
    the port's plain versions in float32 on the port's operands."""
    B = 2
    case = make_case(seed=17, num_taxa=5, num_sites=32, num_trees=B)
    je, te = _engines(case, ("GTR", "gamma+12"))
    enc, ingredients, sp = _jax_operands(je, case, B)
    P_blk, dP_blk, tips_flat, pivec, propvec, w = (
        pallas_pruning.prepare_inputs_grad(
            enc, jnp.asarray(sp.tip_partials(), jnp.float32), sp.weights,
            *ingredients, je.pattern_pad))
    assert pivec.shape[1] == 48
    ce = pallas_chunked.build_chunked_encoding(enc, W=PALLAS_W)
    dst, tip, e, row = (jnp.asarray(x) for x in (
        ce.post_dst, ce.tip_slot, ce.post_e, ce.node_row))
    static = dict(Mc=ce.Mc, W=ce.W, T=ce.num_taxa, CA=48,
                  s_tile=je._pallas_s_tile(), group=1, interpret=True)
    ll_pl, g_pl = pallas_chunked.chunked_ll_and_gradients(
        dst, tip, e, row, jnp.asarray(enc.edge_mask, jnp.float32), P_blk,
        dP_blk, tips_flat, pivec, propvec, w, num_slots=enc.num_slots,
        **static)
    llo_pl = pallas_chunked.chunked_log_likelihoods(
        dst, tip, P_blk, e, tips_flat, pivec * propvec, w, **static)
    ops, extra, _ = _chunked_operands(te, case.torch_trees,
                                      torch_params(GTR), PALLAS_W,
                                      torch.float32)
    ll = chunked.chunked_log_likelihoods(**ops)
    ll2, g = chunked.chunked_ll_and_gradients(**ops, **extra)
    assert ll.dtype == torch.float32
    assert max_rel(ll.numpy(), np.asarray(llo_pl)) < 1e-5
    assert max_rel(ll2.numpy(), np.asarray(ll_pl)) < 1e-5
    assert max_norm(g.numpy(), np.asarray(g_pl)) < 5e-5


def test_pernode_plain_versions_match_pallas_interpret_at_12_categories():
    """5 taxa x 32 patterns x 2 trees, GTR+Gamma12: bito_tpu's per-node
    Pallas kernels in interpret mode (category_count=12) against the
    port's plain versions in float32 on the port's operands."""
    B = 2
    case = make_case(seed=19, num_taxa=5, num_sites=32, num_trees=B)
    je, te = _engines(case, ("GTR", "gamma+12"))
    enc, ingredients, sp = _jax_operands(je, case, B)
    tips = jnp.asarray(sp.tip_partials(), jnp.float32)
    tapes = [jnp.asarray(x) for x in (enc.post_ops, enc.pre_ops, enc.root)]
    static = dict(num_slots=enc.num_slots, category_count=12,
                  s_tile=je._pallas_s_tile(), interpret=True)
    P_blk, tips_flat, piprop, w = pallas_pruning.prepare_inputs(
        enc, tips, sp.weights, *ingredients, je.pattern_pad)
    llo_pl = pallas_pruning.pallas_log_likelihoods(
        tapes[0], tapes[2], P_blk, tips_flat, piprop, w, **static)
    ll_pl, g_pl = pallas_pruning.pallas_ll_and_gradients(
        *tapes, jnp.asarray(enc.edge_mask, jnp.float32),
        *pallas_pruning.prepare_inputs_grad(enc, tips, sp.weights,
                                            *ingredients, je.pattern_pad),
        **static)
    ops, extra = pernode_operands(te, case, GTR)
    assert ops["P"].shape[2] == 12
    ll = pernode.pernode_log_likelihoods(**ops)
    ll2, g = pernode.pernode_ll_and_gradients(**ops, **extra)
    assert ll.dtype == torch.float32
    assert max_rel(ll.numpy(), np.asarray(llo_pl)) < 1e-5
    assert max_rel(ll2.numpy(), np.asarray(ll_pl)) < 1e-5
    assert max_norm(g.numpy(), np.asarray(g_pl)) < 5e-5


@pytest.mark.parametrize("C", [9, 16, 17, 32])
def test_chunked_and_pernode_plans_at_16_and_32_lanes(C):
    """At the flagship (MW = 28 grid positions, N1 = 53 edges, 27 chunked
    grad rows; 25 per-node rows and a 232-int tape): the chunked grad body
    takes 16 warps of one pattern at 16 lanes (two op lanes a pattern, the
    tree's P and dP 106 KB), and at 32 lanes (one op lane) one warp fits
    beside 212 KB of matrices, so the global body takes the tree; the
    per-node grad body 9 warps of two patterns at 16 lanes, and the global
    body at 32.  Asked for with least=1, both launch one warp at 32."""
    G = paired.lanes(C)
    mats = 106 * G * 64
    cplan = chunked.onchip_plan(27, 28, 53, C)
    pplan = pernode.onchip_plan(25, 232, 53, C)
    if G == 16:
        assert cplan == paired.OnchipPlan(16, 16, False,
                                          27 * 16 * 256 + mats + 560, 2)
        assert pplan == paired.OnchipPlan(16, 18, False,
                                          25 * 18 * 256 + mats + 928)
    else:
        assert cplan is None and pplan is None
        assert chunked.onchip_plan(27, 28, 53, C, least=1) == (
            paired.OnchipPlan(32, 1, False, 27 * 512 + mats + 560, 1))
        assert pernode.onchip_plan(25, 232, 53, C, least=1) == (
            paired.OnchipPlan(32, 1, False, 25 * 512 + mats + 928))
    assert mats + 560 == chunked.smem_bytes(0, 28, 53, C, 0)
    assert mats + 928 == pernode.smem_bytes(0, 232, 53, C, 0)
    # The LL body on either tape is the paired one, which stages or rings.
    ll = chunked.ll_plan(10, 28, 53, C)
    assert ll.lanes == G and ll.smem <= paired.SMEM_BYTES


@pytest.mark.parametrize("seed,num_taxa,rooted", [
    (1, 5, False), (2, 9, True), (3, 27, False), (4, 40, True)])
def test_the_chunked_tape_is_the_lane_bodies_paired_tape(seed, num_taxa,
                                                         rooted):
    """What the global lane bodies read on the chunked tape: grid op g's
    children in pair slots 2g and 2g+1, the root slot 2MW and the trash
    slot 2MW+1 (2M and 2M+1 of the paired tape at M = MW); every slot a
    live op reads is written once, by a tip or an earlier grid op (grid
    order is a postorder), and a live op's output lands in a pair slot
    that one later op reads, or in the root slot for one op a tree; and
    the paired plain LL on the chunked tape is the chunked plain LL."""
    text = _synthetic.random_trees_newick(seed, num_taxa, 4, rooted)
    enc = encode_trees([t.topology for t in
                        parse_newick_text(text).trees])
    ce = chunked.build_chunked_encoding(enc, chunked.W)
    MW, T = ce.MW, ce.num_taxa
    assert (ce.root_slot, ce.trash_slot, ce.n_pair_slots) == (
        2 * MW, 2 * MW + 1, 2 * MW + 2)
    child = paired.child_tape(ce.post_dst, ce.tip_slot)
    for b in range(ce.post_dst.shape[0]):
        live = [g for g in range(MW) if ce.post_dst[b, g] != ce.trash_slot]
        writes = [int(ce.post_dst[b, g]) for g in live] + [
            int(x) for x in ce.tip_slot[b]]
        assert len(writes) == len(set(writes))  # each slot written once
        assert sum(ce.post_dst[b, g] == ce.root_slot for g in live) == 1
        for g in live:
            dst = int(ce.post_dst[b, g])
            assert dst == ce.root_slot or (dst // 2 > g and dst < 2 * MW
                                           and dst // 2 in live)
            for j in (0, 1):
                c = int(child[b, g, j])
                assert c == paired.ONES or -T <= c < 0 or c in live
                assert c < g  # written before op g runs
                if c >= 0:
                    assert ce.post_dst[b, c] == 2 * g + j
                elif c != paired.ONES:
                    assert ce.tip_slot[b, -1 - c] == 2 * g + j
    case = make_case(seed=seed, num_taxa=num_taxa, num_sites=20,
                     num_trees=2, rooted=rooted)
    _, te = _engines(case, ("GTR", "gamma+9"))
    ops, _, _ = _chunked_operands(te, case.torch_trees, torch_params(GTR),
                                  chunked.W, F64)
    assert max_rel(paired.paired_log_likelihoods_ref(**ops).numpy(),
                   chunked.chunked_log_likelihoods_ref(**ops).numpy()
                   ) < 1e-12


@pytest.mark.parametrize("C", [9, 16, 32])
def test_lane_bodies_emulation_on_the_chunked_tape(C):
    """The global lane bodies' walk of the chunked tape (one grid op at a
    time over pair slots, children by code, gradient rows by grid
    position) in float64 against the chunked plain version, within
    1e-10, on binary and trifurcating roots; and on the hand-built tape
    with a DUMMY child, which reads ones where no slot was written."""
    for rooted in (False, True):
        case = make_case(seed=40 + C, num_taxa=9, num_sites=30, num_trees=2,
                         rooted=rooted)
        _, te = _engines(case, ("GTR", f"gamma+{C}"))
        ops, extra, tape = _chunked_operands(te, case.torch_trees,
                                             torch_params(GTR), chunked.W,
                                             F64)
        rows = emulate_lanes_chunked(
            ops["post_dst"], tape.child, ops["post_e"], ops["P"],
            extra["dP"], ops["tips"], ops["pi"], ops["props"],
            ops["weights"])
        ll, g = chunked.finish_rows(*rows, extra["node_row"],
                                    extra["edge_mask"], ops["weights"])
        ll_ref, g_ref = chunked.chunked_ll_and_gradients_ref(**ops, **extra)
        assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10
        assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10
    enc = dummy_child_encoding()
    ce = chunked.build_chunked_encoding(enc, chunked.W)
    rng = np.random.default_rng(C)
    S, N1 = 7, enc.num_slots + 1
    P = torch.as_tensor(rng.uniform(0.05, 1.0, (1, N1, C, 4, 4)))
    P = P / P.sum(-1, keepdim=True)
    P[:, -1] = torch.eye(4, dtype=F64)
    dP = torch.as_tensor(rng.normal(0, 0.3, (1, N1, C, 4, 4)))
    dP[:, -1] = 0
    ops = dict(post_dst=torch.as_tensor(ce.post_dst),
               tip_slot=torch.as_tensor(ce.tip_slot),
               post_e=torch.as_tensor(ce.post_e), P=P,
               tips=torch.as_tensor(rng.uniform(0, 1, (3, 4, S))),
               pi=torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=F64),
               props=torch.as_tensor(rng.dirichlet(np.ones(C))),
               weights=torch.as_tensor(rng.integers(1, 4, S)).to(F64))
    extra = dict(node_row=torch.as_tensor(ce.node_row), dP=dP,
                 edge_mask=torch.as_tensor(enc.edge_mask).to(F64))
    child = torch.as_tensor(paired.child_tape(ce.post_dst, ce.tip_slot))
    assert (child == paired.ONES).any()
    rows = emulate_lanes_chunked(ops["post_dst"], child, ops["post_e"], P,
                                 dP, ops["tips"], ops["pi"], ops["props"],
                                 ops["weights"])
    ll, g = chunked.finish_rows(*rows, extra["node_row"],
                                extra["edge_mask"], ops["weights"])
    ll_ref, g_ref = chunked.chunked_ll_and_gradients_ref(**ops, **extra)
    assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10
    assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10


@pytest.mark.parametrize("C", [9, 16, 32])
def test_lane_bodies_emulation_on_the_pernode_tapes(C):
    """The per-node global lane bodies' walk (post_ops into rows by
    internal node, then pre_ops with up values in rows of their own) in
    float64 against the per-node plain versions, within 1e-10, on binary
    and trifurcating roots."""
    for rooted in (False, True):
        case = make_case(seed=50 + C, num_taxa=9, num_sites=30, num_trees=2,
                         rooted=rooted)
        _, te = _engines(case, ("GTR", f"gamma+{C}"))
        ops, extra = pernode_operands(te, case, GTR, dtype=F64)
        rows = emulate_lanes_pernode(ops["post_ops"], extra["pre_ops"],
                                     ops["root"], ops["P"], extra["dP"],
                                     ops["tips"], ops["pi"], ops["props"],
                                     ops["weights"])
        ll, g = pernode.finish_rows(*rows, extra["edge_mask"],
                                    ops["weights"])
        ll_ref, g_ref = pernode.pernode_ll_and_gradients_ref(**ops, **extra)
        assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10
        assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10
