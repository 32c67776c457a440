"""The chunked grad kernel's on-chip body (csrc/chunked_grad_onchip.cu) on
the CPU: what runs here of it.

  - the child tape (treelike/paired.py child_tape) applied to chunked tapes
    at W = 2, 4 and 8, against the scan tape's own ops mapped through the
    chunk schedule, over random rooted and unrooted trees of 4-60 taxa
    (padded positions, trifurcating roots) and a hand-built tape with a
    DUMMY child; and the rows a pattern needs;
  - the sizing (treelike/chunked.py onchip_plan: lanes, op lanes,
    patterns a block, bytes) and the tree size at which it hands over to
    the global body, for C = 1..8 and at 16 and 32 lanes (C = 16, 17, 32);
  - a float64 torch emulation of the body's schedule, kept here: rows by
    producer, tips read in place, each chunk's ops side by side on
    chunked.W op lanes (each op reads the rows as they stood before its
    chunk, and no op of a chunk reads a row that another writes; at 32
    lanes one op lane, which runs a chunk's ops in turn), the rescale by a
    power of two with an integer log scale per op lane, and outside values
    written over rows, at 1-8 and at 9, 16 and 32 categories.  It is held
    against the plain version within 1e-10 and against bito_tpu's Pallas
    kernel in interpret mode within 1e-5 (LL, relative) and 5e-5
    (gradients, of the largest), bench.py's guard.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu.treelike import pallas_chunked, pallas_pruning
from bito_tpu_torch import _synthetic
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.treelike import chunked, paired, prep
from bito_tpu_torch.treelike.encode import encode_trees
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

from torch_port_cases import (GTR, MODELS, dummy_child_encoding, jax_engine,
                              jax_params, make_case, max_norm, max_rel,
                              one_torch_thread, torch_engine, torch_params)

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield
WIDTHS = (2, 4, 8)


def _encoding(seed, num_taxa, num_trees, rooted):
    text = _synthetic.random_trees_newick(seed, num_taxa, num_trees, rooted)
    return encode_trees([t.topology for t in parse_newick_text(text).trees])


def _expected_children(enc, W, MW):
    """child codes [B, MW, 2] from the scan tape itself: op m's child j is
    the latest op before m that wrote its source node (at that op's grid
    position in the chunk schedule), -1 - s for tip s, ONES for DUMMY
    sources and padded positions."""
    B, M0, _ = enc.post_ops.shape
    want = np.full((B, MW, 2), paired.ONES, dtype=np.int64)
    for b in range(B):
        ops = [tuple(int(v) for v in op) for op in enc.post_ops[b]
               if op[0] != enc.dummy]
        chunks = chunked._schedule_tree(ops, enc.num_taxa, enc.dummy, W)
        grid = {m: c * W + i for c, chunk in enumerate(chunks)
                for i, m in enumerate(chunk)}
        last = {}
        for m, (u, s1, _e1, s2, _e2) in enumerate(ops):
            for j, s in enumerate((s1, s2)):
                if s == enc.dummy:
                    continue
                want[b, grid[m], j] = (-1 - s if s < enc.num_taxa
                                       else grid[last[s]])
            last[u] = m
    return want


TAPES = [(seed, n, rooted) for seed, n in ((1, 4), (2, 5), (3, 9), (4, 27),
                                           (5, 60))
         for rooted in (False, True)]


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("seed,num_taxa,rooted", TAPES)
def test_child_tape_of_chunked_tapes(seed, num_taxa, rooted, W):
    """paired.child_tape applies to the chunked tape as it is: its codes
    are the scan tape's own children, every op child comes from an earlier
    chunk, and padded positions read nothing."""
    enc = _encoding(seed, num_taxa, 6, rooted)
    ce = chunked.build_chunked_encoding(enc, W)
    child = paired.child_tape(ce.post_dst, ce.tip_slot)
    assert child.dtype == np.int32 and child.shape == (6, ce.MW, 2)
    np.testing.assert_array_equal(child, _expected_children(enc, W, ce.MW))
    pad = ce.post_dst == ce.trash_slot
    assert (child[pad] == paired.ONES).all()
    assert (ce.post_e[pad] == enc.dummy).all()
    grid = np.arange(ce.MW)[None, :, None]
    ops = child >= 0
    assert (child[ops] // W < np.broadcast_to(grid, child.shape)[ops] // W
            ).all()
    # Each op's output is read once, by the op its post_dst names.
    b, g = np.nonzero((ce.post_dst != ce.trash_slot)
                      & (ce.post_dst != ce.root_slot))
    slot = ce.post_dst[b, g]
    np.testing.assert_array_equal(child[b, slot // 2, slot % 2], g)


@pytest.mark.parametrize("W", WIDTHS)
def test_child_tape_of_a_dummy_child(W):
    enc = dummy_child_encoding()
    ce = chunked.build_chunked_encoding(enc, W)
    child = paired.child_tape(ce.post_dst, ce.tip_slot)
    np.testing.assert_array_equal(child, _expected_children(enc, W, ce.MW))
    # The three ops form a chain: one op a chunk, the root op reads a DUMMY.
    assert ce.Mc == 3
    assert child[0, 2 * W, 1] == paired.ONES
    assert ce.post_dst[0, 2 * W] == ce.root_slot


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("seed,num_taxa,rooted", TAPES)
def test_rows_cover_every_stored_output(seed, num_taxa, rooted, W):
    """The body keeps op g's output in row g: the rows a pattern needs are
    one more than the last grid position that stores one (neither padded
    nor the root op), at most MW."""
    enc = _encoding(seed, num_taxa, 6, rooted)
    ce = chunked.build_chunked_encoding(enc, W)
    tape = chunked.onchip_tape(ce.post_dst, ce.tip_slot, "cpu")
    stored = (ce.post_dst != ce.trash_slot) & (ce.post_dst != ce.root_slot)
    assert tape.grad_rows == int(np.nonzero(stored)[1].max()) + 1 <= ce.MW
    assert tape.child.dtype == torch.int32
    np.testing.assert_array_equal(
        tape.child.numpy(), paired.child_tape(ce.post_dst, ce.tip_slot))


# ---------------------------------------------------------------------------
# Sizing and the hand-over to the global body
# ---------------------------------------------------------------------------

CATEGORIES = (*range(1, 9), 16, 17, 32)


@pytest.mark.parametrize("C", CATEGORIES)
def test_plan_fills_a_block_within_shared_memory(C):
    """A pattern takes L op lanes x G category lanes of one warp: L = W
    up to 16 lanes, one at 32 (a pattern a warp).  At 16 and 32 lanes the
    largest tree's P and dP alone (127 edges x 2 or 4 KB) exceed a block,
    and no warp fits."""
    G = paired.lanes(C)
    L = chunked.op_lanes(C)
    assert L == (1 if G == 32 else chunked.W)
    per_warp = 32 // (L * G)  # patterns a warp
    for rows, MW, N1 in ((27, 28, 53), (5, 8, 13), (60, 64, 127)):
        plan = chunked.onchip_plan(rows, MW, N1, C, least=1)
        if plan is None:
            assert G >= 16 and N1 == 127
            assert chunked.smem_bytes(0, MW, N1, C, 0) > paired.SMEM_BYTES
            continue
        assert plan.lanes == G and plan.op_lanes == L and not plan.ring
        assert plan.cols % per_warp == 0
        assert plan.cols * L * G <= paired.MAX_THREADS
        assert plan.smem == chunked.smem_bytes(rows, MW, N1, C, plan.cols)
        assert plan.smem <= paired.SMEM_BYTES
        more = plan.cols + per_warp  # one warp more does not fit or exceeds
        assert (more * L * G > paired.MAX_THREADS
                or chunked.smem_bytes(rows, MW, N1, C, more)
                > paired.SMEM_BYTES)


def test_plan_at_the_flagship():
    """27 taxa, Gamma4 (MW = 28 grid positions, N1 = 53 edges, 27 rows):
    the tree's P and dP (27,136 B) and 16 warps of 4 patterns, 512
    threads, in 138,288 bytes."""
    plan = chunked.onchip_plan(27, 28, 53, 4)
    assert plan == paired.OnchipPlan(lanes=4, cols=64, ring=False,
                                     smem=27 * 64 * 4 * 16 + 106 * 4 * 4 * 16
                                     + 5 * 28 * 4, op_lanes=chunked.W)
    assert plan.smem == 138_288
    assert chunked.onchip_plan(27, 28, 53, 8).cols == 32  # 2 patterns a warp


@pytest.mark.parametrize("C", CATEGORIES)
def test_hand_over_to_the_global_body(C):
    """Trees grow (MW grid positions, N1 = MW edges, MW - 1 rows): the
    plan holds fewer warps as rows and matrices grow, and hands over to
    the global body once fewer than MIN_WARPS fit.  A warp's slice of a
    row is 512 / L bytes (L op lanes: W up to 16 lanes, one at 32), and
    the staged matrices 512 * G / 4 bytes an edge, so the hand-over comes
    earlier at larger G: at 32 lanes past 40 grid positions."""
    G, L = paired.lanes(C), chunked.op_lanes(C)

    def plan(MW, least=chunked.MIN_WARPS):
        return chunked.onchip_plan(MW - 1, MW, MW, C, least)

    limit = max(MW for MW in range(2, 800, 2) if plan(MW) is not None)
    assert all(plan(MW) is None for MW in range(limit + 2, 800, 2))
    warps = [plan(MW, 1).cols * L * G // 32
             for MW in range(2, limit + 1, 2)]
    assert warps == sorted(warps, reverse=True) and warps[0] == 16
    assert warps[-1] >= chunked.MIN_WARPS
    # The closed form: MIN_WARPS warps' rows, the matrices and the tape.
    fits = [MW for MW in range(2, 800, 2)
            if (MW - 1) * chunked.MIN_WARPS * 512 // L
            + MW * 2 * G * 64 + (5 * MW * 4 + 15) // 16 * 16
            <= paired.SMEM_BYTES]
    assert limit == max(fits)
    if G == 32:
        assert limit == 40
    # Asked for with least=1, the body launches past it while one warp fits.
    assert plan(limit + 2, 1) is not None
    assert chunked.onchip_plan(10, 12, 14,
                               paired.ONCHIP_CATEGORIES + 1) is None
    with pytest.raises(ValueError, match="1 or more"):
        chunked.onchip_plan(10, 12, 14, 0)


def test_plan_follows_the_card_times():
    """The plans of chip_smoke.py phase 4's shapes (random unrooted trees,
    GTR+Gamma4): the body's warps a block fall with the tree (16 at 27
    taxa, 10, 5, 3, 2 and 1 at 64-160, none fit from 192), and the wrapper
    takes the body the H100 ran fastest there: the on-chip body up to 128
    taxa (3 warps), the global body from 144 (2 warps)."""
    want = {27: 16, 64: 10, 96: 5, 128: 3, 144: 2, 160: 1, 192: 0, 256: 0}
    for num_taxa, warps in want.items():
        ce = chunked.build_chunked_encoding(_encoding(2, num_taxa, 8, False),
                                            chunked.W)
        rows = paired.grad_rows_needed(ce.post_dst)
        N1 = 2 * num_taxa - 1
        plan = chunked.onchip_plan(rows, ce.MW, N1, 4, least=1)
        assert (0 if plan is None else plan.cols * 8 // 32) == warps
        chosen = chunked.onchip_plan(rows, ce.MW, N1, 4)
        assert (chosen is not None) == (num_taxa <= 128), num_taxa


# ---------------------------------------------------------------------------
# The float64 emulation of the body's schedule
# ---------------------------------------------------------------------------

def _leaf(code, tips, C):
    """A child that is not an op's output: tip t in place, or all ones."""
    T, A, S = tips.shape
    if code < 0 and -1 - code < T:
        return tips[-1 - code][None].expand(C, A, S)
    return torch.ones((C, A, S), dtype=tips.dtype)


def _rescale(x):
    """x scaled by 2^-e per pattern, e the exponent that puts its largest
    entry in [0.5, 1) (0 where that entry is not positive), and e."""
    mx = x.amax(dim=tuple(range(x.dim() - 1)))
    e = torch.where(mx > 0, torch.frexp(mx).exponent, 0)
    return x * torch.pow(2.0, -e.to(x.dtype)), e


def _evolve(M, p):
    return torch.einsum("cak,cks->cas", M, p)


def emulate_grad(dst, child, e, rows_needed, P, dP, tips, pi, props,
                 weights, lanes=chunked.W):
    """(ll_rows [B, S], grad_rows [B, 2MW+1, S]) as the body computes
    them: `lanes` op lanes run a chunk's ops side by side on the rows as
    they stood before the chunk."""
    B, MW = dst.shape
    C, A, S = P.shape[2], P.shape[3], tips.shape[-1]
    root, trash = 2 * MW, 2 * MW + 1
    ll_rows = torch.empty((B, S), dtype=P.dtype)
    grad_rows = torch.zeros((B, 2 * MW + 1, S), dtype=P.dtype)
    for b in range(B):
        rows = torch.zeros((rows_needed, C, A, S), dtype=P.dtype)
        lsc = torch.zeros((lanes, S), dtype=torch.int64)
        chunks = [[c * lanes + k for k in range(lanes)
                   if dst[b, c * lanes + k] != trash]
                  for c in range(MW // lanes)]
        for ops in chunks:
            stores = {}
            for g in ops:
                cs = [int(c) for c in child[b, g]]
                assert all(c not in ops for c in cs)  # an earlier chunk's
                p = [rows[c] if c >= 0 else _leaf(c, tips, C) for c in cs]
                prod, ex = _rescale(_evolve(P[b, int(e[b, g, 0])], p[0])
                                    * _evolve(P[b, int(e[b, g, 1])], p[1]))
                lsc[g % lanes] += ex
                if dst[b, g] == root:
                    site = torch.einsum("c,a,cas->s", props, pi, prod)
                else:
                    stores[g] = prod
            for g, prod in stores.items():
                rows[g] = prod
        ll_rows[b] = torch.log(site) + lsc.sum(0).to(P.dtype) * math.log(2.0)
        for ops in reversed(chunks):
            stores = {}
            for g in ops:
                cs = [int(c) for c in child[b, g]]
                up = (pi[None, :, None].expand(C, A, S) if dst[b, g] == root
                      else rows[g])
                p = [rows[c] if c >= 0 else _leaf(c, tips, C) for c in cs]
                Pj = [P[b, int(e[b, g, j])] for j in (0, 1)]
                ev = [_evolve(Pj[j], p[j]) for j in (0, 1)]
                o, _ = _rescale(torch.stack([up * ev[1], up * ev[0]]))
                for j in (0, 1):
                    dv = _evolve(dP[b, int(e[b, g, j])], p[j])
                    num = torch.einsum("c,cas->s", props, o[j] * dv)
                    den = torch.einsum("c,cas->s", props, o[j] * ev[j])
                    den = torch.where(den > 0, den, torch.ones_like(den))
                    grad_rows[b, 2 * g + j] = weights * num / den
                    if cs[j] >= 0:  # the child op's outside value, in place
                        stores[cs[j]] = torch.einsum("cak,cas->cks", Pj[j],
                                                     o[j])
            # No op of the chunk reads a row that another op overwrites.
            assert not set(stores) & set(ops)
            for g, up in stores.items():
                rows[g] = up
    return ll_rows, grad_rows


def _emulate(ops, extra, tape, lanes=chunked.W):
    ll_rows, grad_rows = emulate_grad(
        ops["post_dst"], tape.child, ops["post_e"], tape.grad_rows, ops["P"],
        extra["dP"], ops["tips"], ops["pi"], ops["props"], ops["weights"],
        lanes)
    return chunked.finish_rows(ll_rows, grad_rows, extra["node_row"],
                               extra["edge_mask"], ops["weights"])


def _operands(te, trees, params, W, dtype=F64):
    """The chunked tapes at width W, the on-chip tape and the kernels'
    operands of the port's engine, float operands in `dtype`."""
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


@pytest.mark.parametrize("model,num_taxa,rooted,num_trees,W", [
    ("gtr_gamma4", 4, False, 3, 2), ("gtr_gamma4", 9, True, 3, 2),
    ("gtr_gamma4", 27, False, 2, 2), ("jc69", 13, False, 3, 2),
    ("hky_weibull4", 11, True, 2, 2), ("gtr_gamma4", 60, False, 1, 2),
    ("gtr_gamma4", 13, True, 2, 4), ("hky_weibull4", 27, False, 2, 8)])
def test_emulation_matches_the_plain_version(model, num_taxa, rooted,
                                             num_trees, W):
    """The body's schedule in float64 against the plain version on the
    same operands, within 1e-10, on tapes built at the engine's width and
    at multiples of it."""
    case = make_case(seed=80 + num_taxa, num_taxa=num_taxa, num_sites=40,
                     num_trees=num_trees, rooted=rooted)
    te = torch_engine(case, model)
    ops, extra, tape = _operands(te, case.torch_trees,
                                 torch_params(MODELS[model][1]), W)
    ll, g = _emulate(ops, extra, tape)
    ll_ref, g_ref = chunked.chunked_ll_and_gradients_ref(**ops, **extra)
    assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10
    assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10


@pytest.mark.parametrize("C", [9, 16, 32])
def test_emulation_past_8_categories(C):
    """The body's schedule at 9..32 categories in float64 against the
    plain version, within 1e-10: at 16 lanes the chunk's W ops side by
    side, at 32 lanes one op lane (chunked.op_lanes) that runs them in
    turn.  Each schedule gives the plain version's numbers at either
    count, on a binary and a trifurcating root."""
    for rooted in (False, True):
        case = make_case(seed=60 + C, num_taxa=9, num_sites=30,
                         num_trees=2, rooted=rooted)
        te = TreeLikelihoodEngine(
            case.torch_pattern,
            PhyloModel(PhyloModelSpecification("GTR", f"gamma+{C}")),
            device="cpu", dtype=F64)
        ops, extra, tape = _operands(te, case.torch_trees,
                                     torch_params(GTR), chunked.W)
        assert ops["P"].shape[2] == C
        ll_ref, g_ref = chunked.chunked_ll_and_gradients_ref(**ops,
                                                             **extra)
        assert chunked.op_lanes(C) == (chunked.W if C <= 16 else 1)
        for lanes in {chunked.op_lanes(C), 1, chunked.W}:
            ll, g = _emulate(ops, extra, tape, lanes)
            assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10, lanes
            assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10, lanes


def test_emulation_of_a_dummy_child():
    """The hand-built tape with a DUMMY child (all ones through the
    identity edge), emulated and plain, on random operands."""
    enc = dummy_child_encoding()
    ce = chunked.build_chunked_encoding(enc, chunked.W)
    rng = np.random.default_rng(3)
    C, S, N1 = 2, 7, enc.num_slots + 1
    P = torch.as_tensor(rng.uniform(0.05, 1.0, (1, N1, C, 4, 4)))
    P = P / P.sum(-1, keepdim=True)
    P[:, -1] = torch.eye(4, dtype=F64)
    dP = torch.as_tensor(rng.normal(0, 0.3, (1, N1, C, 4, 4)))
    dP[:, -1] = 0
    dst, tip, e, row = (torch.as_tensor(x) for x in (
        ce.post_dst, ce.tip_slot, ce.post_e, ce.node_row))
    ops = dict(post_dst=dst, tip_slot=tip, post_e=e, P=P,
               tips=torch.as_tensor(rng.uniform(0, 1, (3, 4, S))),
               pi=torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=F64),
               props=torch.tensor([0.6, 0.4], dtype=F64),
               weights=torch.as_tensor(rng.integers(1, 4, S)).to(F64))
    extra = dict(node_row=row, dP=dP,
                 edge_mask=torch.as_tensor(enc.edge_mask).to(F64))
    tape = chunked.onchip_tape(ce.post_dst, ce.tip_slot, "cpu")
    ll, g = _emulate(ops, extra, tape)
    ll_ref, g_ref = chunked.chunked_ll_and_gradients_ref(**ops, **extra)
    assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10
    assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10
    assert float(g_ref[0, 4].abs()) > 0  # the unary root's branch


@pytest.fixture(scope="module")
def pallas_case():
    """9 taxa x 150 patterns x 4 trees, GTR+Gamma4, W=4: bito_tpu's Pallas
    grad kernel in interpret mode (as tests/test_torch_chunked.py builds
    it) and the port's operands at the same width."""
    B, W = 4, 4
    case = make_case(seed=31, num_taxa=9, num_sites=150, num_trees=B)
    je = jax_engine(case, "gtr_gamma4")
    jp = jax_params(GTR)
    enc = je.encode(case.jax_trees)
    bl = je.branch_length_matrix(case.jax_trees, enc)
    eig, rates, props, clock = je._model_ingredients(jp, B)
    sp = je.site_pattern
    P_blk, dP_blk, tips_flat, pivec, propvec, w = (
        pallas_pruning.prepare_inputs_grad(
            enc, jnp.asarray(sp.tip_partials(), jnp.float32), sp.weights,
            eig, rates, props, clock, bl, je.pattern_pad))
    ce = pallas_chunked.build_chunked_encoding(enc, W=W)
    dst, tip, e, row = (jnp.asarray(x) for x in (
        ce.post_dst, ce.tip_slot, ce.post_e, ce.node_row))
    ll_pl, g_pl = pallas_chunked.chunked_ll_and_gradients(
        dst, tip, e, row, jnp.asarray(enc.edge_mask, jnp.float32), P_blk,
        dP_blk, tips_flat, pivec, propvec, w, num_slots=enc.num_slots,
        Mc=ce.Mc, W=ce.W, T=ce.num_taxa, CA=pivec.shape[1],
        s_tile=je._pallas_s_tile(), group=1, interpret=True)
    te = torch_engine(case, "gtr_gamma4")
    ops, extra, tape = _operands(te, case.torch_trees, torch_params(GTR), W,
                                 torch.float32)
    ops, extra = ({k: v.to(F64) if v.is_floating_point() else v
                   for k, v in d.items()} for d in (ops, extra))
    return (np.asarray(ll_pl), np.asarray(g_pl)), (ops, extra, tape)


def test_emulation_matches_pallas_interpret(pallas_case):
    (ll_pl, g_pl), (ops, extra, tape) = pallas_case
    ll, g = _emulate(ops, extra, tape)
    assert max_rel(ll.numpy(), ll_pl) < 1e-5
    assert max_norm(g.numpy(), g_pl) < 5e-5


# ---------------------------------------------------------------------------
# The wrapper and the engine on the CPU
# ---------------------------------------------------------------------------

BODIES = (chunked.chunked_grad_onchip, chunked.chunked_grad_global)


def test_wrapper_runs_the_plain_version_for_cpu_tensors():
    """With or without the on-chip tape, CPU operands go to the plain
    version and launch neither body."""
    case = make_case(seed=52, num_taxa=8, num_trees=2)
    te = torch_engine(case, "gtr_gamma4")
    ops, extra, tape = _operands(te, case.torch_trees, torch_params(GTR),
                                 chunked.W)
    before = [f.launches for f in BODIES]
    want = chunked.chunked_ll_and_gradients_ref(**ops, **extra)
    for onchip in (None, tape):
        got = chunked.chunked_ll_and_gradients(**ops, **extra, onchip=onchip)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [f.launches for f in BODIES] == before
    assert te._chunked_onchip_tape(te.encode(case.torch_trees)) is None


def test_finish_rows_sums_and_maps_the_grid_rows():
    rng = np.random.default_rng(6)
    ll_rows = torch.as_tensor(rng.normal(size=(2, 5)))
    grad_rows = torch.as_tensor(rng.normal(size=(2, 7, 5)))
    grad_rows[:, 6] = 0.0  # row 2MW, of nodes without a branch
    node_row = torch.tensor([[0, 3, 6], [5, 6, 1]], dtype=torch.int32)
    mask = torch.tensor([[1.0, 1.0, 0.0], [1.0, 0.0, 1.0]], dtype=F64)
    w = torch.as_tensor(rng.uniform(1, 3, 5))
    ll, grads = chunked.finish_rows(ll_rows, grad_rows, node_row, mask, w)
    torch.testing.assert_close(ll, ll_rows @ w, rtol=0, atol=0)
    sums = grad_rows.sum(-1)
    want = torch.stack([sums[0, [0, 3, 6]], sums[1, [5, 6, 1]]]) * mask
    torch.testing.assert_close(grads, want, rtol=0, atol=0)
