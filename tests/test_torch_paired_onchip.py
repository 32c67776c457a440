"""The on-chip paired bodies (csrc/paired_ll_onchip.cu,
csrc/paired_grad_onchip.cu) on the CPU: what runs here of them.

  - the child tape (treelike/paired.py child_tape) against the scan tape's
    own ops, and the LL kernel's rows by liveness, over random rooted and
    unrooted trees of 4-60 taxa (padded ops, trifurcating roots) and a
    hand-built tape with a DUMMY child;
  - a float64 torch emulation of the kernels' schedule (the LL body's in
    tests/torch_port_cases.py, which the chunked and per-node LL tapes
    share; the grad body's here): rows by producer op, tips read in place,
    the rescale by a power of two with a running integer log scale, and
    each op's outside value written over its row.  It is
    held against the plain versions within 1e-10 and against bito_tpu's
    Pallas kernels in interpret mode within 1e-5 (LL, relative) and 5e-5
    (gradients, of the largest), bench.py's guard;
  - the wrappers' sizing (lanes, patterns per block, bytes) and the tape
    size at which they hand over to the global bodies, for C = 1..8.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu.treelike import pallas_paired, pallas_pruning
from bito_tpu_torch import _synthetic
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.treelike import paired, prep
from bito_tpu_torch.treelike.encode import TreeBatchEncoding, encode_trees

from torch_port_cases import (GTR, MODELS, check_live_rows, emulate_grad,
                              emulate_ll, jax_engine, jax_params, make_case,
                              max_norm, max_rel, one_torch_thread,
                              torch_engine, torch_params)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


F64 = torch.float64


def _encoding(seed, num_taxa, num_trees, rooted):
    text = _synthetic.random_trees_newick(seed, num_taxa, num_trees, rooted)
    return encode_trees([t.topology for t in parse_newick_text(text).trees])


def _dummy_child_encoding():
    """Three taxa joined by two ops, then a root op whose second child is
    the DUMMY node through the identity edge: a unary root with a branch."""
    N = 6
    post = np.array([[[3, 0, 0, 1, 1], [4, 3, 3, 2, 2], [5, 4, 4, N, N],
                      [N, N, N, N, N]]], dtype=np.int32)
    pre = np.full((1, 1, 6), N, dtype=np.int32)
    mask = np.array([[1, 1, 1, 1, 1, 0]], dtype=np.int32)
    return TreeBatchEncoding(num_taxa=3, num_slots=N, post_ops=post,
                             pre_ops=pre, root=np.array([5], np.int32),
                             edge_mask=mask, node_counts=np.array([6]))


def _expected_children(enc, M):
    """child codes from the scan tape itself: the latest op before m that
    wrote node s, -1 - s for a tip, ONES for DUMMY and padded ops."""
    B, M0, _ = enc.post_ops.shape
    want = np.full((B, M, 2), paired.ONES, dtype=np.int64)
    for b in range(B):
        last = {}
        for m in range(M0):
            op = enc.post_ops[b, m]
            if op[0] == enc.dummy:
                break
            for j, s in enumerate((op[1], op[3])):
                if s == enc.dummy:
                    continue
                want[b, m, j] = -1 - s if s < enc.num_taxa else last[int(s)]
            last[int(op[0])] = m
    return want


TAPES = [(seed, n, rooted) for seed, n in ((1, 4), (2, 5), (3, 9), (4, 27),
                                           (5, 60))
         for rooted in (False, True)]


@pytest.mark.parametrize("seed,num_taxa,rooted", TAPES)
def test_child_tape_matches_the_scan_tape(seed, num_taxa, rooted):
    enc = _encoding(seed, num_taxa, 6, rooted)
    pe = paired.build_paired_encoding(enc)
    child = paired.child_tape(pe.post_dst, pe.tip_slot)
    assert child.dtype == np.int32 and child.shape == (6, pe.M, 2)
    np.testing.assert_array_equal(child, _expected_children(enc, pe.M))
    # The op that writes ROOT reads every other op's output, through the
    # tape; padded ops read nothing.
    trash = 2 * pe.M + 1
    assert (child[pe.post_dst == trash] == paired.ONES).all()
    assert ((pe.post_dst == 2 * pe.M).sum(axis=1) == 1).all()


def test_child_tape_of_a_dummy_child():
    enc = _dummy_child_encoding()
    pe = paired.build_paired_encoding(enc)
    child = paired.child_tape(pe.post_dst, pe.tip_slot)
    ones = paired.ONES
    np.testing.assert_array_equal(child[0], [[-1, -2], [0, -3], [1, ones],
                                             [ones, ones]])
    np.testing.assert_array_equal(child, _expected_children(enc, pe.M))


@pytest.mark.parametrize("seed,num_taxa,rooted", TAPES)
def test_live_rows_keep_every_output_until_it_is_read(seed, num_taxa,
                                                      rooted):
    enc = _encoding(seed, num_taxa, 6, rooted)
    pe = paired.build_paired_encoding(enc)
    child = paired.child_tape(pe.post_dst, pe.tip_slot)
    row, peak = paired.live_rows(pe.post_dst, child)
    assert 1 <= peak <= paired.grad_rows_needed(pe.post_dst) <= pe.M
    check_live_rows(pe.post_dst, child, row, peak)


def _greedy_rows(post_dst, child):
    """live_rows one tree at a time: a sorted free list, a new row where it
    is empty."""
    B, M = post_dst.shape
    row = np.zeros((B, M), dtype=np.int32)
    peak = 1
    for b in range(B):
        free, used = [], 0
        for m in range(M):
            if post_dst[b, m] == 2 * M + 1:
                continue
            free += [int(row[b, c]) for c in child[b, m] if c >= 0]
            if post_dst[b, m] == 2 * M:
                continue
            free.sort()
            if free:
                row[b, m] = free.pop(0)
            else:
                row[b, m], used = used, used + 1
        peak = max(peak, used)
    return row, peak


@pytest.mark.parametrize("seed,num_taxa,rooted", TAPES)
def test_live_rows_match_a_greedy_tree_by_tree(seed, num_taxa, rooted):
    """The batch at once, as live_rows assigns rows, against the same rule
    run one tree at a time."""
    enc = _encoding(seed, num_taxa, 6, rooted)
    pe = paired.build_paired_encoding(enc)
    child = paired.child_tape(pe.post_dst, pe.tip_slot)
    row, peak = paired.live_rows(pe.post_dst, child)
    want_row, want_peak = _greedy_rows(pe.post_dst, child)
    np.testing.assert_array_equal(row, want_row)
    assert peak == want_peak


# ---------------------------------------------------------------------------
# The float64 emulation of the kernels' schedule
# ---------------------------------------------------------------------------

def _operands(te, trees, params, dtype=F64):
    """The paired tapes, the on-chip tape and the kernels' operands of the
    port's engine, float operands in `dtype`."""
    enc = te.encode(trees)
    bl = te.branch_length_matrix(trees, enc)
    eig, rates, props, clock = te._model_ingredients(params, len(trees))
    dst, tip, src, e, mask = te._paired_tapes(enc)
    pi, prop = prep.kernel_model(eig, props, dtype)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl, dtype)
    onchip = paired.onchip_tape(dst.numpy(), tip.numpy(), "cpu",
                                post_src=src.numpy(), post_e=e.numpy(),
                                edges=P.shape[1])
    ops = dict(post_dst=dst, tip_slot=tip, post_e=e, P=P,
               tips=te._kernel_tips.to(dtype), pi=pi, props=prop,
               weights=te._kernel_weights.to(dtype))
    return ops, dict(post_src=src, edge_mask=mask.to(dtype), dP=dP), onchip


def _emulate(ops, extra, onchip):
    ll = emulate_ll(ops["post_dst"], onchip.child, onchip.live_row,
                    ops["post_e"], ops["P"], ops["tips"], ops["pi"],
                    ops["props"], ops["weights"])
    ll2, g = emulate_grad(ops["post_dst"], onchip.child, extra["post_src"],
                          ops["post_e"], extra["edge_mask"], ops["P"],
                          extra["dP"], ops["tips"], ops["pi"], ops["props"],
                          ops["weights"])
    return ll, ll2, g


@pytest.mark.parametrize("model,num_taxa,rooted,num_trees", [
    ("gtr_gamma4", 4, False, 3), ("gtr_gamma4", 9, True, 3),
    ("gtr_gamma4", 27, False, 2), ("jc69", 13, False, 3),
    ("hky_weibull4", 11, True, 2), ("gtr_gamma4", 60, False, 1)])
def test_emulation_matches_the_plain_versions(model, num_taxa, rooted,
                                              num_trees):
    """The kernels' schedule in float64 against the plain versions on the
    same operands, within 1e-10."""
    case = make_case(seed=70 + num_taxa, num_taxa=num_taxa, num_sites=40,
                     num_trees=num_trees, rooted=rooted)
    te = torch_engine(case, model)
    ops, extra, onchip = _operands(te, case.torch_trees,
                                   torch_params(MODELS[model][1]))
    ll, ll2, g = _emulate(ops, extra, onchip)
    ll_ref, g_ref = paired.paired_ll_and_gradients_ref(**ops, **extra)
    assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10
    assert max_rel(ll2.numpy(), ll_ref.numpy()) < 1e-10
    assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10


def test_emulation_of_a_dummy_child():
    """The hand-built tape with a DUMMY child (all ones through the
    identity edge), emulated and plain, on random operands."""
    enc = _dummy_child_encoding()
    pe = paired.build_paired_encoding(enc)
    rng = np.random.default_rng(3)
    C, S, N1 = 2, 7, enc.num_slots + 1
    P = torch.as_tensor(rng.uniform(0.05, 1.0, (1, N1, C, 4, 4)))
    P = P / P.sum(-1, keepdim=True)
    P[:, -1] = torch.eye(4, dtype=F64)
    dP = torch.as_tensor(rng.normal(0, 0.3, (1, N1, C, 4, 4)))
    dP[:, -1] = 0
    tips = torch.as_tensor(rng.uniform(0, 1, (3, 4, S)))
    ints = [torch.as_tensor(x) for x in (pe.post_dst, pe.tip_slot,
                                         pe.post_src, pe.post_e)]
    dst, tip, src, e = ints
    onchip = paired.onchip_tape(pe.post_dst, pe.tip_slot, "cpu",
                                post_src=pe.post_src, post_e=pe.post_e,
                                edges=N1)
    ops = dict(post_dst=dst, tip_slot=tip, post_e=e, P=P, tips=tips,
               pi=torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=F64),
               props=torch.tensor([0.6, 0.4], dtype=F64),
               weights=torch.as_tensor(rng.integers(1, 4, S)).to(F64))
    extra = dict(post_src=src, dP=dP,
                 edge_mask=torch.as_tensor(enc.edge_mask).to(F64))
    ll, ll2, g = _emulate(ops, extra, onchip)
    ll_ref, g_ref = paired.paired_ll_and_gradients_ref(**ops, **extra)
    assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10
    assert max_rel(ll2.numpy(), ll_ref.numpy()) < 1e-10
    assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10
    assert float(g_ref[0, 4].abs()) > 0  # the unary root's branch


@pytest.fixture(scope="module")
def pallas_case():
    """9 taxa x 150 patterns x 4 trees, GTR+Gamma4: bito_tpu's Pallas
    kernels in interpret mode (as tests/test_torch_paired.py builds them)
    and the port's operands."""
    B = 4
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
    te = torch_engine(case, "gtr_gamma4")
    ops, extra, onchip = _operands(te, case.torch_trees, torch_params(GTR),
                                   torch.float32)
    ops = {k: v.to(F64) if v.is_floating_point() else v
           for k, v in ops.items()}
    extra = {k: v.to(F64) if v.is_floating_point() else v
             for k, v in extra.items()}
    return (np.asarray(ll_pl), np.asarray(g_pl), np.asarray(llo_pl)), (
        ops, extra, onchip)


def test_emulation_matches_pallas_interpret(pallas_case):
    (ll_pl, g_pl, llo_pl), (ops, extra, onchip) = pallas_case
    ll, ll2, g = _emulate(ops, extra, onchip)
    assert max_rel(ll.numpy(), llo_pl) < 1e-5
    assert max_rel(ll2.numpy(), ll_pl) < 1e-5
    assert max_norm(g.numpy(), g_pl) < 5e-5


# ---------------------------------------------------------------------------
# Sizing and the hand-over to the global bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", range(1, 9))
def test_plan_fills_a_block_within_shared_memory(C):
    G = paired.lanes(C)
    assert G == {1: 1, 2: 2, 3: 4, 4: 4}.get(C, 8)
    for kernel, rows in (("ll", 5), ("grad", 25)):
        plan = paired.onchip_plan(kernel, rows, M=28, N1=53, C=C)
        assert plan.lanes == G and not plan.ring
        assert plan.cols % (32 // G) == 0
        assert plan.cols * G <= paired.MAX_THREADS
        assert plan.smem == paired.smem_bytes(kernel, rows, 28, 53, C,
                                              plan.cols, False)
        assert plan.smem <= paired.SMEM_BYTES
        more = plan.cols + 32 // G  # one warp more does not fit or exceeds
        assert (more * G > paired.MAX_THREADS
                or paired.smem_bytes(kernel, rows, 28, 53, C, more, False)
                > paired.SMEM_BYTES)


def test_plan_at_the_flagship():
    """27 taxa, Gamma4 (M = 28 ops, N1 = 53 edges; 25 stored rows for the
    grad kernel): the tree's P and dP staged once, 15 warps of 8
    patterns."""
    plan = paired.onchip_plan("grad", 25, 28, 53, 4)
    assert plan == paired.OnchipPlan(lanes=4, cols=120, ring=False,
                                     smem=(25 * 480 + 106 * 4 * 4) * 16
                                     + 7 * 28 * 4)
    ll = paired.onchip_plan("ll", 6, 28, 53, 4)
    assert ll.cols == 128 and ll.smem == (6 * 512 + 53 * 4 * 4) * 16 + 672


@pytest.mark.parametrize("C", range(1, 9))
def test_hand_over_to_the_global_bodies(C):
    """Trees grow (M ops, N1 = M + 2 edges, M - 3 stored rows): the grad
    plan stages all matrices while that leaves FULL_WARPS warps a block,
    then takes the staging with more warps, and hands over to the global
    bodies once that holds fewer than MIN_WARPS warps: past M = 148 ops at
    every C, since a warp's slice of a row is 512 bytes whatever G."""
    G = paired.lanes(C)

    def plan(M, ring=None):
        return paired.onchip_plan("grad", M - 3, M, M + 2, C, ring)

    limit = max(M for M in range(4, 600, 4) if plan(M) is not None)
    assert all(plan(M) is None for M in range(limit + 4, 600, 4))
    assert plan(limit).ring
    assert plan(limit).cols == paired.MIN_WARPS * 32 // G
    # The closed form: MIN_WARPS warps' rows, a ring of 8 matrices, the tape.
    fits = [M for M in range(4, 600)
            if (M - 3) * paired.MIN_WARPS * 512 + 8 * G * 64
            + (7 * M * 4 + 15) // 16 * 16 <= paired.SMEM_BYTES]
    assert limit == max(m for m in fits if m % 4 == 0) == 148
    # A staging asked for by name launches past it while one warp fits.
    assert 1 <= plan(limit + 4, ring=True).cols * G // 32 < paired.MIN_WARPS
    for M in range(4, limit + 1, 4):
        staged, ringed = plan(M, ring=False), plan(M, ring=True)
        warps = [0 if p is None else p.cols * G // 32 for p in (staged,
                                                                 ringed)]
        if warps[0] >= paired.FULL_WARPS or warps[0] >= warps[1]:
            assert plan(M) == staged
        else:
            assert plan(M) == ringed
    staged = max(M for M in range(4, limit, 4) if not plan(M).ring)
    assert 0 < staged < limit
    assert paired.onchip_plan("grad", 10, 12, 14,
                              paired.ONCHIP_MAX_CATEGORIES + 1) is None
    with pytest.raises(ValueError):
        paired.onchip_plan("grad", 10, 12, 14, 0)


def test_plan_follows_the_card_times():
    """The plans of phase 4's shapes in chip_smoke.py (random unrooted
    trees, GTR+Gamma4), which the H100 ran fastest there: the staged LL
    body up to 256 taxa and the ring beyond, the staged grad body at 27
    taxa, the ring at 64-128 and the global body from 192."""
    want = {27: ("staged", "staged"), 64: ("staged", "ring"),
            128: ("staged", "ring"), 192: ("staged", None),
            256: ("staged", None), 400: ("ring", None)}
    for num_taxa, choice in want.items():
        pe = paired.build_paired_encoding(_encoding(2, num_taxa, 8, False))
        child = paired.child_tape(pe.post_dst, pe.tip_slot)
        rows = {"ll": paired.live_rows(pe.post_dst, child)[1],
                "grad": paired.grad_rows_needed(pe.post_dst)}
        got = []
        for kernel in ("ll", "grad"):
            plan = paired.onchip_plan(kernel, rows[kernel], pe.M,
                                      2 * num_taxa - 1, 4)
            got.append(None if plan is None
                       else "ring" if plan.ring else "staged")
        assert tuple(got) == choice, num_taxa


def test_plan_of_the_wrappers_hands_over_past_the_limit():
    case = make_case(seed=51, num_taxa=8, num_trees=2)
    te = torch_engine(case, "gtr_gamma4")
    pe = paired.build_paired_encoding(te.encode(case.torch_trees))
    M, N1, C = pe.M, 15, 4
    onchip = paired.onchip_tape(pe.post_dst, pe.tip_slot, "cpu",
                                post_src=pe.post_src, post_e=pe.post_e,
                                edges=N1)
    plan = paired._onchip_plan("grad", onchip, M, N1, C)
    assert plan.cols == 128 and not plan.ring
    assert onchip.child.dtype == torch.int32
    big = dataclasses.replace(onchip, ll_rows=1000, grad_rows=1000)
    for kernel in ("ll", "grad"):
        assert paired._onchip_plan(kernel, onchip, M, N1, C)
        assert paired._onchip_plan(kernel, big, M, N1, C) is None
        with pytest.raises(ValueError, match="OnchipTape"):
            paired._onchip_plan(kernel, None, M, N1, C)


def test_finish_rows_masks_rows_without_a_branch():
    rng = np.random.default_rng(4)
    ll_rows = torch.as_tensor(rng.normal(size=(2, 5)))
    grad_rows = torch.as_tensor(rng.normal(size=(2, 4, 5)))
    grad_rows[0, 2] = float("nan")  # a row no op wrote
    grad_rows[:, 3] = float("inf")  # the trash row
    mask = torch.tensor([[1.0, 1.0, 0.0], [1.0, 0.0, 1.0]], dtype=F64)
    w = torch.as_tensor(rng.uniform(1, 3, 5))
    ll, grads = paired.finish_rows(ll_rows, grad_rows, mask, w)
    torch.testing.assert_close(ll, ll_rows @ w, rtol=0, atol=0)
    want = grad_rows[:, :3].sum(-1) * mask
    want[0, 2] = 0.0
    torch.testing.assert_close(grads, want, rtol=0, atol=0)


def test_wrappers_run_the_plain_versions_for_cpu_tensors():
    case = make_case(seed=52, num_taxa=8, num_trees=2)
    te = torch_engine(case, "gtr_gamma4")
    ops, extra, onchip = _operands(te, case.torch_trees, torch_params(GTR))
    counters = (paired.paired_ll_onchip, paired.paired_ll_global,
                paired.paired_grad_onchip, paired.paired_grad_global)
    before = [f.launches for f in counters]
    for tape in (None, onchip):
        ll = paired.paired_log_likelihoods(**ops, onchip=tape)
        torch.testing.assert_close(
            ll, paired.paired_log_likelihoods_ref(**ops), rtol=0, atol=0)
        got = paired.paired_ll_and_gradients(**ops, **extra, onchip=tape)
        want = paired.paired_ll_and_gradients_ref(**ops, **extra)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [f.launches for f in counters] == before
    assert te._onchip_tape(te.encode(case.torch_trees)) is None  # the CPU
