"""The chunked and per-node LL kernels' on-chip body on the CPU: what runs
here of it.  Both walk the paired LL body (csrc/paired_ll_onchip.cu) over
their own tapes, one op at a time.

  - the per-node tape (treelike/pernode.py ll_tape) against the scan tape's
    own ops and against the paired tape of the same ops, over random rooted
    and unrooted trees of 4-60 taxa; the trifurcating root's accumulator
    (its child is the earlier op that wrote its node, never itself), an
    accumulator that stores (its output takes the row it frees), the root
    op (only the last op that writes the root), and the tapes it refuses;
  - the rows by liveness (paired.live_rows) on the chunked and per-node
    tapes: every output stays in its row until it is read;
  - a float64 emulation of the body's schedule (tests/torch_port_cases.py
    emulate_ll) on both tapes, held against the plain versions within
    1e-10 and against bito_tpu's Pallas kernels in interpret mode
    (pallas_chunked's `_ll_kernel`, pallas_pruning's `_kernel`) within
    1e-5, relative, on the same inputs;
  - the plans: which body the wrappers take on both tapes, from the
    flagship to trees past the on-chip limit, and that the wrappers run
    the plain versions for CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu.treelike import pallas_chunked, pallas_pruning
from bito_tpu_torch import _synthetic
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.treelike import chunked, paired, pernode, prep
from bito_tpu_torch.treelike.encode import TreeBatchEncoding, encode_trees

from torch_port_cases import (GTR, MODELS, check_live_rows, emulate_ll,
                              jax_engine, jax_params, make_case, max_rel,
                              pernode_operands, torch_engine, torch_params)

F64 = torch.float64


def _encoding(seed, num_taxa, num_trees, rooted):
    text = _synthetic.random_trees_newick(seed, num_taxa, num_trees, rooted)
    return encode_trees([t.topology for t in parse_newick_text(text).trees])


def _ll_tape(enc):
    return pernode.ll_tape(enc.post_ops, enc.root, enc.num_taxa,
                           enc.num_slots, "cpu")


def _multifurcation_encoding():
    """Four taxa; node 4 joins tips 0, 1 and 2 (an op and an accumulator
    [4, 4, N, 2, 2] that stores), and the root 5 joins node 4 and tip 3."""
    N = 6
    post = np.array([[[4, 0, 0, 1, 1], [4, 4, N, 2, 2], [5, 4, 4, 3, 3],
                      [N, N, N, N, N]]], dtype=np.int32)
    pre = np.full((1, 1, 6), N, dtype=np.int32)
    mask = np.array([[1, 1, 1, 1, 1, 0]], dtype=np.int32)
    return TreeBatchEncoding(num_taxa=4, num_slots=N, post_ops=post,
                             pre_ops=pre, root=np.array([5], np.int32),
                             edge_mask=mask, node_counts=np.array([6]))


TAPES = [(seed, n, rooted) for seed, n in ((1, 4), (2, 5), (3, 9), (4, 27),
                                           (5, 60))
         for rooted in (False, True)]


# ---------------------------------------------------------------------------
# The per-node tape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,num_taxa,rooted", TAPES)
def test_ll_tape_child_codes_match_the_scan_tape(seed, num_taxa, rooted):
    """Each source is the op that last wrote it, a tip -1 - t, or ONES;
    padded ops read nothing and are skipped; the edges are the scan
    tape's.  It is the paired tape of the same ops: the same child codes
    and destination slots (root and trash renumbered for M)."""
    enc = _encoding(seed, num_taxa, 6, rooted)
    tape = _ll_tape(enc)
    B, M, _ = enc.post_ops.shape
    N, T = enc.num_slots, enc.num_taxa
    dst, child, e = (t.numpy() for t in (tape.post_dst, tape.child,
                                         tape.post_e))
    assert all(t.dtype == np.int32 for t in (dst, child, e))
    want = np.full((B, M, 2), paired.ONES, dtype=np.int64)
    for b in range(B):
        last = {}
        for m, (u, s1, _e1, s2, _e2) in enumerate(enc.post_ops[b].tolist()):
            if u == N:
                continue
            for j, s in enumerate((s1, s2)):
                if s != N:
                    want[b, m, j] = -1 - s if s < T else last[s]
            last[u] = m
    np.testing.assert_array_equal(child, want)
    np.testing.assert_array_equal(e, enc.post_ops[..., [2, 4]])
    pad = enc.post_ops[..., 0] == N
    assert (dst[pad] == 2 * M + 1).all() and (dst[~pad] < 2 * M + 1).all()
    pe = paired.build_paired_encoding(enc)
    pdst = pe.post_dst[:, :M].copy()
    pdst[pdst == 2 * pe.M] = 2 * M
    pdst[pdst == 2 * pe.M + 1] = 2 * M + 1
    np.testing.assert_array_equal(dst, pdst)
    np.testing.assert_array_equal(
        child, paired.child_tape(pe.post_dst, pe.tip_slot)[:, :M])


@pytest.mark.parametrize("seed,num_taxa,rooted", TAPES)
def test_root_op_is_the_last_op_that_writes_the_root(seed, num_taxa, rooted):
    """One root op a tree, the last that writes root[b].  An unrooted
    tree's trifurcating root takes two ops: the first stores to the child
    slot of the accumulator [u, u, N, x, x], which reads it (never
    itself) and is the root op."""
    enc = _encoding(seed, num_taxa, 6, rooted)
    tape = _ll_tape(enc)
    M = enc.post_ops.shape[1]
    dst, child = tape.post_dst.numpy(), tape.child.numpy()
    for b in range(enc.post_ops.shape[0]):
        writes = [m for m in range(M) if enc.post_ops[b, m, 0] == enc.root[b]]
        assert np.nonzero(dst[b] == 2 * M)[0].tolist() == [writes[-1]]
        assert len(writes) == (1 if rooted else 2)
        if not rooted:
            first, acc = writes
            assert enc.post_ops[b, acc, 1] == enc.root[b]  # reads its node
            assert child[b, acc, 0] == first != acc
            assert dst[b, first] == 2 * acc  # a row like any other op's
            assert tape.live_row[b, first] < tape.ll_rows


def test_an_accumulator_that_stores_takes_the_row_it_frees():
    """Node 4's accumulator reads the op before it and stores node 4 for
    the root op: its output takes the row its read frees, so the tape
    needs one row; the emulation still matches the plain version."""
    enc = _multifurcation_encoding()
    tape = _ll_tape(enc)
    assert tape.child[0].tolist() == [[-1, -2], [0, -3], [1, -4],
                                      [paired.ONES, paired.ONES]]
    assert tape.post_dst[0].tolist() == [2, 4, 8, 9]
    assert tape.live_row[0, :2].tolist() == [0, 0] and tape.ll_rows == 1
    ops = _random_operands(enc, 8)
    want = pernode.pernode_log_likelihoods_ref(**ops)
    got = emulate_ll(tape.post_dst, tape.child, tape.live_row, tape.post_e,
                     ops["P"], ops["tips"], ops["pi"], ops["props"],
                     ops["weights"])
    assert max_rel(got.numpy(), want.numpy()) < 1e-10


@pytest.mark.parametrize("edit,match", [
    (lambda post, root: post.__setitem__((0, 0, 1), 5), "no earlier op"),
    (lambda post, root: post.__setitem__((0, 2, 3), 4), "read twice"),
    (lambda post, root: root.__setitem__(0, 3), "is a tip"),
    (lambda post, root: post.__setitem__((0, 2, 0), 4), "no op writes"),
    (lambda post, root: post.__setitem__((0, 0, 0), 2), "postorder")])
def test_ll_tape_refuses_what_the_body_cannot_take(edit, match):
    """An internal node read before any op wrote it (bito_tpu's kernel
    reads ones there; pernode_ll.cu's buffer holds no such value), an
    output read twice, a root that is a tip or that no op writes, and a
    tape that writes a tip."""
    enc = _multifurcation_encoding()
    post, root = enc.post_ops.copy(), enc.root.copy()
    edit(post, root)
    with pytest.raises(ValueError, match=match):
        pernode.ll_tape(post, root, enc.num_taxa, enc.num_slots, "cpu")


@pytest.mark.parametrize("kind", ["chunked", "pernode"])
@pytest.mark.parametrize("seed,num_taxa,rooted", TAPES)
def test_live_rows_keep_every_output_until_it_is_read(seed, num_taxa, rooted,
                                                      kind):
    enc = _encoding(seed, num_taxa, 6, rooted)
    if kind == "chunked":
        ce = chunked.build_chunked_encoding(enc, chunked.W)
        tape = chunked.onchip_tape(ce.post_dst, ce.tip_slot, "cpu")
        dst = ce.post_dst
        assert tape.grad_rows == paired.grad_rows_needed(dst)
    else:
        tape = _ll_tape(enc)
        dst = tape.post_dst.numpy()
    row, child = tape.live_row.numpy(), tape.child.numpy()
    assert 1 <= tape.ll_rows <= dst.shape[1]
    check_live_rows(dst, child, row, tape.ll_rows)


# ---------------------------------------------------------------------------
# The float64 emulation against the plain versions and Pallas
# ---------------------------------------------------------------------------

def _chunked_operands(te, trees, params, W, dtype=F64):
    """The chunked tapes at width W, their on-chip tape and the LL
    operands of the port's engine, float operands in `dtype`."""
    enc = te.encode(trees)
    bl = te.branch_length_matrix(trees, enc)
    eig, rates, props, clock = te._model_ingredients(params, len(trees))
    ce = chunked.build_chunked_encoding(enc, W)
    dst, tip, e = (torch.as_tensor(x, dtype=torch.int32) for x in (
        ce.post_dst, ce.tip_slot, ce.post_e))
    pi, prop = prep.kernel_model(eig, props, dtype)
    ops = dict(post_dst=dst, tip_slot=tip, post_e=e,
               P=prep.prepare_inputs(eig, rates, clock, bl, dtype),
               tips=te._kernel_tips.to(dtype), pi=pi, props=prop,
               weights=te._kernel_weights.to(dtype))
    return ops, chunked.onchip_tape(ce.post_dst, ce.tip_slot, "cpu")


def _emulate_chunked(ops, tape):
    return emulate_ll(ops["post_dst"], tape.child, tape.live_row,
                      ops["post_e"], ops["P"], ops["tips"], ops["pi"],
                      ops["props"], ops["weights"])


def _emulate_pernode(ops, tape):
    return emulate_ll(tape.post_dst, tape.child, tape.live_row, tape.post_e,
                      ops["P"], ops["tips"], ops["pi"], ops["props"],
                      ops["weights"])


def _pernode_tape(ops):
    return pernode.ll_tape(ops["post_ops"].numpy(), ops["root"].numpy(),
                           ops["tips"].shape[0], ops["P"].shape[1] - 1,
                           "cpu")


EMULATION_CASES = [
    ("gtr_gamma4", 4, False, 3), ("gtr_gamma4", 9, True, 3),
    ("gtr_gamma4", 27, False, 2), ("jc69", 13, False, 3),
    ("hky_weibull4", 11, True, 2), ("gtr_gamma4", 60, False, 1)]


@pytest.mark.parametrize("W", [chunked.W, 4])
@pytest.mark.parametrize("model,num_taxa,rooted,num_trees", EMULATION_CASES)
def test_chunked_emulation_matches_the_plain_version(model, num_taxa, rooted,
                                                     num_trees, W):
    """The body's schedule on the chunked tape, at the engine's width and
    at bito_tpu's, against chunked_log_likelihoods_ref within 1e-10."""
    case = make_case(seed=100 + num_taxa, num_taxa=num_taxa, num_sites=40,
                     num_trees=num_trees, rooted=rooted)
    ops, tape = _chunked_operands(torch_engine(case, model), case.torch_trees,
                                  torch_params(MODELS[model][1]), W)
    ll = _emulate_chunked(ops, tape)
    ll_ref = chunked.chunked_log_likelihoods_ref(**ops)
    assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10


@pytest.mark.parametrize("model,num_taxa,rooted,num_trees", EMULATION_CASES)
def test_pernode_emulation_matches_the_plain_version(model, num_taxa, rooted,
                                                     num_trees):
    """The body's schedule on the per-node tape against
    pernode_log_likelihoods_ref within 1e-10: trifurcating roots with their
    accumulator (unrooted) and binary ones (rooted)."""
    case = make_case(seed=110 + num_taxa, num_taxa=num_taxa, num_sites=40,
                     num_trees=num_trees, rooted=rooted)
    ops, _ = pernode_operands(torch_engine(case, model), case,
                              MODELS[model][1], dtype=F64)
    ll = _emulate_pernode(ops, _pernode_tape(ops))
    ll_ref = pernode.pernode_log_likelihoods_ref(**ops)
    assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10


def _random_operands(enc, seed, C=2, S=7):
    rng = np.random.default_rng(seed)
    N1 = enc.num_slots + 1
    B = enc.post_ops.shape[0]
    P = torch.as_tensor(rng.uniform(0.05, 1.0, (B, N1, C, 4, 4)))
    P = P / P.sum(-1, keepdim=True)
    P[:, -1] = torch.eye(4, dtype=F64)
    return dict(post_ops=torch.as_tensor(enc.post_ops),
                root=torch.as_tensor(enc.root), P=P,
                tips=torch.as_tensor(rng.uniform(0, 1, (enc.num_taxa, 4, S))),
                pi=torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=F64),
                props=torch.as_tensor(rng.dirichlet(np.ones(C))),
                weights=torch.as_tensor(rng.integers(1, 4, S)).to(F64))


@pytest.fixture(scope="module", params=[False, True],
                ids=["trifurcating", "binary"])
def pallas_case(request):
    """9 taxa x 150 patterns x 4 trees, GTR+Gamma4: bito_tpu's two LL
    kernels in interpret mode (the chunked one at its width W=4, as
    tests/test_torch_chunked.py builds it; the per-node one as
    tests/test_torch_pernode.py does) and the port's operands, float32
    widened to float64."""
    B, W = 4, 4
    case = make_case(seed=31, num_taxa=9, num_sites=150, num_trees=B,
                     rooted=request.param)
    je = jax_engine(case, "gtr_gamma4")
    enc = je.encode(case.jax_trees)
    bl = je.branch_length_matrix(case.jax_trees, enc)
    eig, rates, props, clock = je._model_ingredients(jax_params(GTR), B)
    sp = je.site_pattern
    tips = jnp.asarray(sp.tip_partials(), jnp.float32)
    P_blk, tips_flat, piprop, w = pallas_pruning.prepare_inputs(
        enc, tips, sp.weights, eig, rates, props, clock, bl, je.pattern_pad)
    llp_pl = pallas_pruning.pallas_log_likelihoods(
        jnp.asarray(enc.post_ops), jnp.asarray(enc.root), P_blk, tips_flat,
        piprop, w, num_slots=enc.num_slots, category_count=4,
        s_tile=je._pallas_s_tile(), interpret=True)
    ce = pallas_chunked.build_chunked_encoding(enc, W=W)
    llc_pl = pallas_chunked.chunked_log_likelihoods(
        jnp.asarray(ce.post_dst), jnp.asarray(ce.tip_slot), P_blk,
        jnp.asarray(ce.post_e), tips_flat, piprop, w, Mc=ce.Mc, W=ce.W,
        T=ce.num_taxa, CA=piprop.shape[1], s_tile=je._pallas_s_tile(),
        group=1, interpret=True)
    te = torch_engine(case, "gtr_gamma4")
    cops, ctape = _chunked_operands(te, case.torch_trees, torch_params(GTR),
                                    W, torch.float32)
    pops, _ = pernode_operands(te, case, GTR)
    cops, pops = ({k: v.to(F64) if v.is_floating_point() else v
                   for k, v in d.items()} for d in (cops, pops))
    return (np.asarray(llc_pl), np.asarray(llp_pl)), (cops, ctape, pops)


def test_emulations_match_pallas_interpret(pallas_case):
    """Both tapes' emulations against bito_tpu's Pallas LL kernels on the
    same inputs, within 1e-5 relative (bench.py's guard)."""
    (llc_pl, llp_pl), (cops, ctape, pops) = pallas_case
    assert max_rel(_emulate_chunked(cops, ctape).numpy(), llc_pl) < 1e-5
    assert max_rel(_emulate_pernode(pops, _pernode_tape(pops)).numpy(),
                   llp_pl) < 1e-5


# ---------------------------------------------------------------------------
# The plans and the wrappers on the CPU
# ---------------------------------------------------------------------------

def _large_encoding():
    """The card tests' and chip_smoke.py's large path: a cherry comb and a
    balanced tree of 921 taxa in one batch."""
    text = (_synthetic.cherry_comb_newick(0, 460, 1)
            + _synthetic.balanced_newick(0, 921, 1))
    return encode_trees([t.topology for t in parse_newick_text(text).trees])


def test_plans_from_the_flagship_past_the_limit():
    """The flagship's shape keeps 9-10 rows a pattern on both tapes and
    takes the staged body with 16 warps a block; the large path's batch
    fits no warp of either staging on either tape: the comb keeps 460
    outputs live in the per-node order, and the balanced tree 409 in the
    chunked schedule's grid order, which runs it a level at a time."""
    text, _ = _synthetic.ds1_shaped(0, 50)
    for enc, want in ((encode_trees([t.topology for t in parse_newick_text(
            text).trees]), (16, False)), (_large_encoding(), None)):
        N1 = enc.num_slots + 1
        ce = chunked.build_chunked_encoding(enc, chunked.W)
        ct = chunked.onchip_tape(ce.post_dst, ce.tip_slot, "cpu")
        pt = _ll_tape(enc)
        for rows, M, plan in (
                (ct.ll_rows, ce.MW, chunked.ll_plan(ct.ll_rows, ce.MW, N1, 4)),
                (pt.ll_rows, enc.post_ops.shape[1], paired.onchip_plan(
                    "ll", pt.ll_rows, enc.post_ops.shape[1], N1, 4))):
            got = None if plan is None else (plan.cols * 4 // 32, plan.ring)
            assert got == want, rows
            if want is None:
                assert paired.onchip_plan("ll", rows, M, N1, 4, True) is None
    lt = _ll_tape(_large_encoding())
    assert lt.ll_rows == 460
    per_tree = [paired.live_rows(lt.post_dst.numpy()[b:b + 1],
                                 lt.child.numpy()[b:b + 1])[1]
                for b in (0, 1)]
    assert per_tree[0] == 460 and per_tree[1] < 20


# chip_smoke.py phase 4's shapes (200 random unrooted trees, GTR+Gamma4):
# taxa -> (live rows on the chunked tape, on the per-node tape), as the
# H100 run printed them, and the body each ran fastest (PERF.md §6).
CARD_SHAPES = {27: (10, 9), 64: (18, 12), 96: (24, 15), 128: (33, 14),
               144: (33, 15), 160: (36, 15), 192: (42, 16), 256: (55, 18),
               320: (62, 18), 400: (77, 18)}
FASTEST = {"chunked": {t: "staged" if t <= 192 else "ring"
                       for t in CARD_SHAPES},
           "pernode": {t: "staged" if t <= 256 else "ring"
                       for t in CARD_SHAPES}}


def test_plans_follow_the_card_times():
    """On every shape of phase 4 the plans take the LL body the H100 ran
    fastest: on chip everywhere (the global bodies lost at every size);
    on the chunked tape the staged matrices up to 192 taxa (6 warps a
    block, chunked.LL_FULL_WARPS) and the ring from 256 (the staged body's
    3 warps against the ring's 8); on the per-node tape, as on the paired
    one, the staged matrices up to 256 taxa (10 warps) and the ring from
    320 (6 warps against 16)."""
    flagship = {27: (28, 26)}  # MW = 28 and M = 26 at the DS1 shape
    for taxa, (crows, prows) in CARD_SHAPES.items():
        N1 = 2 * taxa - 1
        MW, M = flagship.get(taxa, (taxa, taxa - 1))
        for kind, plan in (("chunked", chunked.ll_plan(crows, MW, N1, 4)),
                           ("pernode", paired.onchip_plan("ll", prows, M, N1,
                                                          4))):
            assert plan is not None, (kind, taxa)
            got = "ring" if plan.ring else "staged"
            assert got == FASTEST[kind][taxa], (kind, taxa)
    # The paired rule would have taken the ring at 160 and 192 taxa.
    for taxa in (160, 192):
        assert paired.onchip_plan("ll", CARD_SHAPES[taxa][0], taxa,
                                  2 * taxa - 1, 4).ring


def test_wrappers_run_the_plain_versions_for_cpu_tensors():
    """With or without their tapes, CPU operands go to the plain versions
    and launch no body."""
    case = make_case(seed=52, num_taxa=8, num_trees=2)
    te = torch_engine(case, "gtr_gamma4")
    cops, ctape = _chunked_operands(te, case.torch_trees, torch_params(GTR),
                                    chunked.W)
    pops, _ = pernode_operands(te, case, GTR, dtype=F64)
    bodies = (chunked.chunked_ll_onchip, chunked.chunked_ll_global,
              pernode.pernode_ll_onchip, pernode.pernode_ll_global)
    before = [f.launches for f in bodies]
    for onchip in (None, ctape):
        torch.testing.assert_close(
            chunked.chunked_log_likelihoods(**cops, onchip=onchip),
            chunked.chunked_log_likelihoods_ref(**cops), rtol=0, atol=0)
    for onchip in (None, _pernode_tape(pops)):
        torch.testing.assert_close(
            pernode.pernode_log_likelihoods(**pops, onchip=onchip),
            pernode.pernode_log_likelihoods_ref(**pops), rtol=0, atol=0)
    assert [f.launches for f in bodies] == before
