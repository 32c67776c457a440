"""The per-node grad kernel's on-chip body (csrc/pernode_grad_onchip.cu over
csrc/pernode_onchip.cuh) on the CPU: what runs here of it.

  - the host tape (treelike/pernode.py onchip_tape): post ops with child
    codes, one group a parent, and the nodes whose gradient rows no group
    writes, against the scan tape's own post_ops and pre_ops, over random
    rooted and unrooted trees of 4-60 taxa (trifurcating and binary roots,
    padded ops and trees of two sizes in one batch) and a hand-built tape
    with a DUMMY child; tapes that are not the scan tape's are refused;
  - the sizing (pernode.onchip_plan: lanes, patterns a block, bytes, the
    choice of staging) and the tree size at which it hands over to the
    global body, for C = 1..8 and at 16 and 32 lanes (C = 16, 17, 32);
  - a float64 torch emulation of the body's schedule, kept here: rows by
    node, tips read in place, a parent's children evolved together, each
    child's up value written over its partial only after its group, and
    the rescale by a power of two with an integer log scale, at 1-8 and at
    9, 16 and 32 categories.  It is held against the plain version within
    1e-10 and against bito_tpu's Pallas
    kernel in interpret mode within 1e-5 (LL, relative) and 5e-5
    (gradients, of the largest), bench.py's guard.  The same emulation
    with each up value written right after its child's own op breaks a
    sibling's gradient: the hazard the group order avoids.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu.treelike import pallas_pruning
from bito_tpu_torch import _synthetic
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.treelike import paired, pernode
from bito_tpu_torch.treelike.encode import TreeBatchEncoding, encode_trees
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

from torch_port_cases import (GTR, MODELS, jax_engine, jax_params, make_case,
                              max_norm, max_rel, one_torch_thread,
                              pernode_operands, torch_engine)

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _encoding(seed, num_taxa, num_trees, rooted):
    text = _synthetic.random_trees_newick(seed, num_taxa, num_trees, rooted)
    return encode_trees([t.topology for t in parse_newick_text(text).trees])


def _mixed_encoding(seed):
    """Rooted and unrooted trees of 9 taxa in one batch: the unrooted ones
    have one node fewer, so their tapes are padded and their last id is
    unused."""
    a = parse_newick_text(_synthetic.random_trees_newick(seed, 9, 2, True))
    b = parse_newick_text(_synthetic.random_trees_newick(seed + 1, 9, 2))
    return encode_trees([t.topology for t in a.trees + b.trees])


def _dummy_child_encoding():
    """Three taxa joined by two ops, then a root op whose second child is
    the DUMMY node through the identity edge: a unary root with a branch.
    Its preorder group of the root has one child, whose siblings are both
    the DUMMY."""
    N = 6
    post = np.array([[[3, 0, 0, 1, 1], [4, 3, 3, 2, 2], [5, 4, 4, N, N],
                      [N, N, N, N, N]]], dtype=np.int32)
    pre = np.array([[[4, 5, N, N, N, N], [3, 4, 2, 2, N, N],
                     [2, 4, 3, 3, N, N], [0, 3, 1, 1, N, N],
                     [1, 3, 0, 0, N, N], [N, N, N, N, N, N]]],
                   dtype=np.int32)
    mask = np.array([[1, 1, 1, 1, 1, 0]], dtype=np.int32)
    return TreeBatchEncoding(num_taxa=3, num_slots=N, post_ops=post,
                             pre_ops=pre, root=np.array([5], np.int32),
                             edge_mask=mask, node_counts=np.array([6]))


def _tape(enc):
    return pernode.onchip_tape(enc.post_ops, enc.pre_ops, enc.root,
                               enc.num_taxa, enc.num_slots, "cpu")


def _node(code, T):
    return T + code if code >= 0 else -1 - code


TAPES = [(seed, n, rooted) for seed, n in ((1, 4), (2, 5), (3, 9), (4, 27),
                                           (5, 60))
         for rooted in (False, True)]


def _check_tape(enc):
    """The on-chip tape of `enc` against its scan tapes, op by op."""
    T, N = enc.num_taxa, enc.num_slots
    tape = _tape(enc)
    post, groups, zero = (t.numpy() for t in (tape.post, tape.groups,
                                              tape.zero))
    assert all(t.dtype == np.int32 for t in (post, groups, zero))
    B, M = enc.post_ops.shape[:2]
    assert post.shape == (B, M, 5) and groups.shape[2] == 4

    def code(v):
        return pernode.ONES if v == N else (-1 - v if v < T else v - T)

    for b in range(B):
        for m, (d, s1, e1, s2, e2) in enumerate(enc.post_ops[b].tolist()):
            want = [pernode.PAD if d == N else d - T, code(s1), code(s2), e1,
                    e2]
            assert post[b, m].tolist() == want
        # One group a parent, in the tape's order; its children are the
        # destinations of the parent's pre ops, and each op's siblings are
        # the group's other children.
        ops = [op for op in enc.pre_ops[b].tolist() if op[0] != N]
        parents = [ops[0][1]] + [op[1] for i, op in enumerate(ops[1:])
                                 if op[1] != ops[i][1]]
        real = groups[b][groups[b, :, 0] != pernode.PAD]
        assert len(real) == len(parents)
        assert (groups[b, len(parents):, 1:] == pernode.ONES).all()
        seen = set()
        for (par, *kids), v in zip(real.tolist(), parents):
            assert par == (pernode.ROOT_UP if v == enc.root[b] else v - T)
            assert v == enc.root[b] or v in seen  # its up value is written
            nodes = [_node(k, T) for k in kids if k != pernode.ONES]
            assert nodes == [op[0] for op in ops if op[1] == v]
            assert kids[len(nodes):] == [pernode.ONES] * (3 - len(nodes))
            for op in ops:
                if op[1] == v:
                    sibs = {s for s in (op[2], op[4]) if s != N}
                    assert sibs == set(nodes) - {op[0]}
            seen.update(nodes)
        # Every node is a child once; the others' rows are written 0.
        z = zero[b][zero[b] >= 0].tolist()
        assert sorted(seen) == sorted(set(range(N + 1)) - set(z))
        assert enc.root[b] in z and N in z
    stored = enc.post_ops[..., 0][enc.post_ops[..., 0] != N]
    assert tape.rows == int(stored.max()) - T + 1 <= N - T
    assert tape.ints == 5 * M + 4 * groups.shape[1] + zero.shape[1]
    return tape


@pytest.mark.parametrize("seed,num_taxa,rooted", TAPES)
def test_tape_against_the_scan_tapes(seed, num_taxa, rooted):
    tape = _check_tape(_encoding(seed, num_taxa, 6, rooted))
    # Unrooted trees have a trifurcating root group, rooted ones a binary
    # one; every other parent has two children.
    kids = (tape.groups[:, :, 1:] != pernode.ONES).sum(-1)
    assert (kids[:, 0] == (2 if rooted else 3)).all()
    assert set(kids[:, 1:].flatten().tolist()) <= {0, 2}
    assert tape.rows == num_taxa - (1 if rooted else 2)


def test_tape_of_a_mixed_batch():
    """Unrooted trees beside rooted ones of the same taxa: one internal
    node fewer, so a padded pre op and a padded group, and the unused id's
    gradient row in the zero list beside the root's and the dummy's.
    Their trifurcating root takes two post ops, so M is the same."""
    enc = _mixed_encoding(7)
    tape = _check_tape(enc)
    N = enc.num_slots
    assert (enc.pre_ops[2:, -1, 0] == N).all()
    assert (tape.groups[2:, -1, 0] == pernode.PAD).all()
    assert (tape.groups[:2, -1, 0] != pernode.PAD).all()
    assert tape.zero.tolist() == [[N - 1, N, -1]] * 2 + [[N - 2, N - 1, N]] * 2


def test_tape_of_a_dummy_child():
    enc = _dummy_child_encoding()
    tape = _check_tape(enc)
    assert tape.post[0, 2].tolist() == [2, 1, pernode.ONES, 4, 6]
    assert tape.groups[0, 0].tolist() == [pernode.ROOT_UP, 1, pernode.ONES,
                                          pernode.ONES]
    assert tape.zero[0].tolist() == [5, 6]


@pytest.mark.parametrize("order,sibling,match", [
    # the children of node 4 before the root's group wrote its up value
    ([1, 2, 0, 3, 4, 5], None, "not one group"),
    # node 3's ops apart
    ([0, 1, 2, 3, 5, 4], None, "not one group"),
    # a sibling other than the group's other children
    ([0, 1, 2, 3, 4, 5], 0, "siblings")])
def test_tapes_that_are_not_the_scan_tapes_are_refused(order, sibling,
                                                       match):
    enc = _dummy_child_encoding()
    pre = enc.pre_ops[:, order].copy()
    if order == [0, 1, 2, 3, 5, 4]:
        pre[0, 4] = [5, 5, 5, 5, 5, 5]  # a stray op of the root between
    if sibling is not None:
        pre[0, 1, 2:4] = sibling
    with pytest.raises(ValueError, match=match):
        pernode.onchip_tape(enc.post_ops, pre, enc.root, enc.num_taxa,
                            enc.num_slots, "cpu")
    post = enc.post_ops.copy()
    post[0, 0, 0] = 0  # an op that writes a tip
    with pytest.raises(ValueError, match="postorder"):
        pernode.onchip_tape(post, enc.pre_ops, enc.root, enc.num_taxa,
                            enc.num_slots, "cpu")


# ---------------------------------------------------------------------------
# Sizing and the hand-over to the global body
# ---------------------------------------------------------------------------

CATEGORIES = (*range(1, 9), 16, 17, 32)


@pytest.mark.parametrize("C", CATEGORIES)
def test_plan_fills_a_block_within_shared_memory(C):
    """At 16 and 32 lanes the largest tree's P and dP alone (105 edges x 2
    or 4 KB) leave no room for a warp of rows."""
    G = paired.lanes(C)
    per_warp = 32 // G
    for rows, ints, N1 in ((25, 232, 53), (3, 40, 9), (50, 470, 105)):
        plan = pernode.onchip_plan(rows, ints, N1, C, least=1)
        if plan is None:
            assert G >= 16 and N1 == 105
            assert pernode.smem_bytes(rows, ints, N1, C, per_warp) > (
                paired.SMEM_BYTES)
            continue
        assert plan.lanes == G and not plan.ring
        assert plan.cols % per_warp == 0
        assert plan.cols * G <= paired.MAX_THREADS
        assert plan.smem == pernode.smem_bytes(rows, ints, N1, C, plan.cols)
        assert plan.smem <= paired.SMEM_BYTES
        more = plan.cols + per_warp  # one warp more does not fit
        assert (more * G > paired.MAX_THREADS
                or pernode.smem_bytes(rows, ints, N1, C, more)
                > paired.SMEM_BYTES)
    assert pernode.onchip_plan(25, 232, 53,
                               paired.ONCHIP_CATEGORIES + 1) is None
    with pytest.raises(ValueError, match="1 or more"):
        pernode.onchip_plan(25, 232, 53, 0)


def test_plan_at_the_flagship():
    """27 taxa, Gamma4: 25 rows (one an internal node), 26 post ops, 25
    groups and the zero list of the root and the dummy (232 ints), and the
    tree's P and dP (53 edges, 27,136 B): 15 warps of 8 patterns, 480
    threads, in 220,064 bytes."""
    enc = _encoding(0, 27, 4, False)
    tape = _tape(enc)
    assert (tape.rows, tape.ints) == (25, 232)
    plan = pernode.onchip_plan(tape.rows, tape.ints, 53, 4)
    assert plan == paired.OnchipPlan(
        lanes=4, cols=120, ring=False,
        smem=25 * 120 * 4 * 16 + 106 * 4 * 4 * 16 + 232 * 4)
    assert plan.smem == 220_064
    assert pernode.onchip_plan(25, 232, 53, 8).cols == 52  # 13 warps of 4


@pytest.mark.parametrize("C", CATEGORIES)
def test_hand_over_to_the_global_body(C):
    """Unrooted trees of T taxa (T - 2 rows, N1 = 2T - 1 edges, a tape of
    5(T - 2) + 4(T - 2) + 2 ints): the plan holds fewer warps as rows and
    matrices grow, and hands over to the global body once fewer than
    MIN_WARPS fit.  A warp's slice of a row is 512 bytes at every C, and
    the staged matrices 128 * G bytes an edge, so the hand-over comes
    earlier at larger G."""
    G = paired.lanes(C)

    def plan(T, least=pernode.MIN_WARPS):
        return pernode.onchip_plan(T - 2, 9 * (T - 2) + 2, 2 * T - 1, C,
                                   least)

    limit = max(T for T in range(4, 600) if plan(T) is not None)
    assert all(plan(T) is None for T in range(limit + 1, 600))
    warps = [plan(T, 1).cols * G // 32 for T in range(4, limit + 1)]
    assert warps == sorted(warps, reverse=True) and warps[0] == 16
    assert warps[-1] >= pernode.MIN_WARPS
    # The closed form: MIN_WARPS warps' rows, the matrices and the tape.
    fits = [T for T in range(4, 600)
            if (T - 2) * pernode.MIN_WARPS * 512 + (2 * T - 1) * 2 * G * 64
            + (4 * (9 * (T - 2) + 2) + 15) // 16 * 16 <= paired.SMEM_BYTES]
    assert limit == max(fits)
    assert plan(limit + 1, 1) is not None  # asked for, it still launches
    assert pernode.onchip_plan(3, 40, 9,
                               paired.ONCHIP_CATEGORIES + 1) is None
    with pytest.raises(ValueError, match="1 or more"):
        pernode.onchip_plan(3, 40, 9, 0)


def test_plan_follows_the_card_times():
    """The plans of chip_smoke.py phase 4's shapes (random unrooted trees,
    GTR+Gamma4): the body's warps a block fall with the tree (15 at 27
    taxa, 5, 4, 3, 2, 1 and 1 at 64, 76, 84, 96, 128 and 144, none fit
    from 160), and the wrapper takes the body the H100 ran fastest there:
    the on-chip body up to 76 taxa (4 warps), the global body from 84 (3
    warps)."""
    want = {27: 15, 64: 5, 76: 4, 84: 3, 96: 2, 128: 1, 144: 1, 160: 0,
            256: 0, 400: 0}
    for num_taxa, warps in want.items():
        tape = _tape(_encoding(2, num_taxa, 4, False))
        N1 = 2 * num_taxa - 1
        plan = pernode.onchip_plan(tape.rows, tape.ints, N1, 4, least=1)
        assert (0 if plan is None else plan.cols * 4 // 32) == warps
        chosen = pernode.onchip_plan(tape.rows, tape.ints, N1, 4)
        assert (chosen is not None) == (num_taxa <= 76), num_taxa


# ---------------------------------------------------------------------------
# The float64 emulation of the body's schedule
# ---------------------------------------------------------------------------

def _leaf(code, tips, C):
    """A child that is not a row: tip t in place, or all ones."""
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


def emulate_grad(tape, root, T, P, dP, tips, pi, props, weights,
                 up_after="group"):
    """(ll_rows [B, S], grad_rows [B, N1, S]) as the body computes them.
    up_after="op" writes each child's up value right after its own
    gradient, before its siblings are evolved: the hazard."""
    post, groups, zero = (t.numpy() for t in (tape.post, tape.groups,
                                              tape.zero))
    B, N1, C, A = P.shape[:4]
    S = tips.shape[-1]
    ll_rows = torch.empty((B, S), dtype=P.dtype)
    grad_rows = torch.full((B, N1, S), float("nan"), dtype=P.dtype)
    for b in range(B):
        rows = torch.full((tape.rows, C, A, S), float("nan"), dtype=P.dtype)

        def read(code):
            return rows[code] if code >= 0 else _leaf(code, tips, C)

        lsc = torch.zeros(S, dtype=torch.int64)
        for row, c0, c1, e0, e1 in post[b].tolist():
            if row == pernode.PAD:
                continue
            prod, ex = _rescale(_evolve(P[b, e0], read(c0))
                                * _evolve(P[b, e1], read(c1)))
            lsc += ex
            rows[row] = prod
        site = torch.einsum("c,a,cas->s", props, pi,
                            rows[int(root[b]) - T])
        ll_rows[b] = torch.log(site) + lsc.to(P.dtype) * math.log(2.0)
        for n in zero[b].tolist():
            if n >= 0:
                grad_rows[b, n] = 0.0
        for par, *kids in groups[b].tolist():
            if par == pernode.PAD:
                continue
            up = (pi[None, :, None].expand(C, A, S) if par == pernode.ROOT_UP
                  else rows[par])
            real = [(k, _node(k, T)) for k in kids if k != pernode.ONES]
            p = {k: read(k) for k, _ in real}
            ups = {}
            for k, n in real:
                if up_after == "op":  # siblings read as the rows stand now
                    p = {k2: read(k2) for k2, _ in real}
                ev = {k2: _evolve(P[b, n2], p[k2]) for k2, n2 in real}
                o = up.clone()
                for k2, _ in real:
                    if k2 != k:
                        o = o * ev[k2]
                o, _ = _rescale(o)
                num = torch.einsum("c,cas->s", props,
                                   o * _evolve(dP[b, n], p[k]))
                den = torch.einsum("c,cas->s", props, o * ev[k])
                den = torch.where(den > 0, den, torch.ones_like(den))
                grad_rows[b, n] = weights * num / den
                if k >= 0:
                    ups[k] = torch.einsum("cak,cas->cks", P[b, n], o)
                    if up_after == "op":
                        rows[k] = ups[k]
            for k, u in ups.items():
                rows[k] = u
    return ll_rows, grad_rows


def _emulate(ops, extra, tape, up_after="group"):
    rows = emulate_grad(tape, ops["root"], ops["tips"].shape[0], ops["P"],
                        extra["dP"], ops["tips"], ops["pi"], ops["props"],
                        ops["weights"], up_after)
    assert not any(bool(torch.isnan(r).any()) for r in rows)  # all written
    return pernode.finish_rows(*rows, extra["edge_mask"], ops["weights"])


def _tape_of(ops, extra):
    return pernode.onchip_tape(
        ops["post_ops"].numpy(), extra["pre_ops"].numpy(),
        ops["root"].numpy(), ops["tips"].shape[0], ops["P"].shape[1] - 1,
        "cpu")


@pytest.mark.parametrize("model,num_taxa,rooted,num_trees", [
    ("gtr_gamma4", 4, False, 3), ("gtr_gamma4", 9, True, 3),
    ("gtr_gamma4", 27, False, 2), ("jc69", 13, False, 3),
    ("hky_weibull4", 11, True, 2), ("gtr_gamma4", 60, False, 1)])
def test_emulation_matches_the_plain_version(model, num_taxa, rooted,
                                             num_trees):
    """The body's schedule in float64 against the plain version on the
    same operands, within 1e-10."""
    case = make_case(seed=90 + num_taxa, num_taxa=num_taxa, num_sites=40,
                     num_trees=num_trees, rooted=rooted)
    te = torch_engine(case, model)
    ops, extra = pernode_operands(te, case, MODELS[model][1], dtype=F64)
    ll, g = _emulate(ops, extra, _tape_of(ops, extra))
    ll_ref, g_ref = pernode.pernode_ll_and_gradients_ref(**ops, **extra)
    assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10
    assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10


@pytest.mark.parametrize("C", [9, 16, 32])
def test_emulation_past_8_categories(C):
    """The body's group schedule at 9..32 categories (16 or 32 lanes a
    pattern: the sums over categories and the rescale span the pattern's
    lanes, idle lanes zero) in float64 against the plain version within
    1e-10, on a trifurcating and a binary root."""
    for rooted in (False, True):
        case = make_case(seed=70 + C, num_taxa=9, num_sites=30,
                         num_trees=2, rooted=rooted)
        te = TreeLikelihoodEngine(
            case.torch_pattern,
            PhyloModel(PhyloModelSpecification("GTR", f"gamma+{C}")),
            device="cpu", dtype=F64)
        ops, extra = pernode_operands(te, case, GTR, dtype=F64)
        assert ops["P"].shape[2] == C
        ll, g = _emulate(ops, extra, _tape_of(ops, extra))
        ll_ref, g_ref = pernode.pernode_ll_and_gradients_ref(**ops,
                                                             **extra)
        assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10
        assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10


def _random_operands(enc, seed, C=2, S=7):
    rng = np.random.default_rng(seed)
    N1 = enc.num_slots + 1
    B = enc.post_ops.shape[0]
    P = torch.as_tensor(rng.uniform(0.05, 1.0, (B, N1, C, 4, 4)))
    P = P / P.sum(-1, keepdim=True)
    P[:, -1] = torch.eye(4, dtype=F64)
    dP = torch.as_tensor(rng.normal(0, 0.3, (B, N1, C, 4, 4)))
    dP[:, -1] = 0
    ops = dict(post_ops=torch.as_tensor(enc.post_ops),
               root=torch.as_tensor(enc.root), P=P,
               tips=torch.as_tensor(rng.uniform(0, 1,
                                                (enc.num_taxa, 4, S))),
               pi=torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=F64),
               props=torch.as_tensor(rng.dirichlet(np.ones(C))),
               weights=torch.as_tensor(rng.integers(1, 4, S)).to(F64))
    extra = dict(pre_ops=torch.as_tensor(enc.pre_ops), dP=dP,
                 edge_mask=torch.as_tensor(enc.edge_mask).to(F64))
    return ops, extra


@pytest.mark.parametrize("enc", [_dummy_child_encoding(), _mixed_encoding(7)],
                         ids=["dummy_child", "mixed_batch"])
def test_emulation_of_hand_built_and_mixed_tapes(enc):
    """The hand-built tape with a DUMMY child, and a batch of two tree
    sizes, emulated and plain, on random operands."""
    ops, extra = _random_operands(enc, 3)
    ll, g = _emulate(ops, extra, _tape(enc))
    ll_ref, g_ref = pernode.pernode_ll_and_gradients_ref(**ops, **extra)
    assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10
    assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10
    assert float(g_ref.abs().min()) >= 0 and float(g_ref.abs().max()) > 0


def test_up_value_written_after_its_own_op_breaks_a_sibling():
    """Writing up[c] over p[c] right after c's own op: the next child of
    the group reads it as its sibling's partial, and its gradient is
    wrong, while the group order matches the plain version."""
    case = make_case(seed=61, num_taxa=9, num_sites=40, num_trees=3)
    ops, extra = pernode_operands(torch_engine(case, "gtr_gamma4"), case, GTR,
                                  dtype=F64)
    tape = _tape_of(ops, extra)
    ll_ref, g_ref = pernode.pernode_ll_and_gradients_ref(**ops, **extra)
    ll, g = _emulate(ops, extra, tape)
    assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10
    ll_bad, g_bad = _emulate(ops, extra, tape, up_after="op")
    torch.testing.assert_close(ll_bad, ll_ref, rtol=1e-12, atol=0)
    err = (g_bad - g_ref).abs() / g_ref.abs().max()
    assert float(err.max()) > 1e-2
    # The root group's first child read every sibling before any write;
    # a later child of a group whose earlier child is internal did not.
    T = ops["tips"].shape[0]
    for b in range(3):
        first = _node(int(tape.groups[b, 0, 1]), T)
        assert float(err[b, first]) < 1e-12
    assert float(err.max()) > 1e-2


@pytest.fixture(scope="module", params=[False, True],
                ids=["trifurcating", "binary"])
def pallas_case(request):
    """9 taxa x 150 patterns x 4 trees, GTR+Gamma4: bito_tpu's Pallas grad
    kernel in interpret mode (as tests/test_torch_pernode.py builds it) and
    the port's operands."""
    B = 4
    case = make_case(seed=31, num_taxa=9, num_sites=150, num_trees=B,
                     rooted=request.param)
    je = jax_engine(case, "gtr_gamma4")
    enc = je.encode(case.jax_trees)
    bl = je.branch_length_matrix(case.jax_trees, enc)
    eig, rates, props, clock = je._model_ingredients(jax_params(GTR), B)
    sp = je.site_pattern
    tapes = [jnp.asarray(x) for x in (enc.post_ops, enc.pre_ops, enc.root)]
    ll_pl, g_pl = pallas_pruning.pallas_ll_and_gradients(
        *tapes, jnp.asarray(enc.edge_mask, jnp.float32),
        *pallas_pruning.prepare_inputs_grad(
            enc, jnp.asarray(sp.tip_partials(), jnp.float32), sp.weights,
            eig, rates, props, clock, bl, je.pattern_pad),
        num_slots=enc.num_slots, category_count=4,
        s_tile=je._pallas_s_tile(), interpret=True)
    ops, extra = pernode_operands(torch_engine(case, "gtr_gamma4"), case, GTR)
    ops, extra = ({k: v.to(F64) if v.is_floating_point() else v
                   for k, v in d.items()} for d in (ops, extra))
    return (np.asarray(ll_pl), np.asarray(g_pl)), (ops, extra)


def test_emulation_matches_pallas_interpret(pallas_case):
    (ll_pl, g_pl), (ops, extra) = pallas_case
    ll, g = _emulate(ops, extra, _tape_of(ops, extra))
    assert max_rel(ll.numpy(), ll_pl) < 1e-5
    assert max_norm(g.numpy(), g_pl) < 5e-5


# ---------------------------------------------------------------------------
# The wrapper on the CPU
# ---------------------------------------------------------------------------

BODIES = (pernode.pernode_grad_onchip, pernode.pernode_grad_global)


def test_wrapper_runs_the_plain_version_for_cpu_tensors():
    """With or without the on-chip tape, CPU operands go to the plain
    version and launch neither body."""
    case = make_case(seed=52, num_taxa=8, num_trees=2)
    ops, extra = pernode_operands(torch_engine(case, "gtr_gamma4"), case, GTR)
    before = [f.launches for f in BODIES]
    want = pernode.pernode_ll_and_gradients_ref(**ops, **extra)
    for onchip in (None, _tape_of(ops, extra)):
        got = pernode.pernode_ll_and_gradients(**ops, **extra, onchip=onchip)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [f.launches for f in BODIES] == before


def test_finish_rows_sums_and_masks():
    rng = np.random.default_rng(6)
    ll_rows = torch.as_tensor(rng.normal(size=(2, 5)))
    grad_rows = torch.as_tensor(rng.normal(size=(2, 4, 5)))
    mask = torch.tensor([[1.0, 1.0, 0.0], [1.0, 0.0, 1.0]], dtype=F64)
    w = torch.as_tensor(rng.uniform(1, 3, 5))
    ll, grads = pernode.finish_rows(ll_rows, grad_rows, mask, w)
    torch.testing.assert_close(ll, ll_rows @ w, rtol=0, atol=0)
    torch.testing.assert_close(grads, grad_rows.sum(-1)[:, :3] * mask,
                               rtol=0, atol=0)
