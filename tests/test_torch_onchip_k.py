"""The on-chip bodies with K categories a lane (past 32 rate categories),
on the CPU: what runs here of them.

  - the float64 emulation of the K layout (tests/torch_port_cases.py
    `emulate_onchip_k_ll` / `emulate_onchip_k_grad`: rows by liveness
    (LL) and by producer op (grad), K x 512 bytes a pattern at the
    kernels' offsets, category c on lane c mod 32 and place c div 32, one
    pass over the places an op, rescaled by powers of two) against the
    plain versions within 1e-10 at C = 33 and 64 on the paired, chunked
    and per-node tapes;
  - rows 4 and 6 through row 2's body (the chunked tape walked one grid
    op at a time, the per-node ops as a paired tape, both with gradient
    rows by node) against their plain versions at C = 17, 32 and 64;
  - the plans: K = 2 / 3 / 4 at the flagship's shape with the warps and
    bytes the C++ launchers compute, None past the largest K or below
    MIN_WARPS;
  - the routes, with the card and the kernel library faked: the paired,
    chunked and per-node wrappers launch the K bodies at 33-128 and the
    wide kernels past it, and rows 4 and 6 row 2's body where their own
    on-chip bodies get no plan.
"""
import contextlib

import numpy as np
import pytest
import torch

from bito_tpu_torch.models.phylo_model import (PhyloModel,
                                               PhyloModelSpecification)
from bito_tpu_torch.treelike import _kernels, chunked, paired, pernode, prep
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

from torch_port_cases import (GTR, dummy_child_encoding, emulate_onchip_k_grad,
                              emulate_onchip_k_ll, make_case, max_norm,
                              max_rel, one_torch_thread, torch_params)

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _operands(case, C, dtype=F64):
    """The port's engine at GTR+Gamma C on the CPU, and the kernels'
    operands of its trees: (engine, encoding, P, dP, pi, props, tips,
    weights, edge mask)."""
    te = TreeLikelihoodEngine(
        case.torch_pattern, PhyloModel(PhyloModelSpecification(
            "GTR", f"gamma+{C}")), device="cpu", dtype=dtype)
    trees = case.torch_trees
    enc = te.encode(trees)
    eig, rates, props, clock = te._model_ingredients(
        torch_params(GTR, dtype), len(trees))
    pi, prop = prep.kernel_model(eig, props, dtype)
    P, dP = prep.prepare_inputs_grad(eig, rates, clock,
                                     te.branch_length_matrix(trees, enc),
                                     dtype)
    return (te, enc, P, dP, pi, prop, te._kernel_tips, te._kernel_weights,
            torch.as_tensor(enc.edge_mask, dtype=dtype))


def _check_chunked_tape(dst, tip, e, node_row, mask, P, dP, tips, pi, prop,
                        w, ll=True):
    """The chunked tape through the LL body's emulation (rows by liveness)
    and row 2's (gradient rows by node, chunked.node_src), against the
    plain version."""
    con = chunked.onchip_tape(dst.numpy(), tip.numpy(), "cpu")
    ll_ref, g_ref = chunked.chunked_ll_and_gradients_ref(
        dst, tip, e, node_row, mask, P, dP, tips, pi, prop, w)
    if ll:
        ll_k = emulate_onchip_k_ll(dst, con.child, con.live_row, e, P, tips,
                                   pi, prop, w)
        assert max_rel(ll_k.numpy(), ll_ref.numpy()) < 1e-10
    src = chunked.node_src(node_row, dst.shape[1])
    assert src.is_contiguous() and src.dtype == torch.int32
    rows = emulate_onchip_k_grad(dst, con.child, src, e, P, dP, tips, pi,
                                 prop, w)
    ll2, g = paired.finish_rows(*rows, mask, w)
    assert max_rel(ll2.numpy(), ll_ref.numpy()) < 1e-10
    assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10


def _check_pernode_tape(enc, P, dP, tips, pi, prop, w, mask, ll=True):
    """The per-node ops through the LL body's emulation on ll_tape and row
    2's on paired_grad_tape (gradient rows by node), against the plain
    version."""
    post, pre, root = (torch.as_tensor(x, dtype=torch.int32)
                       for x in (enc.post_ops, enc.pre_ops, enc.root))
    ll_ref, g_ref = pernode.pernode_ll_and_gradients_ref(
        post, pre, root, mask, P, dP, tips, pi, prop, w)
    if ll:
        lt = pernode.ll_tape(enc.post_ops, enc.root, enc.num_taxa,
                             enc.num_slots, "cpu")
        ll_k = emulate_onchip_k_ll(lt.post_dst, lt.child, lt.live_row,
                                   lt.post_e, P, tips, pi, prop, w)
        assert max_rel(ll_k.numpy(), ll_ref.numpy()) < 1e-10
    pt = pernode.paired_grad_tape(enc.post_ops, enc.pre_ops, enc.root,
                                  enc.num_taxa, enc.num_slots, "cpu")
    rows = emulate_onchip_k_grad(pt.post_dst, pt.onchip.child, pt.post_src,
                                 pt.post_e, P, dP, tips, pi, prop, w)
    ll2, g = paired.finish_rows(*rows, mask, w)
    assert max_rel(ll2.numpy(), ll_ref.numpy()) < 1e-10
    assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10


@pytest.mark.parametrize("C", [33, 64])
def test_k_emulation_matches_the_plain_versions(C):
    """The K bodies' walk in their layout (K = 2 places a lane of 32; at
    33 every lane's second place but lane 0's idle) in float64 against
    the plain versions, within 1e-10: the LL body and the grad body on
    the paired tape, the chunked tape (binary and trifurcating roots, and
    the hand-built tape with a DUMMY child, read as ones) and the
    per-node tapes."""
    assert paired.lane_categories(C) == 2
    for rooted in (False, True):
        case = make_case(seed=80 + C + rooted, num_taxa=8, num_sites=14,
                         num_trees=2, rooted=rooted)
        te, enc, P, dP, pi, prop, tips, w, mask = _operands(case, C)
        dst, tip, src, e, _ = te._paired_tapes(enc)
        on = paired.onchip_tape(dst.numpy(), tip.numpy(), "cpu",
                                post_src=src.numpy(), post_e=e.numpy(),
                                edges=P.shape[1])
        ll_k = emulate_onchip_k_ll(dst, on.child, on.live_row, e, P, tips,
                                   pi, prop, w)
        rows = emulate_onchip_k_grad(dst, on.child, src, e, P, dP, tips, pi,
                                     prop, w)
        ll2, g = paired.finish_rows(*rows, mask, w)
        ll_ref, g_ref = paired.paired_ll_and_gradients_ref(
            dst, tip, src, e, mask, P, dP, tips, pi, prop, w)
        assert max_rel(ll_k.numpy(), ll_ref.numpy()) < 1e-10
        assert max_rel(ll2.numpy(), ll_ref.numpy()) < 1e-10
        assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10
        cdst, ctip, cedge, crow, _ = te._chunked_tapes(enc)
        _check_chunked_tape(cdst, ctip, cedge, crow, mask, P, dP, tips, pi,
                            prop, w)
        _check_pernode_tape(enc, P, dP, tips, pi, prop, w, mask)
    enc = dummy_child_encoding()
    ce = chunked.build_chunked_encoding(enc, chunked.W)
    rng = np.random.default_rng(C)
    S, N1 = 7, enc.num_slots + 1
    P = torch.as_tensor(rng.uniform(0.05, 1.0, (1, N1, C, 4, 4)))
    P = P / P.sum(-1, keepdim=True)
    P[:, -1] = torch.eye(4, dtype=F64)
    dP = torch.as_tensor(rng.normal(0, 0.3, (1, N1, C, 4, 4)))
    dP[:, -1] = 0
    _check_chunked_tape(
        torch.as_tensor(ce.post_dst), torch.as_tensor(ce.tip_slot),
        torch.as_tensor(ce.post_e), torch.as_tensor(ce.node_row),
        torch.as_tensor(enc.edge_mask).to(F64), P, dP,
        torch.as_tensor(rng.uniform(0, 1, (3, 4, S))),
        torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=F64),
        torch.as_tensor(rng.dirichlet(np.ones(C))),
        torch.as_tensor(rng.integers(1, 4, S)).to(F64))


@pytest.mark.parametrize("C", [17, 32, 64])
def test_rows_4_and_6_through_row_2s_body_match_the_plain_versions(C):
    """Row 4's chunked tape (walked one grid op at a time, gradient rows
    by node through chunked.node_src) and row 6's per-node ops as a
    paired tape (pernode.paired_grad_tape, rows by node id)
    through row 2's body's emulation (K = 1 on 32 lanes at 17 and 32,
    K = 2 at 64), against chunked_ll_and_gradients_ref and
    pernode_ll_and_gradients_ref within 1e-10, on unrooted and rooted
    trees."""
    for rooted in (False, True):
        case = make_case(seed=90 + C + rooted, num_taxa=7, num_sites=12,
                         num_trees=2, rooted=rooted)
        te, enc, P, dP, pi, prop, tips, w, mask = _operands(case, C)
        cdst, ctip, cedge, crow, _ = te._chunked_tapes(enc)
        _check_chunked_tape(cdst, ctip, cedge, crow, mask, P, dP, tips, pi,
                            prop, w, ll=False)
        _check_pernode_tape(enc, P, dP, tips, pi, prop, w, mask, ll=False)


def _launcher_smem(kernel, rows, M, N1, C, cols):
    """onchip::smem_bytes as the launchers call it (csrc/onchip.cuh): rows
    of K float4s a thread, the ring's 2 (LL) or 4 (grad) matrices a buffer
    of rows of every category, the tape's ints."""
    K = -(-C // 32)
    threads = cols * 32
    mats = 2 * (2 if kernel == "ll" else 4)
    tape = (6 if kernel == "ll" else 7) * M
    return rows * K * threads * 16 + mats * 32 * K * 4 * 16 + -(
        -tape * 4 // 16) * 16


@pytest.mark.parametrize("C,K,ll_warps,grad_warps", [
    (33, 2, 16, 7), (64, 2, 16, 7), (65, 3, 13, 4), (96, 3, 13, 4),
    (97, 4, 9, 3), (128, 4, 9, 3)])
def test_k_plans_at_the_flagship(C, K, ll_warps, grad_warps):
    """At the flagship (M = 28 ops, N1 = 53 edges, 25 grad rows, 10 live
    LL rows on the chunked tape): K = ceil(C / 32) places on 32 lanes and
    the ring, a pattern a warp; the grad body holds 7, 4 and 3 warps at
    K = 2, 3, 4 (26.6, 39.9, 53.2 KB of rows a warp beside a ring of 32,
    48, 64 KB; at most 8, its launch bound), the LL body more; each
    plan's bytes are what the C++ launcher computes.  The grad plan needs
    K_MIN_WARPS["grad"] (4) warps on the paired and chunked tapes, so at
    K = 4 their wide kernels take the flagship; the per-node ops' paired
    tape (pernode.paired_plan, a 27-taxon tree) takes it at
    paired.MIN_WARPS (3).
    Rows 4 and 6's own bodies get no plan."""
    grad = paired.onchip_plan("grad", 25, 28, 53, C, ring=True)
    ll = chunked.ll_plan(10, 28, 53, C)
    assert paired.onchip_plan("grad", 25, 28, 53, C) == (
        grad if grad_warps >= paired.K_MIN_WARPS["grad"] else None)
    for kernel, rows, plan, warps in (("grad", 25, grad, grad_warps),
                                      ("ll", 10, ll, ll_warps)):
        assert plan == paired.OnchipPlan(
            32, warps, True, _launcher_smem(kernel, rows, 28, 53, C, warps),
            categories_per_lane=K)
        assert plan.smem == paired.smem_bytes(kernel, rows, 28, 53, C, warps,
                                              True) <= paired.SMEM_BYTES
        assert _launcher_smem(kernel, rows, 28, 53, C,
                              min(warps + 1, 16)) > paired.SMEM_BYTES or (
                                  warps == 16)
    assert paired.onchip_plan("ll", 10, 28, 53, C) == ll
    assert chunked.paired_plan(25, 28, 53, C) == paired.onchip_plan(
        "grad", 25, 28, 53, C)
    assert chunked.onchip_plan(25, 28, 53, C) is None
    case = make_case(seed=3, num_taxa=27, num_sites=8, num_trees=2)
    _, enc, *_ = _operands(case, C)
    tape = pernode.onchip_tape(enc.post_ops, enc.pre_ops, enc.root,
                               enc.num_taxa, enc.num_slots, "cpu")
    N1 = enc.num_slots + 1
    assert pernode.onchip_plan(tape.rows, tape.ints, N1, C) is None
    plan = pernode.paired_plan(tape.paired, N1, C)
    M = tape.paired.post_dst.shape[1]
    assert plan == paired.onchip_plan("grad", tape.paired.onchip.grad_rows,
                                      M, N1, C, ring=True)
    assert plan.categories_per_lane == K and plan.lanes == 32 and plan.ring
    assert plan.cols >= paired.MIN_WARPS


def test_plans_refuse_past_the_largest_k_and_below_min_warps():
    """Past 128 categories (K = 5) no on-chip plan; at K = 2..4 no staged
    plan (the ring only); a tree whose rows leave fewer than MIN_WARPS
    warps gets none unless asked for at one warp (ring=True), and none
    where one warp does not fit.  The own bodies of rows 4 and 6 hold a
    category a lane: None past 32."""
    top = paired.ONCHIP_MAX_CATEGORIES
    assert top == 32 * paired.MAX_LANE_CATEGORIES == 128
    for kernel in ("ll", "grad"):
        assert paired.onchip_plan(kernel, 10, 28, 53, top).categories_per_lane == 4
        assert paired.onchip_plan(kernel, 10, 28, 53, top + 1) is None
        assert paired.onchip_plan(kernel, 10, 28, 53, 64, ring=False) is None
    assert chunked.ll_plan(10, 28, 53, top + 1) is None
    assert chunked.paired_plan(25, 28, 53, top + 1) is None
    # At K = 2 a grad row is 1 KB a warp: 3 warps of 70 rows do not fit
    # beside the ring, 2 do.
    rows = 70
    assert _launcher_smem("grad", rows, 72, 74, 64, 3) > paired.SMEM_BYTES
    assert _launcher_smem("grad", rows, 72, 74, 64, 2) <= paired.SMEM_BYTES
    assert paired.onchip_plan("grad", rows, 72, 74, 64) is None
    forced = paired.onchip_plan("grad", rows, 72, 74, 64, ring=True)
    assert forced.cols == 2 and forced.categories_per_lane == 2
    assert paired.onchip_plan("grad", 250, 252, 254, 64, ring=True) is None
    # The LL body needs K_MIN_WARPS["ll"] (6) warps: 40 live rows leave 5
    # at K = 2 (40 KB of rows a warp beside a 16 KB ring).
    assert _launcher_smem("ll", 40, 44, 46, 64, 5) <= paired.SMEM_BYTES
    assert _launcher_smem("ll", 40, 44, 46, 64, 6) > paired.SMEM_BYTES
    assert paired.onchip_plan("ll", 40, 44, 46, 64) is None
    assert paired.onchip_plan("ll", 40, 44, 46, 64, ring=True).cols == 5
    assert paired.onchip_plan("ll", 40, 44, 46, 64, k_min_warps=5).cols == 5
    for C in (33, 64, 100):
        assert chunked.onchip_plan(10, 12, 14, C, least=1) is None
        assert pernode.onchip_plan(3, 40, 9, C, least=1) is None


class _FakeLibrary:
    """The kernel library's entry points, recorded: each call's name and
    arguments, and code 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("bito_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers on CPU tensors as on a card: the plain-version test,
    the device checks, the library, the stream and the device switch
    faked."""
    lib = _FakeLibrary()
    monkeypatch.setattr(paired, "on_cpu", lambda t: False)
    for module in (paired, chunked, pernode):
        monkeypatch.setattr(module, "_check_cuda_tensors", lambda *a: None)
    monkeypatch.setattr(_kernels, "library", lambda: lib)
    monkeypatch.setattr(paired, "_stream", lambda: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    return lib


LAUNCHERS = (paired.paired_ll_onchip, paired.paired_ll_global,
             paired.paired_grad_onchip, paired.paired_grad_global,
             chunked.chunked_ll_onchip, chunked.chunked_ll_global,
             chunked.chunked_grad_onchip, chunked.chunked_grad_paired,
             chunked.chunked_grad_global, pernode.pernode_ll_onchip,
             pernode.pernode_ll_global, pernode.pernode_grad_onchip,
             pernode.pernode_grad_paired, pernode.pernode_grad_global)


@pytest.mark.parametrize("C", [4, 17, 32, 33, 64, 96, 128, 129])
def test_wrappers_take_the_k_bodies_to_128_categories(fake_card, C):
    """The six wrappers on a 27-taxon batch (the flagship's tree shape) in
    float32, the card faked: rows 1, 3 and 5 launch the on-chip LL body
    at every count to 128 (K categories a lane past 32) and the wide
    kernels past it; row 2 the on-chip grad body to 96 (at K = 4 a block
    holds 3 warps, under K_MIN_WARPS) and the wide kernel past it; rows 4
    and 6 their own on-chip bodies at 4, row 2's body
    (bito_paired_grad_onchip, counted on their own launchers, gradient
    rows by node) from 17,
    where their own get no plan, to 96 (row 4) and 128 (row 6, whose wide
    kernel is the slowest), and the global bodies past that.  Each
    launcher counts its launch; the engine routes auto and
    kernel="chunked" to these wrappers at every count."""
    lib = fake_card
    case = make_case(seed=21, num_taxa=27, num_sites=20, num_trees=2)
    te, enc, P, dP, pi, prop, tips, w, mask = _operands(case, C,
                                                        torch.float32)
    te.device = torch.device("cuda")
    assert te._route(True) == "paired"
    te.kernel = "chunked"
    assert te._route(True) == "chunked"
    te.device = torch.device("cpu")
    dst, tip, src, e, _ = te._paired_tapes(enc)
    on = paired.onchip_tape(dst.numpy(), tip.numpy(), "cpu",
                            post_src=src.numpy(), post_e=e.numpy(),
                            edges=P.shape[1])
    cdst, ctip, cedge, crow, _ = te._chunked_tapes(enc)
    con = chunked.onchip_tape(cdst.numpy(), ctip.numpy(), "cpu")
    post, pre, root = (torch.as_tensor(x, dtype=torch.int32)
                       for x in (enc.post_ops, enc.pre_ops, enc.root))
    lt = pernode.ll_tape(enc.post_ops, enc.root, enc.num_taxa, enc.num_slots,
                         "cpu")
    gt = pernode.onchip_tape(enc.post_ops, enc.pre_ops, enc.root,
                             enc.num_taxa, enc.num_slots, "cpu")
    onchip = C <= paired.ONCHIP_MAX_CATEGORIES
    grad_k = C <= 96  # the grad body holds K_MIN_WARPS warps
    own = C <= 16  # rows 4 and 6's own on-chip bodies get a plan
    N1 = P.shape[1]
    calls = [
        (lambda: paired.paired_log_likelihoods(dst, tip, e, P, tips, pi, prop,
                                               w, onchip=on),
         "bito_paired_ll_onchip" if onchip else "bito_paired_ll",
         paired.paired_ll_onchip if onchip else paired.paired_ll_global),
        (lambda: paired.paired_ll_and_gradients(
            dst, tip, src, e, mask, P, dP, tips, pi, prop, w, onchip=on),
         "bito_paired_grad_onchip" if grad_k else "bito_paired_grad",
         paired.paired_grad_onchip if grad_k else paired.paired_grad_global),
        (lambda: chunked.chunked_log_likelihoods(
            cdst, ctip, cedge, P, tips, pi, prop, w, onchip=con),
         "bito_paired_ll_onchip" if onchip else "bito_chunked_ll",
         chunked.chunked_ll_onchip if onchip else chunked.chunked_ll_global),
        (lambda: chunked.chunked_ll_and_gradients(
            cdst, ctip, cedge, crow, mask, P, dP, tips, pi, prop, w,
            onchip=con),
         ("bito_chunked_grad_onchip" if own else "bito_paired_grad_onchip"
          if grad_k else "bito_chunked_grad"),
         (chunked.chunked_grad_onchip if own else chunked.chunked_grad_paired
          if grad_k else chunked.chunked_grad_global)),
        (lambda: pernode.pernode_log_likelihoods(post, root, P, tips, pi,
                                                 prop, w, onchip=lt),
         "bito_paired_ll_onchip" if onchip else "bito_pernode_ll",
         pernode.pernode_ll_onchip if onchip else pernode.pernode_ll_global),
        (lambda: pernode.pernode_ll_and_gradients(
            post, pre, root, mask, P, dP, tips, pi, prop, w, onchip=gt),
         ("bito_pernode_grad_onchip" if own else "bito_paired_grad_onchip"
          if onchip else "bito_pernode_grad"),
         (pernode.pernode_grad_onchip if own else pernode.pernode_grad_paired
          if onchip else pernode.pernode_grad_global))]
    for call, entry, launcher in calls:
        before = [f.launches for f in LAUNCHERS]
        lib.calls.clear()
        call()
        assert [c[0] for c in lib.calls] == [entry], entry
        ran = [f.launches - n for f, n in zip(LAUNCHERS, before)]
        assert ran == [int(f is launcher) for f in LAUNCHERS], entry
        args = lib.calls[0][1]
        if entry.endswith("_onchip") and C > paired.ONCHIP_CATEGORIES:
            assert args[-1] is None  # the stream
            ring = args[20] if "grad" in entry else args[17]
            assert ring == 1  # K places a lane take the ring
        if entry == "bito_paired_grad_onchip":  # M, T, N1, C of its tape
            tape = {paired.paired_grad_onchip: dst,
                    chunked.chunked_grad_paired: cdst,
                    pernode.pernode_grad_paired: gt.paired.post_dst}[launcher]
            assert args[13:17] == (tape.shape[1], tips.shape[0], N1, C)
