"""The kernels past 32 rate categories, on the CPU: what runs here of them.

  - the port's float64 engine at gamma+33 and weibull+48 on
    kernel="cuda", "chunked" (the plain versions on the CPU) and "scan",
    and the per-node functions, against bito_tpu's float64 scan engine,
    within 1e-10 (LL relative, gradients of the largest);
  - the port's float32 plain versions of rows 1-6 at C = 33 against
    bito_tpu's Pallas paired, chunked and per-node kernels in interpret
    mode (bito_tpu pads C to 36 for its paired kernel and to 34 for its
    chunked one: zero proportions), within 1e-5 (LL) and 5e-5
    (gradients);
  - at 64 states the port's float64 engine at MG94+Gamma33 on
    kernel="cuda" (the plain A=64 versions) and the per-node functions
    against bito_tpu's float64 scan engine, within 1e-10;
  - the float64 emulations of the wide kernels (a lane of 32 holding K =
    ceil(C / 32) categories, tests/torch_port_cases.py) on the paired,
    chunked and per-node tapes at C = 33 and 64 against the plain
    versions, within 1e-10: the layout's offsets are the kernels';
  - the route: auto takes the paired kernels on a card in float32 for a
    shared model at 33 and 64 categories, at 4 and at 64 states;
  - the launchers' slices of trees and their memory check at C = 64,
    with the card and the kernel library faked: a batch that must split
    launches slice by slice, a tree too large raises before any launch.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu.core.newick import parse_newick_text as jax_parse
from bito_tpu.core.site_pattern import CodonSitePattern as JaxCodonPattern
from bito_tpu.models.phylo_model import PhyloModel as JaxModel
from bito_tpu.models.phylo_model import PhyloModelSpecification as JaxSpec
from bito_tpu.treelike import pallas_pruning
from bito_tpu.treelike.engine import TreeLikelihoodEngine as JaxEngine
from bito_tpu_torch import _synthetic
from bito_tpu_torch.convert import params_from_numpy
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.core.site_pattern import CodonSitePattern
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.treelike import _kernels, chunked, paired, pernode, prep
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

from torch_port_cases import (GTR, dummy_child_encoding,
                              emulate_wide_paired, emulate_wide_pernode,
                              jax_params, make_case, max_norm, max_rel,
                              one_torch_thread, pernode_operands,
                              torch_params)

F64 = torch.float64
MG94 = {"substitution_model_rates": np.array([2.5, 0.3]),
        "substitution_model_frequencies": np.array([0.3, 0.2, 0.3, 0.2]),
        "site_model_parameters": np.array([0.8])}


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


def _pernode_results(te, case, dtype=F64):
    ops, extra = pernode_operands(te, case, GTR, dtype=dtype)
    return (pernode.pernode_log_likelihoods(**ops),
            *pernode.pernode_ll_and_gradients(**ops, **extra))


@pytest.mark.parametrize("spec", [("GTR", "gamma+33"), ("GTR", "weibull+48")],
                         ids=["gamma33", "weibull48"])
def test_float64_engine_matches_bito_tpu_past_32_categories(spec):
    """The port's float64 engine on kernel='cuda', 'chunked' and 'scan',
    and the per-node functions on its operands, against bito_tpu's
    float64 scan engine: LL and branch gradients within 1e-10."""
    case = make_case(seed=33, num_taxa=6, num_sites=60, num_trees=3)
    je, te = _engines(case, spec)
    assert te.model.category_count == int(spec[1].split("+")[1])
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
    ll, ll2, g = _pernode_results(te, case)
    assert max_rel(ll.numpy(), ll_ref) < 1e-10
    assert max_rel(ll2.numpy(), ll_ref) < 1e-10
    assert max_norm(g.numpy(), g_ref) < 1e-10


@pytest.mark.parametrize("kernels", [("cuda", "pallas_interpret", 36),
                                     ("chunked", "chunked_interpret", 34)],
                         ids=["paired", "chunked"])
def test_plain_versions_match_pallas_interpret_at_33_categories(kernels):
    """5 taxa x 32 patterns x 2 trees, GTR+Gamma33: bito_tpu's paired
    (rows 1-2) and chunked (rows 3-4) Pallas kernels in interpret mode,
    its categories padded to 36 and 34 with zero proportions, against
    the port's float32 plain versions on its own engine's route."""
    ours, theirs, padded = kernels
    case = make_case(seed=17, num_taxa=5, num_sites=32, num_trees=2)
    je, te = _engines(case, ("GTR", "gamma+33"), torch.float32)
    je.kernel, te.kernel = theirs, ours
    assert je._padded_categories() == padded
    ll_pl, g_pl = (np.asarray(x) for x in je.ll_and_branch_gradients(
        case.jax_trees, jax_params(GTR)))
    llo_pl = np.asarray(je.log_likelihoods(case.jax_trees, jax_params(GTR)))
    params = torch_params(GTR, torch.float32)
    ll = te.log_likelihoods(case.torch_trees, params)
    ll2, g = te.ll_and_branch_gradients(case.torch_trees, params)
    assert ll.dtype == torch.float32
    assert max_rel(ll.numpy(), llo_pl) < 1e-5
    assert max_rel(ll2.numpy(), ll_pl) < 1e-5
    assert max_norm(g.numpy(), g_pl) < 5e-5


def test_pernode_plain_versions_match_pallas_interpret_at_33_categories():
    """5 taxa x 32 patterns x 2 trees, GTR+Gamma33: bito_tpu's per-node
    Pallas kernels (rows 5-6) in interpret mode (category_count=33)
    against the port's float32 plain versions on the port's operands."""
    B = 2
    case = make_case(seed=19, num_taxa=5, num_sites=32, num_trees=B)
    je, te = _engines(case, ("GTR", "gamma+33"))
    enc = je.encode(case.jax_trees)
    bl = je.branch_length_matrix(case.jax_trees, enc)
    ingredients = je._model_ingredients(jax_params(GTR), B)
    sp = je.site_pattern
    tips = jnp.asarray(sp.tip_partials(), jnp.float32)
    tapes = [jnp.asarray(x) for x in (enc.post_ops, enc.pre_ops, enc.root)]
    static = dict(num_slots=enc.num_slots, category_count=33,
                  s_tile=je._pallas_s_tile(), interpret=True)
    P_blk, tips_flat, piprop, w = pallas_pruning.prepare_inputs(
        enc, tips, sp.weights, *ingredients, bl, je.pattern_pad)
    llo_pl = pallas_pruning.pallas_log_likelihoods(
        tapes[0], tapes[2], P_blk, tips_flat, piprop, w, **static)
    ll_pl, g_pl = pallas_pruning.pallas_ll_and_gradients(
        *tapes, jnp.asarray(enc.edge_mask, jnp.float32),
        *pallas_pruning.prepare_inputs_grad(enc, tips, sp.weights,
                                            *ingredients, bl,
                                            je.pattern_pad),
        **static)
    ll, ll2, g = _pernode_results(te, case, torch.float32)
    assert ll.dtype == torch.float32
    assert max_rel(ll.numpy(), np.asarray(llo_pl)) < 1e-5
    assert max_rel(ll2.numpy(), np.asarray(ll_pl)) < 1e-5
    assert max_norm(g.numpy(), np.asarray(g_pl)) < 5e-5


def _codon_engines(site, seed, num_taxa, num_trees, codons, distinct):
    """bito_tpu's float64 scan engine and the port's float64 engine on
    the CPU over one synthetic MG94 case, with both tree sets and the
    port's params."""
    text = _synthetic.random_trees_newick(seed, num_taxa, num_trees)
    tc, jc = parse_newick_text(text), jax_parse(text)
    aln = _synthetic.codon_alignment(seed + 1, tc.taxon_names, codons,
                                     distinct)
    je = JaxEngine(JaxCodonPattern(aln, jc.taxon_names),
                   JaxModel(JaxSpec("MG94", site)))
    je.kernel = "scan"
    te = TreeLikelihoodEngine(CodonSitePattern(aln, tc.taxon_names),
                              PhyloModel(PhyloModelSpecification("MG94", site)),
                              device="cpu", dtype=F64)
    return je, te, jc.trees, tc.trees, params_from_numpy(MG94, "cpu", F64)


def test_float64_codon_engine_matches_bito_tpu_at_33_categories():
    """MG94+Gamma33: the port's float64 engine on kernel='cuda' (the plain
    A=64 versions here) and the per-node functions at 64 states on its
    own operands (uniformized P, dP = Q P), against bito_tpu's float64
    scan engine within 1e-10."""
    je, te, jt, tt, params = _codon_engines("gamma+33", 7, 5, 2, 30, 24)
    assert te.model.category_count == 33 and te.num_states == 64
    ll_ref, g_ref = (np.asarray(x) for x in je.ll_and_branch_gradients(
        jt, {k: jnp.asarray(v) for k, v in MG94.items()}))
    te.kernel = "cuda"
    ll = te.log_likelihoods(tt, params)
    ll2, g = te.ll_and_branch_gradients(tt, params)
    assert max_rel(ll.numpy(), ll_ref) < 1e-10
    assert max_rel(ll2.numpy(), ll_ref) < 1e-10
    assert max_norm(g.numpy(), g_ref) < 1e-10
    enc = te.encode(tt)
    eig, rates, props, clock = te._model_ingredients(params, len(tt))
    pi, prop = prep.kernel_model(eig, props, F64)
    P, dP = prep.prepare_inputs_grad_q(
        eig, rates, clock, te.branch_length_matrix(tt, enc), F64,
        Q=te._rate_Q(params))
    post, pre, root = (torch.as_tensor(x, dtype=torch.int32)
                       for x in (enc.post_ops, enc.pre_ops, enc.root))
    mask = torch.as_tensor(enc.edge_mask, dtype=F64)
    tips, w = te._kernel_tips, te._kernel_weights
    ll = pernode.pernode_log_likelihoods(post, root, P, tips, pi, prop, w)
    ll2, g = pernode.pernode_ll_and_gradients(post, pre, root, mask, P, dP,
                                              tips, pi, prop, w)
    assert max_rel(ll.numpy(), ll_ref) < 1e-10
    assert max_rel(ll2.numpy(), ll_ref) < 1e-10
    assert max_norm(g.numpy(), g_ref) < 1e-10


def _model_operands(te, trees, params):
    enc = te.encode(trees)
    eig, rates, props, clock = te._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props, F64)
    P, dP = prep.prepare_inputs_grad(eig, rates, clock,
                                     te.branch_length_matrix(trees, enc),
                                     F64)
    return enc, P, dP, pi, prop


@pytest.mark.parametrize("C", [33, 64])
def test_wide_emulation_matches_the_plain_versions(C):
    """The wide kernels' walk in their layout (K = 2 places a lane of 32;
    at 33 every lane's second place but lane 0's idle) in float64 against
    the plain versions, within 1e-10: on the paired tape, the chunked
    tape (binary and trifurcating roots, and the hand-built tape with a
    DUMMY child, read as ones) and the per-node tapes."""
    assert paired.lanes(C) == 32 and paired.lane_categories(C) == 2
    for rooted in (False, True):
        case = make_case(seed=60 + C + rooted, num_taxa=8, num_sites=22,
                         num_trees=2, rooted=rooted)
        _, te = _engines(case, ("GTR", f"gamma+{C}"))
        params = torch_params(GTR)
        enc, P, dP, pi, prop = _model_operands(te, case.torch_trees, params)
        tips, w = te._kernel_tips, te._kernel_weights
        mask = torch.as_tensor(enc.edge_mask, dtype=F64)
        # The paired tape.
        dst, tip, src, e, _ = te._paired_tapes(enc)
        rows = emulate_wide_paired(dst, tip, src, e, P, dP, tips, pi, prop,
                                   w, chunked=False)
        ll, g = paired.finish_rows(*rows, mask, w)
        ll_ref, g_ref = paired.paired_ll_and_gradients_ref(
            dst, tip, src, e, mask, P, dP, tips, pi, prop, w)
        assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10
        assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10
        # The chunked tape, children by code.
        cdst, ctip, cedge, crow, _ = te._chunked_tapes(enc)
        child = chunked.onchip_tape(cdst.numpy(), ctip.numpy(), "cpu").child
        rows = emulate_wide_paired(cdst, child, None, cedge, P, dP, tips, pi,
                                   prop, w, chunked=True)
        ll, g = chunked.finish_rows(*rows, crow, mask, w)
        ll_ref, g_ref = chunked.chunked_ll_and_gradients_ref(
            cdst, ctip, cedge, crow, mask, P, dP, tips, pi, prop, w)
        assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10
        assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10
        # The per-node tapes.
        post, pre, root = (torch.as_tensor(x, dtype=torch.int32)
                           for x in (enc.post_ops, enc.pre_ops, enc.root))
        rows = emulate_wide_pernode(post, pre, root, P, dP, tips, pi, prop,
                                    w)
        ll, g = pernode.finish_rows(*rows, mask, w)
        ll_ref, g_ref = pernode.pernode_ll_and_gradients_ref(
            post, pre, root, mask, P, dP, tips, pi, prop, w)
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
    rows = emulate_wide_paired(ops["post_dst"], child, None, ops["post_e"],
                               P, dP, ops["tips"], ops["pi"], ops["props"],
                               ops["weights"], chunked=True)
    ll, g = chunked.finish_rows(*rows, extra["node_row"],
                                extra["edge_mask"], ops["weights"])
    ll_ref, g_ref = chunked.chunked_ll_and_gradients_ref(**ops, **extra)
    assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10
    assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10


def test_route_takes_the_paired_kernels_past_32_categories():
    """_route on a card device in float32 (the engine built on the CPU and
    pointed at the card, all _route reads): auto takes the paired kernels
    for a shared model at 33 and 64 categories, at 4 states and at 64
    (MG94); the scan tape for per-tree rows and in float64."""
    case = make_case(seed=5, num_taxa=5, num_sites=20, num_trees=1)
    names = list(case.alignment)
    codons = CodonSitePattern(_synthetic.codon_alignment(6, names, 20, 15),
                              names)
    for model, sp in (("GTR", case.torch_pattern), ("MG94", codons)):
        for C in (33, 64):
            te = TreeLikelihoodEngine(
                sp, PhyloModel(PhyloModelSpecification(model, f"gamma+{C}")),
                device="cpu", dtype=torch.float32)
            assert te.model.category_count == C
            assert te._route(True) == "scan"  # on the CPU
            te.device = torch.device("cuda")
            assert te._route(True) == "paired", (model, C)
            assert te._route(False) == "scan"
            te.dtype = F64
            assert te._route(True) == "scan"


class _FakeLibrary:
    """The kernel library's entry points, recorded: each call's arguments,
    and code 0."""

    def __init__(self):
        self.calls = []

    def bito_paired_a64_tile(self):
        return paired.A64_TILE

    def __getattr__(self, name):
        if not name.startswith("bito_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_card(monkeypatch):
    """The launchers on CPU tensors: the library, the stream, the device
    switch and the chunked launchers' device check of `child` faked;
    set_budget(tree_bytes, n) makes the card's budget n + 1/2 trees of
    `tree_bytes`, and a scratch past it fail to allocate
    (torch.cuda.OutOfMemoryError)."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_kernels, "library", lambda: lib)
    monkeypatch.setattr(paired, "_a64_library", lambda: lib)
    monkeypatch.setattr(paired, "_stream", lambda: None)
    monkeypatch.setattr(chunked, "_check_cuda_tensors", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    launch_sliced, state = paired.launch_sliced, {}

    def on_the_card(entry, B, alloc, launch, device, tree_bytes=None):
        def sized(n, dev):  # a scratch past the budget fails to allocate
            out = alloc(n, dev)
            if dev != "meta" and sum(t.numel() * t.element_size()
                                     for t in out) > state["budget"]:
                raise torch.cuda.OutOfMemoryError("the card is full")
            return out
        return launch_sliced(entry, B, sized, launch, device, tree_bytes)

    monkeypatch.setattr(paired, "launch_sliced", on_the_card)
    monkeypatch.setattr(paired, "scratch_budget",
                        lambda device: state["budget"])

    def set_budget(tree_bytes, trees):
        state["budget"] = int((trees + 0.5) * tree_bytes)
    return lib, set_budget


def test_launchers_slice_the_trees_and_check_memory_at_64_categories(
        fake_card):
    """Past 32 categories each global launcher (rows 1-6) and each A=64
    launcher (rows 1b-2b) at C = 64 allocates its scratch for the batch
    and launches once where it fits; on a card that holds two trees'
    scratch, 5 trees take three launches, [0, 2), [2, 4), [4, 5), each
    with its slice's tapes, matrices and output rows; on a card that holds
    less than one tree it raises torch.cuda.OutOfMemoryError naming the
    bytes, before any launch.  A tree's bytes are the allocation's: at
    the flagship's shape (M = 28, 1,024 patterns) 59 x 1,024 x 2 x 32
    float4 slots, 61.9 MB (paired and chunked tapes; the per-node grad
    body's rows and up values 54.5 MB)."""
    lib, set_budget = fake_card
    C, B = 64, 5
    case = make_case(seed=71, num_taxa=6, num_sites=30, num_trees=B)
    _, te = _engines(case, ("GTR", f"gamma+{C}"), torch.float32)
    params = torch_params(GTR, torch.float32)
    enc = te.encode(case.torch_trees)
    eig, rates, props, clock = te._model_ingredients(params, B)
    pi, prop = prep.kernel_model(eig, props, torch.float32)
    P, dP = prep.prepare_inputs_grad(
        eig, rates, clock, te.branch_length_matrix(case.torch_trees, enc),
        torch.float32)
    tips, w = te._kernel_tips, te._kernel_weights
    S = tips.shape[-1]
    dst, tip, src, e, _ = te._paired_tapes(enc)
    cdst, ctip, cedge, _, _ = te._chunked_tapes(enc)
    child = chunked.onchip_tape(cdst.numpy(), ctip.numpy(), "cpu").child
    post, pre, root = (torch.as_tensor(x, dtype=torch.int32)
                       for x in (enc.post_ops, enc.pre_ops, enc.root))
    M, MW, N1, T = dst.shape[1], cdst.shape[1], P.shape[1], tips.shape[0]
    Sp = -(-S // 4) * 4
    slot = Sp * 2 * 32 * 16  # a slot's bytes: K = 2 places of 32 float4
    # entry -> (call, a tree's scratch bytes, the tape, the tree count's
    # argument)
    launchers = {
        "bito_paired_ll": (lambda: paired.paired_ll_global(
            dst, tip, e, P, tips, pi, prop), (2 * M + 3) * slot, dst, 10),
        "bito_paired_grad": (lambda: paired.paired_grad_global(
            dst, tip, src, e, P, dP, tips, pi, prop, w),
            (2 * M + 3) * slot, dst, 14),
        "bito_chunked_ll": (lambda: chunked.chunked_ll_global(
            cdst, ctip, cedge, P, tips, pi, prop, child=child),
            (2 * MW + 3) * slot, cdst, 11),
        "bito_chunked_grad": (lambda: chunked.chunked_grad_global(
            cdst, ctip, cedge, P, dP, tips, pi, prop, w, child=child),
            (2 * MW + 3) * slot, cdst, 14),
        "bito_pernode_ll": (lambda: pernode.pernode_ll_global(
            post, root, P, tips, pi, prop), (N1 - T) * slot, post, 9),
        "bito_pernode_grad": (lambda: pernode.pernode_grad_global(
            post, pre, root, P, dP, tips, pi, prop, w),
            2 * (N1 - T) * slot, post, 14),
    }
    a64_M, a64_S = 28, 640
    assert paired.a64_tree_bytes(a64_M, a64_S, C) == 4 * (
        59 * C * 64 * a64_S + 59 * (2 + C) * a64_S + 5 * 59)
    for entry, (call, tree, tape, at) in launchers.items():
        before = {f: f.launches for f in (
            paired.paired_ll_global, paired.paired_grad_global,
            chunked.chunked_ll_global, chunked.chunked_grad_global,
            pernode.pernode_ll_global, pernode.pernode_grad_global)}
        for trees, want in ((B, [(0, B)]), (2, [(0, 2), (2, 4), (4, 5)])):
            set_budget(tree, trees)
            lib.calls.clear()
            call()
            assert [c[0] for c in lib.calls] == [entry] * len(want), entry
            for (_, args), (b0, b1) in zip(lib.calls, want):
                assert args[0] == tape[b0].data_ptr(), entry  # the tape
                assert P[b0].data_ptr() in args, entry  # the matrices
                assert args[at] == b1 - b0 and C in args[at:], entry
        ran = sum(f.launches - n for f, n in before.items())
        assert ran == 4, entry
        set_budget(tree, 0)
        lib.calls.clear()
        with pytest.raises(torch.cuda.OutOfMemoryError,
                           match=f"{tree} bytes a tree"):
            call()
        assert lib.calls == []
    # The A=64 launchers, the same way, on a tiny codon case at C = 64.
    text = _synthetic.random_trees_newick(3, 5, B)
    tc = parse_newick_text(text)
    aln = _synthetic.codon_alignment(4, tc.taxon_names, 10, 9)
    ce = TreeLikelihoodEngine(
        CodonSitePattern(aln, tc.taxon_names),
        PhyloModel(PhyloModelSpecification("MG94", f"gamma+{C}")),
        device="cpu", dtype=torch.float32)
    cparams = params_from_numpy(MG94, "cpu", torch.float32)
    cenc = ce.encode(tc.trees)
    eig, rates, props, clock = ce._model_ingredients(cparams, B)
    pi, prop = prep.kernel_model(eig, props, torch.float32)
    P, dP = prep.prepare_inputs_grad_q(
        eig, rates, clock, ce.branch_length_matrix(tc.trees, cenc),
        torch.float32, Q=ce._rate_Q(cparams))
    dst, tip, src, e, _ = ce._paired_tapes(cenc)
    tips, w = ce._kernel_tips, ce._kernel_weights
    tree = paired.a64_tree_bytes(dst.shape[1], -(-tips.shape[-1] // 4) * 4,
                                 C)
    for entry, call in (
            ("bito_paired_ll_a64", lambda: paired.paired_ll_a64(
                dst, tip, e, P, tips, pi, prop)),
            ("bito_paired_grad_a64", lambda: paired.paired_grad_a64(
                dst, tip, src, e, P, dP, tips, pi, prop, w))):
        for trees, want in ((B, [(0, B)]), (2, [(0, 2), (2, 4), (4, 5)])):
            set_budget(tree, trees)
            lib.calls.clear()
            call()
            assert [c[0] for c in lib.calls] == [entry] * len(want)
            for (_, args), (b0, b1) in zip(lib.calls, want):
                assert args[0] == dst[b0].data_ptr()
                assert P[b0].data_ptr() in args
                assert args[10 if entry.endswith("ll_a64") else 14] == (
                    b1 - b0)
        set_budget(tree, 0)
        lib.calls.clear()
        with pytest.raises(torch.cuda.OutOfMemoryError,
                           match=f"{tree} bytes a tree"):
            call()
        assert lib.calls == []
