"""The CUDA kernels on the card (paired, chunked and per-node, and the perf
lab's four probes), against their plain torch versions; each body of the
paired, chunked and per-node kernels, and which one the wrappers take;
the VBPI slice on the card (the unrooted instance against float64, a
trainer step's kernels, the SBN's device programs against numpy, the
native representations against the pure-Python ones); the rooted
instance on the card against float64; the chunk lab's kernel variants
against their plain versions, with the shipping chunked LL body equal to
its v0; the GP engine on the card in float32 against float64; and the
NNI search's pieces (the whole-tree engine's float32 candidate scores
against float64, the batched NNI scorer on the card against the CPU,
Sankoff on the card against the CPU).

Every test here needs an NVIDIA card and is marked `cuda`; where no card
is visible each skips.  The file imports neither jax nor bito_tpu, so it
runs on a machine without them; the repository's tests/conftest.py imports
jax, so run it there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Bounds, as bench.py's on-device guard: float32 kernel against the float64
plain version within 5e-5 relative on log likelihoods and 5e-5 of the
largest gradient."""
import dataclasses

import numpy as np
import pytest
import torch

from bito_tpu_torch import _synthetic
from bito_tpu_torch.api.instances import rooted_instance, unrooted_instance
from bito_tpu_torch.convert import params_from_numpy
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.core.site_pattern import SitePattern
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.perflab import perf_lab, perf_pipe_lab, perf_static_probe
from bito_tpu_torch.treelike import chunked, paired, pernode, prep, pruning
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine
from bito_tpu_torch.vi.burrito import Burrito

pytestmark = pytest.mark.cuda

GTR = _synthetic.GTR_GAMMA4_PARAMS
MODELS = {
    "gtr_gamma4": (("GTR", "gamma+4"), GTR),
    "jc69": (("JC69", "constant"), {}),
    "gtr_gamma8": (("GTR", "gamma+8"), GTR),
    **{f"gtr_gamma{C}": (("GTR", f"gamma+{C}"), GTR) for C in (2, 5, 6, 7)},
    "hky_weibull3": (("HKY", "weibull+3"), {
        "substitution_model_rates": np.array([2.5]),
        "substitution_model_frequencies": np.array([0.2, 0.3, 0.3, 0.2]),
        "site_model_parameters": np.array([1.3]),
    }),
    "hky_weibull4": (("HKY", "weibull+4"), {
        "substitution_model_rates": np.array([2.5]),
        "substitution_model_frequencies": np.array([0.2, 0.3, 0.3, 0.2]),
        "site_model_parameters": np.array([1.3]),
    }),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _engine(model, seed, num_taxa, num_trees, rooted, device, dtype):
    text = _synthetic.random_trees_newick(seed, num_taxa, num_trees, rooted)
    coll = parse_newick_text(text)
    aln = _synthetic.random_alignment(seed + 1, coll.taxon_names, 300)
    eng = TreeLikelihoodEngine(
        SitePattern(aln, coll.taxon_names),
        PhyloModel(PhyloModelSpecification(*MODELS[model][0])),
        device=device, dtype=dtype)
    return eng, coll.trees, params_from_numpy(MODELS[model][1], device, dtype)


def _rel(a, b):
    return ((a.double() - b.double()).abs() / b.double().abs()).max().item()


def _norm(a, b):
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max()).item()


PAIRED = (paired.paired_ll_onchip, paired.paired_ll_global,
          paired.paired_grad_onchip, paired.paired_grad_global)


def _launched(before):
    """What each paired body launched since `before`, in PAIRED's order."""
    return [f.launches - n for f, n in zip(PAIRED, before)]


@pytest.mark.parametrize("model,rooted,num_trees,patterns", [
    ("gtr_gamma4", False, 5, None), ("gtr_gamma4", True, 3, 150),
    ("jc69", False, 4, 200), ("hky_weibull3", True, 2, None),
    ("gtr_gamma8", False, 3, None), ("gtr_gamma8", True, 2, 77)])
def test_kernels_match_plain(cuda, model, rooted, num_trees, patterns):
    """Both bodies of both kernels (the on-chip ones with either staging)
    against their plain versions in float64 on the same float32 operands;
    `patterns` cuts the pattern axis to a width that is not a multiple of
    a block's patterns."""
    eng, trees, params = _engine(model, 3, 11, num_trees, rooted, cuda,
                                 torch.float32)
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, num_trees)
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    onchip = eng._onchip_tape(enc)
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock,
                                       eng.branch_length_matrix(trees, enc))
    S = patterns or eng.pattern_pad
    tips = eng._kernel_tips[..., :S].contiguous()
    w = eng._kernel_weights[:S].contiguous()
    d = torch.float64
    ll_ref, g_ref = paired.paired_ll_and_gradients_ref(
        dst, tip, src, e, mask, P.to(d), dP.to(d), tips.to(d), pi.to(d),
        prop.to(d), w.to(d))
    M, N1, C = dst.shape[1], P.shape[1], P.shape[2]
    bodies = {"global": (
        lambda: paired.paired_ll_global(dst, tip, e, P, tips, pi, prop),
        lambda: paired.paired_grad_global(dst, tip, src, e, P, dP, tips, pi,
                                          prop, w))}
    for ring in (False, True):
        ll_plan = paired.onchip_plan("ll", onchip.ll_rows, M, N1, C, ring)
        grad_plan = paired.onchip_plan("grad", onchip.grad_rows, M, N1, C,
                                       ring)
        bodies[f"onchip ring={ring}"] = (
            lambda p=ll_plan: paired.paired_ll_onchip(dst, onchip, e, P, tips,
                                                      pi, prop, p),
            lambda p=grad_plan: paired.paired_grad_onchip(
                dst, onchip, src, e, P, dP, tips, pi, prop, w, p))
    for body, (ll_body, grad_body) in bodies.items():
        before = [f.launches for f in PAIRED]
        ll = ll_body() @ w
        ll2, g = paired.finish_rows(*grad_body(), mask, w)
        torch.cuda.synchronize()
        assert _launched(before) == ([0, 1, 0, 1] if body == "global"
                                     else [1, 0, 1, 0])
        assert _rel(ll, ll_ref) < 5e-5 and _rel(ll2, ll_ref) < 5e-5, body
        assert _norm(g, g_ref) < 5e-5, body
    # The wrappers take the on-chip bodies here.
    before = [f.launches for f in PAIRED]
    ll = paired.paired_log_likelihoods(dst, tip, e, P, tips, pi, prop, w,
                                       onchip=onchip)
    ll2, g = paired.paired_ll_and_gradients(dst, tip, src, e, mask, P, dP,
                                            tips, pi, prop, w, onchip=onchip)
    assert _launched(before) == [1, 0, 1, 0]
    assert _rel(ll, ll_ref) < 5e-5 and _rel(ll2, ll_ref) < 5e-5
    assert _norm(g, g_ref) < 5e-5


def test_engine_takes_the_kernels(cuda):
    """auto on the card takes the on-chip bodies of both kernels for a
    shared model in float32, and agrees with the float64 engine on the
    CPU (the scan tape)."""
    eng, trees, params = _engine("gtr_gamma4", 7, 9, 4, False, cuda,
                                 torch.float32)
    ref, _, ref_params = _engine("gtr_gamma4", 7, 9, 4, False, "cpu",
                                 torch.float64)
    before = [f.launches for f in PAIRED]
    ll = eng.log_likelihoods(trees, params)
    ll2, g = eng.ll_and_branch_gradients(trees, params)
    assert _launched(before) == [1, 0, 1, 0]
    ll_ref, g_ref = ref.ll_and_branch_gradients(trees, ref_params)
    assert _rel(ll.cpu(), ll_ref) < 5e-5 and _rel(ll2.cpu(), ll_ref) < 5e-5
    assert _norm(g.cpu(), g_ref) < 5e-5


def _large_tree_engine(device, dtype):
    """Two trees of 921 taxa past the on-chip bodies' limits, 128
    patterns: a cherry comb (460 live rows for the LL body on the paired
    and per-node tapes) and a balanced tree (409 on the chunked tape); 919
    rows for the grad bodies."""
    coll = parse_newick_text(_synthetic.cherry_comb_newick(5, 460, 1)
                             + _synthetic.balanced_newick(5, 921, 1))
    aln = _synthetic.random_alignment(6, coll.taxon_names, 128)
    eng = TreeLikelihoodEngine(
        SitePattern(aln, coll.taxon_names),
        PhyloModel(PhyloModelSpecification("GTR", "gamma+4")),
        device=device, dtype=dtype)
    return eng, coll.trees, params_from_numpy(GTR, device, dtype)


def test_tree_past_the_limit_takes_the_global_bodies(cuda):
    eng, trees, params = _large_tree_engine(cuda, torch.float32)
    assert eng.pattern_pad == 128
    before = [f.launches for f in PAIRED]
    ll = eng.log_likelihoods(trees, params)
    ll2, g = eng.ll_and_branch_gradients(trees, params)
    torch.cuda.synchronize()
    assert _launched(before) == [0, 1, 0, 1]
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, 2)
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock,
                                       eng.branch_length_matrix(trees, enc))
    ll_ref, g_ref = paired.paired_ll_and_gradients_ref(
        dst, tip, src, e, mask, *_f64(P, dP, eng._kernel_tips, pi, prop,
                                      eng._kernel_weights))
    assert _rel(ll, ll_ref) < 5e-5 and _rel(ll2, ll_ref) < 5e-5
    assert _norm(g, g_ref) < 5e-5
    onchip = eng._onchip_tape(enc)
    M, N1 = dst.shape[1], P.shape[1]
    assert paired.onchip_plan("ll", onchip.ll_rows, M, N1, 4) is None
    assert paired.onchip_plan("grad", onchip.grad_rows, M, N1, 4) is None


def test_wrappers_reject_operands_the_kernels_do_not_take(cuda):
    eng, trees, params = _engine("gtr_gamma4", 9, 8, 2, False, cuda,
                                 torch.float32)
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, 2)
    dst, tip, _src, e, _mask = eng._paired_tapes(enc)
    pi, prop = prep.kernel_model(eig, props)
    P = prep.prepare_inputs(eig, rates, clock,
                            eng.branch_length_matrix(trees, enc))
    args = dict(post_dst=dst, tip_slot=tip, post_e=e, P=P,
                tips=eng._kernel_tips, pi=pi, props=prop,
                weights=eng._kernel_weights)
    with pytest.raises(TypeError):
        paired.paired_log_likelihoods(**dict(args, P=P.double()))
    with pytest.raises(TypeError):
        paired.paired_log_likelihoods(**dict(args, post_dst=dst.long()))
    with pytest.raises(ValueError):
        paired.paired_log_likelihoods(**dict(args, tips=args["tips"].cpu()))
    with pytest.raises(ValueError):
        paired.paired_log_likelihoods(
            **dict(args, tips=args["tips"].transpose(0, 1).contiguous()
                   .transpose(0, 1)))
    # The on-chip bodies: no tape, a tape of another batch, child codes in
    # int64, matrices off the 16-byte alignment of cp.async, and a plan
    # whose patterns are not whole warps.
    with pytest.raises(ValueError, match="OnchipTape"):
        paired.paired_log_likelihoods(**args)
    onchip = eng._onchip_tape(enc)
    other = paired.onchip_tape(dst[:1].cpu().numpy(), tip[:1].cpu().numpy(),
                               cuda)
    with pytest.raises(ValueError, match="on-chip tape"):
        paired.paired_log_likelihoods(**args, onchip=other)
    with pytest.raises(TypeError):
        paired.paired_log_likelihoods(**args, onchip=paired.OnchipTape(
            onchip.child.long(), onchip.live_row, onchip.ll_rows,
            onchip.grad_rows))
    shifted = torch.empty(P.numel() + 1, device=cuda)[1:].view(P.shape)
    shifted.copy_(P)
    with pytest.raises(ValueError, match="aligned"):
        paired.paired_log_likelihoods(**dict(args, P=shifted), onchip=onchip)
    plan = paired.onchip_plan("ll", onchip.ll_rows, dst.shape[1], P.shape[1],
                              4)
    with pytest.raises(RuntimeError, match="launch failed"):
        paired.paired_ll_onchip(dst, onchip, e, P, eng._kernel_tips, pi, prop,
                                dataclasses.replace(plan, cols=plan.cols - 1))


def _case_operands(eng, trees, params, patterns):
    """(enc, P, dP, tips, pi, prop, w) in float32 on the card, from
    prep.prepare_inputs_grad (the chunked and per-node routes' dP), with
    the pattern axis cut to `patterns`."""
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad(eig, rates, clock,
                                     eng.branch_length_matrix(trees, enc))
    S = patterns or eng.pattern_pad
    tips = eng._kernel_tips[..., :S].contiguous()
    w = eng._kernel_weights[:S].contiguous()
    return enc, P, dP, tips, pi, prop, w


def _f64(*xs):
    return [x.to(torch.float64) for x in xs]


CHUNKED = (chunked.chunked_ll_onchip, chunked.chunked_ll_global,
           chunked.chunked_grad_onchip, chunked.chunked_grad_global)


def _chunked_launched(before):
    """What each body of the chunked kernels launched since `before`, in
    CHUNKED's order."""
    return [f.launches - n for f, n in zip(CHUNKED, before)]


@pytest.mark.parametrize("model,rooted,num_trees,patterns,W", [
    ("gtr_gamma4", False, 5, None, chunked.W),
    ("gtr_gamma4", True, 3, 150, chunked.W),
    ("jc69", False, 4, 200, chunked.W),
    ("hky_weibull3", True, 2, None, chunked.W),
    ("hky_weibull4", True, 3, 77, chunked.W),
    ("gtr_gamma8", False, 3, None, chunked.W),
    ("gtr_gamma8", True, 2, 77, chunked.W),
    ("gtr_gamma4", False, 3, 100, 4), ("gtr_gamma4", True, 3, None, 8)])
def test_chunked_kernels_match_plain(cuda, model, rooted, num_trees,
                                     patterns, W):
    """The wrappers of the chunked kernels and both grad bodies against
    their plain versions in float64 on the same float32 operands, on
    tapes built at the engine's width and at multiples of it; `patterns`
    cuts the pattern axis to a width that is not a multiple of a block's
    patterns.  (Both LL bodies: test_ll_bodies_match_plain.)"""
    eng, trees, params = _engine(model, 3, 11, num_trees, rooted, cuda,
                                 torch.float32)
    enc, P, dP, tips, pi, prop, w = _case_operands(eng, trees, params,
                                                   patterns)
    ce = chunked.build_chunked_encoding(enc, W)
    dst, tip, e, row = (torch.as_tensor(x, dtype=torch.int32, device=cuda)
                        for x in (ce.post_dst, ce.tip_slot, ce.post_e,
                                  ce.node_row))
    onchip = chunked.onchip_tape(ce.post_dst, ce.tip_slot, cuda)
    mask = torch.as_tensor(enc.edge_mask, dtype=torch.float32, device=cuda)
    ll_ref, g_ref = chunked.chunked_ll_and_gradients_ref(
        dst, tip, e, row, mask, *_f64(P, dP, tips, pi, prop, w))
    C = P.shape[2]
    plan = chunked.onchip_plan(onchip.grad_rows, ce.MW, P.shape[1], C)
    assert plan is not None and plan.lanes == paired.lanes(C)
    before = [f.launches for f in CHUNKED]
    ll = chunked.chunked_log_likelihoods(dst, tip, e, P, tips, pi, prop, w,
                                         onchip=onchip)
    ll2, g = chunked.chunked_ll_and_gradients(dst, tip, e, row, mask, P, dP,
                                              tips, pi, prop, w,
                                              onchip=onchip)
    torch.cuda.synchronize()
    assert _chunked_launched(before) == [1, 0, 1, 0]  # the on-chip bodies
    assert _rel(ll, ll_ref) < 5e-5 and _rel(ll2, ll_ref) < 5e-5
    assert _norm(g, g_ref) < 5e-5
    for body, launched in (
            (lambda: chunked.chunked_grad_onchip(dst, onchip, e, P, dP, tips,
                                                 pi, prop, w, plan),
             [0, 0, 1, 0]),
            (lambda: chunked.chunked_grad_global(dst, tip, e, P, dP, tips,
                                                 pi, prop, w), [0, 0, 0, 1])):
        before = [f.launches for f in CHUNKED]
        ll2, g = chunked.finish_rows(*body(), row, mask, w)
        torch.cuda.synchronize()
        assert _chunked_launched(before) == launched
        assert _rel(ll2, ll_ref) < 5e-5 and _norm(g, g_ref) < 5e-5


@pytest.mark.parametrize("model,rooted,num_trees,patterns", [
    ("gtr_gamma4", False, 5, None), ("gtr_gamma4", True, 3, 150),
    ("jc69", False, 4, 200), ("hky_weibull3", True, 2, None)])
def test_pernode_kernels_match_plain(cuda, model, rooted, num_trees,
                                     patterns):
    """Both per-node wrappers against their plain versions in float64 on
    the same float32 operands, on trifurcating and binary roots; without
    their tapes they derive them and take the on-chip bodies."""
    eng, trees, params = _engine(model, 3, 11, num_trees, rooted, cuda,
                                 torch.float32)
    enc, P, dP, tips, pi, prop, w = _case_operands(eng, trees, params,
                                                   patterns)
    post, pre, root = (torch.as_tensor(x, dtype=torch.int32, device=cuda)
                       for x in (enc.post_ops, enc.pre_ops, enc.root))
    mask = torch.as_tensor(enc.edge_mask, dtype=torch.float32, device=cuda)
    before = [f.launches for f in PERNODE]
    ll = pernode.pernode_log_likelihoods(post, root, P, tips, pi, prop, w)
    ll2, g = pernode.pernode_ll_and_gradients(post, pre, root, mask, P, dP,
                                              tips, pi, prop, w)
    torch.cuda.synchronize()
    assert _pernode_launched(before) == [1, 0, 1, 0]
    ll_ref, g_ref = pernode.pernode_ll_and_gradients_ref(
        post, pre, root, mask, *_f64(P, dP, tips, pi, prop, w))
    assert _rel(ll, ll_ref) < 5e-5 and _rel(ll2, ll_ref) < 5e-5
    assert _norm(g, g_ref) < 5e-5


PERNODE = (pernode.pernode_ll_onchip, pernode.pernode_ll_global,
           pernode.pernode_grad_onchip, pernode.pernode_grad_global)


def _pernode_launched(before):
    """What each body of the per-node kernels launched since `before`, in
    PERNODE's order."""
    return [f.launches - n for f, n in zip(PERNODE, before)]


def _pernode_tapes(enc, device):
    return (torch.as_tensor(x, dtype=torch.int32, device=device)
            for x in (enc.post_ops, enc.pre_ops, enc.root))


@pytest.mark.parametrize("C,rooted,num_trees,patterns", [
    (1, False, 4, 200), (2, True, 3, None), (3, False, 2, 77),
    (4, True, 3, 150), (5, False, 2, None), (6, True, 2, 77),
    (7, False, 2, None), (8, True, 3, 100), (8, False, 2, None)])
def test_pernode_grad_bodies_match_plain(cuda, C, rooted, num_trees,
                                         patterns):
    """Both bodies of the per-node grad kernel against the float64 plain
    version on the same float32
    operands, at every category count the kernels take (JC69 at C=1, HKY
    with Weibull categories at C=3, GTR with Gamma categories otherwise),
    on trifurcating and binary roots; `patterns` cuts the pattern axis to a
    width that is not a multiple of a block's patterns.  The wrapper takes
    the on-chip body, with or without the tape given."""
    model = {1: "jc69", 3: "hky_weibull3"}.get(C, f"gtr_gamma{C}")
    eng, trees, params = _engine(model, 3, 11, num_trees, rooted, cuda,
                                 torch.float32)
    enc, P, dP, tips, pi, prop, w = _case_operands(eng, trees, params,
                                                   patterns)
    assert P.shape[2] == C
    post, pre, root = _pernode_tapes(enc, cuda)
    mask = torch.as_tensor(enc.edge_mask, dtype=torch.float32, device=cuda)
    ll_ref, g_ref = pernode.pernode_ll_and_gradients_ref(
        post, pre, root, mask, *_f64(P, dP, tips, pi, prop, w))
    onchip = pernode.onchip_tape(enc.post_ops, enc.pre_ops, enc.root,
                                 enc.num_taxa, enc.num_slots, cuda)
    N1 = P.shape[1]
    bodies = {"global": (lambda: pernode.pernode_grad_global(
        post, pre, root, P, dP, tips, pi, prop, w), [0, 0, 0, 1])}
    plan = pernode.onchip_plan(onchip.rows, onchip.ints, N1, C)
    assert plan.lanes == paired.lanes(C)
    bodies["onchip"] = (lambda: pernode.pernode_grad_onchip(
        onchip, root, P, dP, tips, pi, prop, w, plan), [0, 0, 1, 0])
    for body, (call, launched) in bodies.items():
        before = [f.launches for f in PERNODE]
        ll, g = pernode.finish_rows(*call(), mask, w)
        torch.cuda.synchronize()
        assert _pernode_launched(before) == launched, body
        assert _rel(ll, ll_ref) < 5e-5 and _norm(g, g_ref) < 5e-5, body
    for tape in (onchip, None):
        before = [f.launches for f in PERNODE]
        ll, g = pernode.pernode_ll_and_gradients(post, pre, root, mask, P,
                                                 dP, tips, pi, prop, w,
                                                 onchip=tape)
        assert _pernode_launched(before) == [0, 0, 1, 0]
        assert _rel(ll, ll_ref) < 5e-5 and _norm(g, g_ref) < 5e-5


def test_flagship_takes_the_onchip_pernode_body(cuda):
    """The flagship's shape (27 taxa, 1,024 patterns, GTR+Gamma4) takes
    the on-chip body; the 921-taxon trees fit no warp of it and take the
    global body.  Both agree with the float64 plain version."""
    for make, plan_is_none, launched in (
            (lambda: _flagship_engine(6, cuda, torch.float32), False,
             [0, 0, 1, 0]),
            (lambda: _large_tree_engine(cuda, torch.float32), True,
             [0, 0, 0, 1])):
        eng, trees, params = make()
        enc, P, dP, tips, pi, prop, w = _case_operands(eng, trees, params,
                                                       None)
        post, pre, root = _pernode_tapes(enc, cuda)
        mask = torch.as_tensor(enc.edge_mask, dtype=torch.float32,
                               device=cuda)
        onchip = pernode.onchip_tape(enc.post_ops, enc.pre_ops, enc.root,
                                     enc.num_taxa, enc.num_slots, cuda)
        plan = pernode.onchip_plan(onchip.rows, onchip.ints, P.shape[1], 4,
                                   least=1)
        assert (plan is None) == plan_is_none
        before = [f.launches for f in PERNODE]
        ll, g = pernode.pernode_ll_and_gradients(post, pre, root, mask, P,
                                                 dP, tips, pi, prop, w,
                                                 onchip=onchip)
        torch.cuda.synchronize()
        assert _pernode_launched(before) == launched
        ll_ref, g_ref = pernode.pernode_ll_and_gradients_ref(
            post, pre, root, mask, *_f64(P, dP, tips, pi, prop, w))
        assert _rel(ll, ll_ref) < 5e-5 and _norm(g, g_ref) < 5e-5


def test_pernode_grad_raises_without_falling_back(cuda):
    """A launch the on-chip body refuses raises, and operands the kernels
    do not take raise before any launch: the card never runs the plain
    version quietly."""
    eng, trees, params = _engine("gtr_gamma4", 9, 8, 2, False, cuda,
                                 torch.float32)
    enc, P, dP, tips, pi, prop, w = _case_operands(eng, trees, params, None)
    post, pre, root = _pernode_tapes(enc, cuda)
    mask = torch.as_tensor(enc.edge_mask, dtype=torch.float32, device=cuda)
    onchip = pernode.onchip_tape(enc.post_ops, enc.pre_ops, enc.root,
                                 enc.num_taxa, enc.num_slots, cuda)
    plan = pernode.onchip_plan(onchip.rows, onchip.ints, P.shape[1], 4)
    before = [f.launches for f in PERNODE]
    with pytest.raises(RuntimeError, match="launch failed"):
        pernode.pernode_grad_onchip(onchip, root, P, dP, tips, pi, prop, w,
                                    dataclasses.replace(plan,
                                                        cols=plan.cols - 1))
    args = (post, pre, root, mask, P, dP, tips, pi, prop, w)
    with pytest.raises(TypeError):
        pernode.pernode_ll_and_gradients(*args[:4], P.double(), dP.double(),
                                         *args[6:])
    with pytest.raises(ValueError, match="on-chip tape"):
        pernode.pernode_ll_and_gradients(*args, onchip=pernode.onchip_tape(
            enc.post_ops[:1], enc.pre_ops[:1], enc.root[:1], enc.num_taxa,
            enc.num_slots, cuda))
    shifted = torch.empty(P.numel() + 1, device=cuda)[1:].view(P.shape)
    shifted.copy_(P)
    with pytest.raises(ValueError, match="aligned"):
        pernode.pernode_ll_and_gradients(*args[:4], shifted, *args[5:],
                                         onchip=onchip)
    assert _pernode_launched(before) == [0, 0, 0, 0]


def _flagship_engine(num_trees, device, dtype):
    """chip_smoke.py's flagship shape (DS1: 27 taxa, 934 patterns padded
    to 1,024), GTR+Gamma4, on fewer trees."""
    text, aln = _synthetic.ds1_shaped(0, num_trees)
    coll = parse_newick_text(text)
    eng = TreeLikelihoodEngine(
        SitePattern(aln, coll.taxon_names),
        PhyloModel(PhyloModelSpecification("GTR", "gamma+4")),
        device=device, dtype=dtype)
    return eng, coll.trees, params_from_numpy(GTR, device, dtype)


def test_engine_chunked_takes_the_chunked_kernels(cuda):
    """kernel="chunked" on the card launches the on-chip bodies of both
    chunked kernels, and no paired body, on the flagship's shape and on a
    small one, and agrees with the float64 engine on the CPU."""
    for make in (lambda d, t: _engine("gtr_gamma4", 7, 9, 4, False, d, t),
                 lambda d, t: _flagship_engine(6, d, t)):
        eng, trees, params = make(cuda, torch.float32)
        eng.kernel = "chunked"
        ref, _, ref_params = make("cpu", torch.float64)
        before = [f.launches for f in CHUNKED + PAIRED]
        ll = eng.log_likelihoods(trees, params)
        ll2, g = eng.ll_and_branch_gradients(trees, params)
        assert [f.launches - n for f, n in zip(CHUNKED + PAIRED, before)] == [
            1, 0, 1, 0, 0, 0, 0, 0]
        ll_ref, g_ref = ref.ll_and_branch_gradients(trees, ref_params)
        assert _rel(ll.cpu(), ll_ref) < 5e-5
        assert _rel(ll2.cpu(), ll_ref) < 5e-5
        assert _norm(g.cpu(), g_ref) < 5e-5


def test_tree_past_the_limit_takes_the_global_chunked_body(cuda):
    """The chunked route on the 921-taxon trees: no warp of either on-chip
    body fits, and the wrappers launch the global bodies, which agree with
    the float64 plain version."""
    eng, trees, params = _large_tree_engine(cuda, torch.float32)
    eng.kernel = "chunked"
    enc = eng.encode(trees)
    dst, tip, e, row, mask = eng._chunked_tapes(enc)
    onchip = eng._chunked_onchip_tape(enc)
    N1 = enc.num_slots + 1
    assert chunked.onchip_plan(onchip.grad_rows, dst.shape[1], N1, 4,
                               least=1) is None
    assert paired.onchip_plan("ll", onchip.ll_rows, dst.shape[1], N1, 4,
                              True) is None
    before = [f.launches for f in CHUNKED]
    ll0 = eng.log_likelihoods(trees, params)
    ll, g = eng.ll_and_branch_gradients(trees, params)
    torch.cuda.synchronize()
    assert _chunked_launched(before) == [0, 1, 0, 1]
    eig, rates, props, clock = eng._model_ingredients(params, 2)
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad(eig, rates, clock,
                                     eng.branch_length_matrix(trees, enc))
    ll_ref, g_ref = chunked.chunked_ll_and_gradients_ref(
        dst, tip, e, row, mask, *_f64(P, dP, eng._kernel_tips, pi, prop,
                                      eng._kernel_weights))
    assert _rel(ll, ll_ref) < 5e-5 and _norm(g, g_ref) < 5e-5
    assert _rel(ll0, ll_ref) < 5e-5


LL_BODIES = {"chunked": (chunked.chunked_ll_onchip, chunked.chunked_ll_global),
             "pernode": (pernode.pernode_ll_onchip, pernode.pernode_ll_global)}


def _ll_launched(before):
    """What the on-chip and global LL bodies of the chunked and per-node
    kernels launched since `before`, in that order."""
    return [f.launches - n for f, n in zip(
        LL_BODIES["chunked"] + LL_BODIES["pernode"], before)]


def _ll_launches():
    return [f.launches for f in LL_BODIES["chunked"] + LL_BODIES["pernode"]]


def _ll_tapes(enc, device):
    """The chunked tapes at chunked.W with their on-chip tape, and the
    per-node tapes with their LL tape, on `device`."""
    ce = chunked.build_chunked_encoding(enc, chunked.W)
    dst, tip, e = (torch.as_tensor(x, dtype=torch.int32, device=device)
                   for x in (ce.post_dst, ce.tip_slot, ce.post_e))
    post, _pre, root = _pernode_tapes(enc, device)
    return ((dst, tip, e, chunked.onchip_tape(ce.post_dst, ce.tip_slot,
                                              device)),
            (post, root, pernode.ll_tape(enc.post_ops, enc.root,
                                         enc.num_taxa, enc.num_slots,
                                         device)))


@pytest.mark.parametrize("C,rooted,num_trees,patterns", [
    (1, False, 4, 200), (2, True, 3, None), (3, False, 2, 77),
    (4, True, 3, 150), (4, False, 5, None), (5, False, 2, None),
    (6, True, 2, 77), (7, False, 2, None), (8, True, 3, 100),
    (8, False, 2, None)])
def test_ll_bodies_match_plain(cuda, C, rooted, num_trees, patterns):
    """Both bodies of the chunked and per-node LL kernels (the on-chip one,
    csrc/paired_ll_onchip.cu on each tape, in either staging; the global
    one) against the float64 plain versions on the same float32 operands,
    at every category count the kernels take, on trifurcating and binary
    roots; `patterns` cuts the pattern axis to a width that is not a
    multiple of a block's patterns.  The wrappers take the on-chip body
    here, with or without the tape given."""
    model = {1: "jc69", 3: "hky_weibull3"}.get(C, f"gtr_gamma{C}")
    eng, trees, params = _engine(model, 3, 11, num_trees, rooted, cuda,
                                 torch.float32)
    enc, P, _dP, tips, pi, prop, w = _case_operands(eng, trees, params,
                                                    patterns)
    assert P.shape[2] == C
    N1 = P.shape[1]
    (dst, tip, e, con), (post, root, pon) = _ll_tapes(enc, cuda)
    f64 = _f64(P, tips, pi, prop, w)
    refs = {"chunked": chunked.chunked_log_likelihoods_ref(dst, tip, e, *f64),
            "pernode": pernode.pernode_log_likelihoods_ref(post, root, *f64)}
    bodies = {}
    for ring in (False, True):
        cplan = paired.onchip_plan("ll", con.ll_rows, dst.shape[1], N1, C,
                                   ring)
        pplan = paired.onchip_plan("ll", pon.ll_rows, post.shape[1], N1, C,
                                   ring)
        assert cplan.lanes == pplan.lanes == paired.lanes(C)
        bodies[f"chunked onchip ring={ring}"] = (
            lambda p=cplan: chunked.chunked_ll_onchip(dst, con, e, P, tips,
                                                      pi, prop, p),
            [1, 0, 0, 0])
        bodies[f"pernode onchip ring={ring}"] = (
            lambda p=pplan: pernode.pernode_ll_onchip(pon, P, tips, pi, prop,
                                                      p), [0, 0, 1, 0])
    bodies["chunked global"] = (lambda: chunked.chunked_ll_global(
        dst, tip, e, P, tips, pi, prop), [0, 1, 0, 0])
    bodies["pernode global"] = (lambda: pernode.pernode_ll_global(
        post, root, P, tips, pi, prop), [0, 0, 0, 1])
    for body, (call, launched) in bodies.items():
        before = _ll_launches()
        ll = call() @ w
        torch.cuda.synchronize()
        assert _ll_launched(before) == launched, body
        assert _rel(ll, refs[body.split()[0]]) < 5e-5, body
    for ctape, ptape in ((con, pon), (None, None)):
        before = _ll_launches()
        llc = chunked.chunked_log_likelihoods(dst, tip, e, P, tips, pi, prop,
                                              w, onchip=ctape)
        llp = pernode.pernode_log_likelihoods(post, root, P, tips, pi, prop,
                                              w, onchip=ptape)
        torch.cuda.synchronize()
        assert _ll_launched(before) == [1, 0, 1, 0]
        assert _rel(llc, refs["chunked"]) < 5e-5
        assert _rel(llp, refs["pernode"]) < 5e-5


def test_ll_wrappers_take_their_bodies_by_the_plan(cuda):
    """The flagship's shape takes the on-chip LL body on both tapes (the
    chunked one through the engine); the 921-taxon batch fits no warp of
    it on either tape and takes the global bodies.  Both agree with the
    float64 plain versions."""
    for make, launched in (
            (lambda: _flagship_engine(6, cuda, torch.float32), [1, 0, 1, 0]),
            (lambda: _large_tree_engine(cuda, torch.float32), [0, 1, 0, 1])):
        eng, trees, params = make()
        eng.kernel = "chunked"
        enc, P, _dP, tips, pi, prop, w = _case_operands(eng, trees, params,
                                                        None)
        dst, tip, e, _row, _mask = eng._chunked_tapes(enc)
        post, _pre, root = _pernode_tapes(enc, cuda)
        pon = pernode.ll_tape(enc.post_ops, enc.root, enc.num_taxa,
                              enc.num_slots, cuda)
        before = _ll_launches()
        llc = eng.log_likelihoods(trees, params)
        llp = pernode.pernode_log_likelihoods(post, root, P, tips, pi, prop,
                                              w, onchip=pon)
        torch.cuda.synchronize()
        assert _ll_launched(before) == launched
        f64 = _f64(P, tips, pi, prop, w)
        assert _rel(llc, chunked.chunked_log_likelihoods_ref(
            dst, tip, e, *f64)) < 5e-5
        assert _rel(llp, pernode.pernode_log_likelihoods_ref(
            post, root, *f64)) < 5e-5


def test_ll_bodies_raise_without_falling_back(cuda):
    """A launch the on-chip body refuses raises, and tapes or operands the
    bodies do not take raise before any launch: the card never runs the
    plain version quietly."""
    eng, trees, params = _engine("gtr_gamma4", 9, 8, 2, False, cuda,
                                 torch.float32)
    enc, P, _dP, tips, pi, prop, w = _case_operands(eng, trees, params, None)
    (dst, tip, e, con), (post, root, pon) = _ll_tapes(enc, cuda)
    N1 = P.shape[1]
    cplan = paired.onchip_plan("ll", con.ll_rows, dst.shape[1], N1, 4)
    pplan = paired.onchip_plan("ll", pon.ll_rows, post.shape[1], N1, 4)
    before = _ll_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        chunked.chunked_ll_onchip(dst, con, e, P, tips, pi, prop,
                                  dataclasses.replace(cplan,
                                                      cols=cplan.cols - 1))
    with pytest.raises(RuntimeError, match="launch failed"):
        pernode.pernode_ll_onchip(pon, P, tips, pi, prop, dataclasses.replace(
            pplan, cols=pplan.cols - 1))
    shifted = torch.empty(P.numel() + 1, device=cuda)[1:].view(P.shape)
    shifted.copy_(P)
    with pytest.raises(ValueError, match="aligned"):
        chunked.chunked_log_likelihoods(dst, tip, e, shifted, tips, pi, prop,
                                        w, onchip=con)
    with pytest.raises(ValueError, match="aligned"):
        pernode.pernode_log_likelihoods(post, root, shifted, tips, pi, prop,
                                        w, onchip=pon)
    with pytest.raises(TypeError):
        pernode.pernode_log_likelihoods(
            post, root, P, tips, pi, prop, w,
            onchip=dataclasses.replace(pon, child=pon.child.long()))
    with pytest.raises(ValueError, match="on-chip tape"):
        pernode.pernode_log_likelihoods(
            post, root, P, tips, pi, prop, w, onchip=pernode.ll_tape(
                enc.post_ops[:1], enc.root[:1], enc.num_taxa, enc.num_slots,
                cuda))
    assert _ll_launched(before) == [0, 0, 0, 0]


def test_new_wrappers_reject_operands_the_kernels_do_not_take(cuda):
    eng, trees, params = _engine("gtr_gamma4", 9, 8, 2, False, cuda,
                                 torch.float32)
    enc, P, dP, tips, pi, prop, w = _case_operands(eng, trees, params, None)
    dst, tip, e, _row, _mask = eng._chunked_tapes(enc)
    args = dict(post_dst=dst, tip_slot=tip, post_e=e, P=P, tips=tips, pi=pi,
                props=prop, weights=w)
    with pytest.raises(TypeError):
        chunked.chunked_log_likelihoods(**dict(args, P=P.double()))
    with pytest.raises(ValueError):
        chunked.chunked_log_likelihoods(**dict(args, post_dst=dst[:, :-1],
                                               post_e=e[:, :-1]))
    with pytest.raises(ValueError):
        chunked.chunked_log_likelihoods(**dict(args, tips=tips.cpu()))
    # The grad wrapper needs the on-chip tape, of this batch; so does the
    # LL wrapper, where it is given.
    with pytest.raises(ValueError, match="on-chip tape"):
        chunked.chunked_log_likelihoods(**args, onchip=chunked.onchip_tape(
            dst[:1].cpu().numpy(), tip[:1].cpu().numpy(), cuda))
    dst, tip, e, row, mask = eng._chunked_tapes(enc)
    grad_args = (dst, tip, e, row, mask, P, dP, tips, pi, prop, w)
    with pytest.raises(ValueError, match="OnchipTape"):
        chunked.chunked_ll_and_gradients(*grad_args)
    other = chunked.onchip_tape(dst[:1].cpu().numpy(), tip[:1].cpu().numpy(),
                                cuda)
    with pytest.raises(ValueError, match="on-chip tape"):
        chunked.chunked_ll_and_gradients(*grad_args, onchip=other)
    post, root = (torch.as_tensor(x, dtype=torch.int32, device=cuda)
                  for x in (enc.post_ops, enc.root))
    with pytest.raises(TypeError):
        pernode.pernode_log_likelihoods(post.long(), root, P, tips, pi, prop,
                                        w)
    with pytest.raises(ValueError):
        pernode.pernode_log_likelihoods(post, root[:1], P, tips, pi, prop, w)


# -- the perf lab's probe kernels (bito_tpu_torch/perflab) -------------------

@pytest.mark.parametrize("name", list(perf_lab.VARIANTS))
def test_variant_kernel_matches_plain(cuda, name):
    """The variant kernel on the flagship's tapes (27 taxa, M=26, Mp=51)
    against its plain version in float64 on the same float32 operands.
    nodot has -inf log likelihoods: equal non-finite places, finite values
    within the bounds."""
    knobs = perf_lab.VARIANTS[name]
    ops = perf_lab.flagship_operands(cuda, batch=4)
    before = perf_lab.variant_ll_and_gradients.launches
    ll, g = perf_lab.variant_ll_and_gradients(**ops, **knobs)
    torch.cuda.synchronize()
    assert perf_lab.variant_ll_and_gradients.launches == before + 1
    ll_ref, g_ref = perf_lab.variant_ll_and_gradients_ref(
        **{k: v.double() if v.is_floating_point() else v
           for k, v in ops.items()}, **knobs)
    if knobs["nodot"]:
        assert torch.equal(torch.isfinite(ll), torch.isfinite(ll_ref))
        assert torch.equal(ll[~torch.isfinite(ll)].double(),
                           ll_ref[~torch.isfinite(ll_ref)])
        assert torch.isfinite(g).all() and torch.isfinite(g_ref).all()
        assert (g.double() - g_ref).abs().max() <= 5e-5 * max(
            g_ref.abs().max().item(), 1.0)
    else:
        assert _rel(ll, ll_ref) < 5e-5 and _norm(g, g_ref) < 5e-5


def test_variant_kernel_refuses_what_it_does_not_take(cuda):
    eng, trees, params = _engine("gtr_gamma4", 9, 11, 2, False, cuda,
                                 torch.float32)
    enc, P, dP, tips, pi, prop, w = _case_operands(eng, trees, params, None)
    post, pre, root = (torch.as_tensor(x, dtype=torch.int32, device=cuda)
                       for x in (enc.post_ops, enc.pre_ops, enc.root))
    mask = torch.as_tensor(enc.edge_mask, dtype=torch.float32, device=cuda)
    args = (post, pre, root, mask, P, dP, tips, pi, prop, w)
    with pytest.raises(ValueError, match="unroll"):
        perf_lab.variant_ll_and_gradients(*args, **perf_lab.VARIANTS["unroll"])
    with pytest.raises(ValueError, match="nodot"):
        perf_lab.variant_ll_and_gradients(*args, unroll=False, resk=1,
                                          nodot=True)
    ll, g = perf_lab.variant_ll_and_gradients(
        *args, **perf_lab.VARIANTS["loop_resk4"])  # the loop takes any tape
    ll_ref, g_ref = pernode.pernode_ll_and_gradients_ref(
        post, pre, root, mask, *_f64(P, dP, tips, pi, prop, w))
    assert _rel(ll, ll_ref) < 5e-5 and _norm(g, g_ref) < 5e-5
    with pytest.raises(ValueError, match="categories"):
        perf_lab.variant_ll_and_gradients(
            post, pre, root, mask, P[:, :, :1].contiguous(),
            dP[:, :, :1].contiguous(), tips, pi, prop[:1].contiguous(), w,
            **perf_lab.VARIANTS["loop_resk4"])


def _int_block(shape, seed, device):
    """bf16 small integers in [0, 8): exact in bf16 and in float32 sums."""
    block = np.random.default_rng(seed).integers(0, 8, shape)
    return torch.as_tensor(block, dtype=torch.bfloat16, device=device)


@pytest.mark.parametrize("name", list(perf_pipe_lab.EXPS))
def test_pipe_cell_matches_plain(cuda, name):
    """Every experiment at 3 cells, through the wrapper and at every tile
    that fits: those that fill their scratch exactly, on the script's
    inputs and on a block of small integers; the others (no defined
    output) by shape and launch count."""
    block_rows, scratch_rows, init, loops, stores = perf_pipe_lab.EXPS[name]
    idx, big = perf_pipe_lab.pipe_inputs(block_rows, scratch_rows, 3, cuda)
    kw = dict(scratch_rows=scratch_rows, init=init, loops=loops,
              stores=stores)
    tiles = [t for t in perf_pipe_lab.TILES if perf_pipe_lab.pipe_smem(
        block_rows, scratch_rows, t) <= perf_pipe_lab.MAX_SMEM]
    before = perf_pipe_lab.pipe_cell.launches
    for block in (big, _int_block(big.shape, 5, cuda)):
        want = perf_pipe_lab.pipe_cell_ref(idx, block, **kw)
        outs = [perf_pipe_lab.pipe_cell(idx, block, **kw)]
        for tile in tiles:
            outs.append(torch.empty_like(outs[0]))
            perf_pipe_lab.launch_pipe_cell(
                idx, block, outs[-1],
                perf_pipe_lab.pipe_plan(block_rows, scratch_rows, tile), **kw)
        torch.cuda.synchronize()
        for out in outs:
            assert out.shape == (3, 8, perf_pipe_lab.S)
            if init:
                assert torch.equal(out, want)
    assert perf_pipe_lab.pipe_cell.launches == before + 2 * (1 + len(tiles))


def test_pipe_cell_refuses_what_it_does_not_take(cuda):
    idx, big = perf_pipe_lab.pipe_inputs(8, 2080, 2, cuda)
    with pytest.raises(ValueError, match="idx"):
        perf_pipe_lab.pipe_cell(idx, big, scratch_rows=1024, init=True,
                                loops=28, stores=4)
    with pytest.raises(ValueError, match="stores"):
        perf_pipe_lab.pipe_cell(idx, big, scratch_rows=2080, init=True,
                                loops=28, stores=5)
    # 8,192 scratch rows need 262 KB of shared memory at 8 columns
    idx, big = perf_pipe_lab.pipe_inputs(8, 8192, 2, cuda)
    before = perf_pipe_lab.pipe_cell.launches
    with pytest.raises(ValueError, match="shared memory"):
        perf_pipe_lab.pipe_cell(idx, big, scratch_rows=8192, init=True,
                                loops=0, stores=0)
    assert perf_pipe_lab.pipe_cell.launches == before


def test_probe_wrappers_allocate_only_their_output(cuda, monkeypatch):
    """Neither wrapper allocates a device scratch, and a CUDA tensor never
    reaches the plain version: the peak allocation during a call is its
    output, and the plain versions raise if called."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(perf_pipe_lab, "pipe_cell_ref", refuse)
    monkeypatch.setattr(perf_static_probe, "static_chain_ref", refuse)
    idx, big = perf_pipe_lab.pipe_inputs(256, 1024, 100, cuda)
    tape, L = perf_static_probe.probe_inputs(cuda)
    calls = [(lambda: perf_pipe_lab.pipe_cell(
        idx, big, scratch_rows=1024, init=True, loops=52, stores=2),
        perf_pipe_lab.pipe_cell),
        (lambda: perf_static_probe.static_chain(tape, L, dynamic=True, R=2),
         perf_static_probe.static_chain)]
    for call, wrapper in calls:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = wrapper.launches
        out = call()
        torch.cuda.synchronize()
        out_bytes = out.numel() * out.element_size()
        # the caching allocator rounds a block up to 512 bytes
        assert torch.cuda.max_memory_allocated() - base <= out_bytes + 512
        assert wrapper.launches == before + 1


@pytest.mark.parametrize("nslices,rows,cols", [
    perf_pipe_lab.DMA4D[1:], (4, 24, 100), (3, 8, 7)])
def test_stream_sums_match_plain(cuda, nslices, rows, cols):
    """At 3 cells of the script's 32 x 256 x 128 block and of ragged ones
    (columns not a multiple of a block's 32 chunks, fewer slices than its
    8 lanes, rows / 8 not a multiple of 8): on small integers both walks
    equal the plain version exactly; on a random bf16 block each is within
    n u sum|x| of the float64 sums (n the groups a sum adds, u = 2^-24:
    the worst case of n float32 additions in any order)."""
    shape = (3, nslices, rows, cols)
    groups = nslices * rows // 8
    blocks = (_int_block(shape, 9, cuda), torch.as_tensor(
        np.random.default_rng(10).normal(size=shape), dtype=torch.bfloat16,
        device=cuda))
    for exact, big4 in zip((True, False), blocks):
        big3 = big4.reshape(3, nslices * rows, cols)
        before = (perf_pipe_lab.stream_sum_4d.launches,
                  perf_pipe_lab.stream_sum_3d.launches)
        out4 = perf_pipe_lab.stream_sum_4d(big4)
        out3 = perf_pipe_lab.stream_sum_3d(big3)
        torch.cuda.synchronize()
        assert (perf_pipe_lab.stream_sum_4d.launches,
                perf_pipe_lab.stream_sum_3d.launches) == (before[0] + 1,
                                                          before[1] + 1)
        assert out4.shape == out3.shape == (3, 8, cols)
        if exact:
            assert torch.equal(out4, perf_pipe_lab.stream_sum_ref(big4))
            assert torch.equal(out3, out4)
            continue
        flat = big4.double().reshape(3, -1, 8, cols)
        want, tol = flat.sum(dim=1), groups * 2.0**-24 * flat.abs().sum(dim=1)
        for out in (out4, out3):
            assert ((out.double() - want).abs() <= tol).all()


def test_stream_sums_refuse_what_they_do_not_take(cuda):
    big = torch.ones((2, 4, 12, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        perf_pipe_lab.stream_sum_4d(big)
    shifted = torch.ones(2 * 4 * 16 * 16 + 1, dtype=torch.bfloat16,
                         device=cuda)[1:].view(2, 4, 16, 16)
    with pytest.raises(ValueError, match="aligned"):
        perf_pipe_lab.stream_sum_4d(shifted)


@pytest.mark.parametrize("warps", [1, 2, 4])
@pytest.mark.parametrize("dynamic", [True, False], ids=["dynamic", "static"])
@pytest.mark.parametrize("R", [1, 2, 20])
def test_static_chain_matches_plain(cuda, dynamic, R, warps):
    """At every layout, within 1e-5 of max |out| of the float32 plain
    version (another sum order), and on a tape whose ops write over their
    own source rows, where the kernel takes a barrier before each store:
    op m reads the rows of 52 + m and 53 + m and writes those of 53 + m,
    which the next op reads, and the last writes the output's rows
    (2 M = 104)."""
    tape, L = perf_static_probe.probe_inputs(cuda)
    overlapping = tape.clone()
    overlapping[0] = torch.arange(52, 104, dtype=torch.int32)
    overlapping[1] = overlapping[0] + 1
    for tp, dyn in ((tape, dynamic), (overlapping, True)):
        out = perf_static_probe.static_chain(tp, L, dynamic=dyn, R=R,
                                             warps=warps)
        torch.cuda.synchronize()
        want = perf_static_probe.static_chain_ref(tp, L, dynamic=dyn, R=R)
        assert torch.isfinite(out).all()
        assert (out - want).abs().max() <= 1e-5 * want.abs().max()


def test_static_chain_refuses_another_layout(cuda):
    tape, L = perf_static_probe.probe_inputs(cuda)
    before = perf_static_probe.static_chain.launches
    with pytest.raises(ValueError, match="warps"):
        perf_static_probe.static_chain(tape, L, dynamic=True, R=1, warps=3)
    assert perf_static_probe.static_chain.launches == before


def test_graph_ms_counts_the_launches_the_card_runs(cuda):
    """A launch captured in a CUDA graph counts where a replay runs it:
    one launch before the capture, none at the capture, then reps for
    each of the 1 + replays replays."""
    tape, L = perf_static_probe.probe_inputs(cuda)
    before = perf_static_probe.static_chain.launches
    ms = perf_static_probe.timed(tape, L, True, 1, reps=4)
    assert ms > 0
    assert perf_static_probe.static_chain.launches == before + 1 + 4 * 4
    before = perf_pipe_lab.pipe_cell.launches
    perf_pipe_lab.run("tiny", 8, 128, False, 0, 0, reps=3, cells=2)
    assert perf_pipe_lab.pipe_cell.launches == before + 2 + 3 * 4


def test_pipe_cell_at_the_plans_edge(cuda):
    """The largest scratch pipe_plan takes (8 block rows, 8 columns, the
    227 KB of a block less the kernel's static bytes) launches and holds
    exactly: the host's limit is the launch's."""
    rows = perf_pipe_lab.EDGE_SCRATCH_ROWS
    idx, big = perf_pipe_lab.pipe_inputs(8, rows, 2, cuda)
    kw = dict(scratch_rows=rows, init=True, loops=0, stores=0)
    assert perf_pipe_lab.pipe_plan(8, rows).smem == perf_pipe_lab.MAX_SMEM
    out = perf_pipe_lab.pipe_cell(idx, big, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, perf_pipe_lab.pipe_cell_ref(idx, big, **kw))


def test_stream_sums_and_torch_sum_timed_from_the_device(cuda):
    """run4d times both walks and torch.sum from CUDA graphs: the launches
    count where the card runs them (the checked call, one before the
    capture, then reps for each of the 1 + replays replays), and both
    times are positive."""
    before = (perf_pipe_lab.stream_sum_4d.launches,
              perf_pipe_lab.stream_sum_3d.launches)
    result = perf_pipe_lab.run4d("dma", 2, 16, 128, reps=3, cells=4)
    assert (perf_pipe_lab.stream_sum_4d.launches,
            perf_pipe_lab.stream_sum_3d.launches) == (before[0] + 2 + 3 * 4,
                                                      before[1] + 2 + 3 * 4)
    for tag in ("4d", "3d"):
        us, out, lib_us = result[tag]
        assert us > 0 and lib_us > 0
        assert torch.equal(out, torch.full((4, 8, 128), 4.0, device=cuda))


# ---------------------------------------------------------------------------
# The VBPI slice: the unrooted instance, the device SBN programs and the
# trainer on the card
# ---------------------------------------------------------------------------

VBPI_SPECS = {1: ("JC69", "constant", "strict"), 4: ("GTR", "gamma+4", "none")}


def _vbpi_files(tmp_path, taxa=27, sites=400):
    return _synthetic.write_vbpi_inputs(tmp_path, 5, taxa, 10, sites)


def _instances(files, spec, cuda, particles=12):
    """The unrooted instance on the card (float32) and on the CPU
    (float64), fed the same files, with the same sampled trees and branch
    lengths."""
    nexus, fasta = files
    out = []
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        inst = unrooted_instance("vbpi", device=device, dtype=dtype)
        inst.read_nexus_file(nexus)
        inst.process_loaded_trees()
        inst.read_fasta_file(fasta)
        inst.train_simple_average()
        inst.rng = np.random.default_rng(3)
        inst.sample_trees(particles)
        inst.prepare_for_phylo_likelihood(PhyloModelSpecification(*spec))
        for key, value in (GTR if spec[0] == "GTR" else {}).items():
            inst.get_phylo_model_param_block_map()[key][:] = value
        rng = np.random.default_rng(4)
        for tree in inst.tree_collection.trees:
            tree.branch_lengths[:] = rng.uniform(0.01, 0.3,
                                                 tree.branch_lengths.shape)
        out.append(inst)
    return out


@pytest.mark.parametrize("C", [1, 4])
def test_instance_on_the_card_matches_float64(cuda, tmp_path, C):
    """LL and branch gradients of the instance on the card (the paired
    on-chip bodies, at one rate category and at four) against the
    instance on the CPU in float64, within 5e-5."""
    card, cpu = _instances(_vbpi_files(tmp_path), VBPI_SPECS[C], cuda)
    assert [t.topology.key() for t in card.tree_collection.trees] == [
        t.topology.key() for t in cpu.tree_collection.trees]
    before = (paired.paired_ll_onchip.launches,
              paired.paired_grad_onchip.launches)
    ll = card.log_likelihoods()
    pgs = card.phylo_gradients()
    assert (paired.paired_ll_onchip.launches,
            paired.paired_grad_onchip.launches) == (before[0] + 1,
                                                    before[1] + 1)
    ll_ref = cpu.log_likelihoods()
    ref = cpu.phylo_gradients()
    assert ll.dtype == np.float32
    assert _rel(torch.as_tensor(ll), torch.as_tensor(ll_ref)) <= 5e-5
    assert _rel(torch.tensor([g.log_likelihood() for g in pgs]),
                torch.as_tensor(ll_ref)) <= 5e-5
    g = torch.as_tensor(np.stack([x.gradient["branch_lengths"] for x in pgs]))
    g_ref = torch.as_tensor(np.stack([x.gradient["branch_lengths"]
                                      for x in ref]))
    assert _norm(g, g_ref) <= 5e-5


def test_vbpi_step_takes_only_the_paired_onchip_kernels(cuda, tmp_path,
                                                        monkeypatch):
    """A Burrito step and an ELBO estimate on the card launch the two
    paired on-chip bodies and no other kernel, and never call the scan
    tape."""
    nexus, fasta = _vbpi_files(tmp_path)
    burrito = Burrito(
        mcmc_nexus_path=nexus, burn_in_fraction=0.0, fasta_path=fasta,
        phylo_model_specification=PhyloModelSpecification(*VBPI_SPECS[1]),
        branch_model_name="split", scalar_model_name="lognormal",
        optimizer_name="simple", particle_count=8, device=cuda)

    def scan(*args, **kwargs):
        raise AssertionError("the scan tape was called")

    monkeypatch.setattr(pruning, "log_likelihoods_impl", scan)
    monkeypatch.setattr(pruning, "ll_and_branch_gradients_impl", scan)
    wrappers = PAIRED + (
        chunked.chunked_ll_onchip, chunked.chunked_ll_global,
        chunked.chunked_grad_onchip, chunked.chunked_grad_global,
        pernode.pernode_ll_onchip, pernode.pernode_ll_global,
        pernode.pernode_grad_onchip, pernode.pernode_grad_global)
    before = [w.launches for w in wrappers]
    burrito.gradient_step()
    elbo = burrito.estimate_elbo(8)
    torch.cuda.synchronize()
    after = {w.__name__: n - b for w, n, b in zip(
        wrappers, [w.launches for w in wrappers], before)}
    assert after.pop("paired_ll_onchip") == 1
    assert after.pop("paired_grad_onchip") == 1
    assert not any(after.values()), after
    assert np.isfinite(elbo)


def test_device_sbn_programs_on_the_card_match_numpy(cuda, tmp_path):
    """The EM and the topology gradients in float64 on the card against
    the numpy backend, within 1e-10."""
    nexus, _ = _vbpi_files(tmp_path)
    inst = unrooted_instance("em", device=cuda)
    inst.read_nexus_file(nexus)
    inst.process_loaded_trees()
    score = inst.train_expectation_maximization(0.2, 20, 1e-8)
    on_card = inst.sbn_parameters
    want = inst.train_expectation_maximization(0.2, 20, 1e-8,
                                               backend="numpy")
    assert len(score) == len(want)
    np.testing.assert_allclose(score, want, rtol=1e-10)
    np.testing.assert_allclose(on_card, inst.sbn_parameters, rtol=0,
                               atol=1e-10)
    inst.sample_trees(16)
    log_f = np.random.default_rng(1).normal(-1000.0, 20.0, 16)
    for vimco in (True, False):
        got = inst.topology_gradients(log_f, vimco)
        ref = inst.topology_gradients(log_f, vimco, backend="numpy")
        assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


def test_vbpi_instance_takes_the_native_representations(cuda, tmp_path):
    """The VBPI instance on the card builds a sampled tree set's indexer
    representations natively, equal to the pure-Python ones."""
    nexus, _ = _vbpi_files(tmp_path)
    reps = {}
    for native in (True, False):
        inst = unrooted_instance("vbpi", device=cuda, native=native)
        inst.read_nexus_file(nexus)
        inst.process_loaded_trees()
        inst.train_simple_average()
        inst.rng = np.random.default_rng(3)
        inst.sample_trees(20)
        reps[native] = inst.make_indexer_representations()
    assert reps[True] == [np.asarray(r).tolist() for r in reps[False]]


# ---------------------------------------------------------------------------
# The rooted time-tree instance on the card
# ---------------------------------------------------------------------------

ROOTED_SPECS = [("JC69", "constant"), ("GTR", "weibull+4"),
                ("HKY", "gamma+4")]
# The rooted oracle's parameters (test_rooted.py), by substitution model.
_ORACLE = {"substitution_model_frequencies": [0.1, 0.2, 0.3, 0.4],
           "site_model_parameters": [0.1]}
ROOTED_PARAMS = {
    "JC69": {},
    "GTR": dict(_ORACLE, substitution_model_rates=[0.05, 0.1, 0.15, 0.20,
                                                   0.25, 0.25]),
    "HKY": dict(_ORACLE, substitution_model_rates=[3.0]),
}


def _rooted_instances(tmp_path, spec, cuda, taxa=40, trees=12, sites=600):
    """The rooted instance on the card (float32) and on the CPU (float64),
    on the same dated trees and alignment (joins 0.5-10 years apart), in
    the rooted oracle's regime (test_rooted.py): its frequencies, GTR
    rates and HKY kappa, shape 0.1, a strict clock at rate 0.001."""
    text, dates = _synthetic.dated_trees_newick(6, taxa, trees)
    nwk, fasta = tmp_path / "trees.nwk", tmp_path / "aln.fasta"
    nwk.write_text(text)
    fasta.write_text(_synthetic.fasta_text(_synthetic.random_alignment(
        7, list(dates), sites)))
    out = []
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        inst = rooted_instance("rooted", device=device, dtype=dtype)
        inst.read_newick_file(str(nwk))
        inst.parse_dates_from_taxon_names(True)
        inst.read_fasta_file(str(fasta))
        inst.prepare_for_phylo_likelihood(
            PhyloModelSpecification(*spec, clock="strict"))
        block = inst.get_phylo_model_param_block_map()
        for key, value in ROOTED_PARAMS[spec[0]].items():
            if key in block:
                block[key][:] = value
        for state in inst.tree_states:
            state.rates[:] = 0.001
        out.append(inst)
    return out


@pytest.mark.parametrize("spec", ROOTED_SPECS)
def test_rooted_instance_on_the_card_matches_float64(cuda, tmp_path, spec):
    """The rooted instance's LL (with and without the Jacobian) and every
    gradient key on the card against the instance on the CPU in float64,
    within 5e-5; its likelihoods and branch gradients take the paired
    on-chip bodies on the bifurcating root."""
    card, cpu = _rooted_instances(tmp_path, spec, cuda)
    before = [w.launches for w in PAIRED]
    ll = card.log_likelihoods()
    ll0 = card.log_likelihoods(include_log_det_jacobian=False)
    pgs = card.phylo_gradients()
    torch.cuda.synchronize()
    launched = {w.__name__: w.launches - b for w, b in zip(PAIRED, before)}
    assert launched == {"paired_ll_onchip": 2, "paired_ll_global": 0,
                        "paired_grad_onchip": 1, "paired_grad_global": 0}
    assert _rel(torch.as_tensor(ll), torch.as_tensor(cpu.log_likelihoods())
                ) <= 5e-5
    assert _rel(torch.as_tensor(ll0), torch.as_tensor(cpu.log_likelihoods(
        include_log_det_jacobian=False))) <= 5e-5
    ref = cpu.phylo_gradients()
    assert set(pgs[0].gradient) == set(ref[0].gradient)
    for key in ref[0].gradient:
        g = torch.as_tensor(np.stack([x.gradient[key] for x in pgs]))
        g_ref = torch.as_tensor(np.stack([x.gradient[key] for x in ref]))
        assert _norm(g, g_ref) <= 5e-5, key


# -- the chunk lab (perflab/perf_chunk_lab.py, csrc/chunk_variant.cu) -------

@pytest.fixture(scope="module")
def chunk_flagship():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    from bito_tpu_torch.perflab import perf_chunk_lab

    return perf_chunk_lab.Flagship(torch.device("cuda"), batch=40)


@pytest.mark.parametrize("name", ["v0", "w4", "w8", "norescale", "notips",
                                  "fixstore", "nodot", "unroll"])
def test_chunk_variant_matches_plain(cuda, chunk_flagship, name):
    """Each variant of the chunk lab's kernel against its float64 plain
    version on the flagship's shape (40 trees): the LL within 5e-5
    relative; notips' LL (0 up to rounding) within 5e-5 a site; nodot's
    rows non-finite at the same places and within 5e-5 elsewhere."""
    from bito_tpu_torch.perflab import perf_chunk_lab

    f = chunk_flagship
    variant, W = perf_chunk_lab.parse_name(name)
    dst, tip, e, on = f.tapes(W)
    P = f.P()
    before = perf_chunk_lab.chunk_variant.launches
    rows = perf_chunk_lab.chunk_variant(dst, tip, e, P, f.tips, f.pi,
                                        f.props, variant=variant, onchip=on)
    torch.cuda.synchronize()
    assert perf_chunk_lab.chunk_variant.launches == before + 1
    plain = perf_chunk_lab.chunk_variant_ref(dst, tip, e, P, f.tips, f.pi,
                                             f.props, variant=variant)
    w = f.weights.double()
    ll, ll_p = rows.double() @ w, plain @ w
    if name == "nodot":
        fin = torch.isfinite(plain)
        assert torch.equal(torch.isfinite(rows), fin)
        if fin.any():  # per-site log values (near 0: all-ones columns)
            assert (rows.double() - plain)[fin].abs().max() <= 5e-5
    elif name == "notips":
        assert (ll - ll_p).abs().max() <= 5e-5 * w.sum()
    else:
        assert _rel(ll, ll_p) <= 5e-5


def test_shipping_chunked_ll_is_the_chunk_labs_v0(cuda, chunk_flagship):
    """The shipping chunked LL body (csrc/paired_ll_onchip.cu, whose body
    moved into paired_ll_onchip.cuh) gives v0's rows to the bit, and the
    plain chunked LL within 5e-5."""
    from bito_tpu_torch.perflab import perf_chunk_lab

    f = chunk_flagship
    dst, tip, e, on = f.tapes(chunked.W)
    P = f.P()
    plan = chunked.ll_plan(on.ll_rows, dst.shape[1], P.shape[1], 4)
    ship = chunked.chunked_ll_onchip(dst, on, e, P, f.tips, f.pi, f.props,
                                     plan)
    v0 = perf_chunk_lab.chunk_variant(dst, tip, e, P, f.tips, f.pi, f.props,
                                      variant="v0", onchip=on)
    assert torch.equal(ship, v0)
    ref = chunked.chunked_log_likelihoods_ref(
        dst, tip, e, P.double(), f.tips.double(), f.pi.double(),
        f.props.double(), f.weights.double())
    assert _rel(ship.double() @ f.weights.double(), ref) <= 5e-5


def test_chunk_variant_refuses_what_it_does_not_take(cuda, chunk_flagship):
    from bito_tpu_torch.perflab import perf_chunk_lab

    f = chunk_flagship
    dst, tip, e, on = f.tapes(4)
    with pytest.raises(ValueError, match="unroll is compiled"):
        perf_chunk_lab.chunk_variant(dst, tip, e, f.P(), f.tips, f.pi,
                                     f.props, variant="unroll", onchip=on)
    with pytest.raises(ValueError, match="unknown variant"):
        perf_chunk_lab.chunk_variant(dst, tip, e, f.P(), f.tips, f.pi,
                                     f.props, variant="blockstore",
                                     onchip=on)


# -- the GP engine (gp/, api/gp.py) ---------------------------------------------

def test_gp_engine_on_the_card_matches_float64(cuda, tmp_path):
    """gp_instance on the card in float32 against the same instance on the
    card in float64, on a small synthetic credible set (9 taxa): the log
    marginal and every per-PCSP LL at the same branch lengths within 5e-5
    relative, and after estimate_branch_lengths the log marginal (the
    objective, not the argmin); no hand-written kernel launches."""
    from bito_tpu_torch.api.gp import gp_instance
    from bito_tpu_torch.perflab import perf_chunk_lab

    nwk, fasta = tmp_path / "trees.nwk", tmp_path / "aln.fasta"
    nwk.write_text(_synthetic.credible_set_newick(5, 9, 5, 2))
    fasta.write_text(_synthetic.fasta_text(_synthetic.random_alignment(
        6, _synthetic.taxon_names(9), 300)))
    wrappers = PAIRED + (chunked.chunked_ll_onchip, chunked.chunked_ll_global,
                         perf_chunk_lab.chunk_variant)
    before = [w.launches for w in wrappers]
    out = []
    for dtype in (torch.float32, torch.float64):
        inst = gp_instance(device=cuda, dtype=dtype)
        inst.read_fasta_file(str(fasta))
        inst.read_newick_file(str(nwk))
        inst.make_gp_engine()
        inst.take_first_branch_length()
        inst.populate_plvs()
        inst.compute_likelihoods()
        assert inst.get_gp_engine().plv.device.type == "cuda"
        assert inst.get_gp_engine().plv.dtype == dtype
        start = (inst.get_log_marginal_likelihood(),
                 inst.get_per_gpcsp_log_likelihoods())
        est = inst.estimate_branch_lengths(1e-3, 5)
        out.append((start, est, inst))
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == before
    (m32, pcsp32), est32, i32 = out[0]
    (m64, pcsp64), est64, _ = out[1]
    assert abs(m32 - m64) <= 5e-5 * abs(m64)
    np.testing.assert_allclose(pcsp32, pcsp64, rtol=5e-5)
    assert abs(est32 - est64) <= 5e-5 * abs(est64) and est64 > m64
    assert torch.isfinite(i32.get_gp_engine().plv).all()


def test_gp_engine_refuses_tf32_in_float32(cuda, tmp_path):
    """A float32 GP engine on the card raises while TF32 matmuls are on,
    at construction and at every program after it; float64 is unaffected
    (TF32 never applies to it)."""
    from bito_tpu_torch.api.gp import gp_instance

    nwk, fasta = tmp_path / "trees.nwk", tmp_path / "aln.fasta"
    nwk.write_text(_synthetic.credible_set_newick(5, 6, 3, 1))
    fasta.write_text(_synthetic.fasta_text(_synthetic.random_alignment(
        6, _synthetic.taxon_names(6), 50)))

    def instance(dtype):
        inst = gp_instance(device=cuda, dtype=dtype)
        inst.read_fasta_file(str(fasta))
        inst.read_newick_file(str(nwk))
        return inst

    i32, i64 = instance(torch.float32), instance(torch.float64)
    i32.make_gp_engine()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            instance(torch.float32).make_gp_engine()
        for call in (i32.populate_plvs, i32.compute_likelihoods,
                     i32.optimize_branch_lengths_once,
                     lambda: i32.estimate_branch_lengths(1e-3, 2),
                     i32.calculate_hybrid_marginals):
            with pytest.raises(RuntimeError, match="allow_tf32"):
                call()
        i64.make_gp_engine()
        i64.populate_plvs()
        i64.compute_likelihoods()
        assert np.isfinite(i64.get_log_marginal_likelihood())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _nni_instance(tmp_path, device, dtype, taxa=8, sites=300):
    """gp_instance on synthetic NNI inputs (_synthetic.write_nni_inputs)
    with the DAG and the TP engine made and set by taking first."""
    from bito_tpu_torch.api.gp import gp_instance

    paths = _synthetic.write_nni_inputs(tmp_path, 3, taxa, sites)
    inst = gp_instance(device=device, dtype=dtype)
    inst.read_fasta_file(paths["alignment.fasta"])
    inst.read_newick_file(paths["seed.nwk"])
    inst.make_dag()
    inst.make_tp_engine()
    inst.tp_engine_set_branch_lengths_by_taking_first()
    inst.tp_engine_set_choice_map_by_taking_first()
    return inst


def test_whole_tree_nni_scores_on_the_card_match_float64(cuda, tmp_path):
    """The whole-tree NNI engine with TP-likelihood scoring on the card in
    float32, two iterations: each iteration's candidate scores (the paired
    on-chip LL kernel) against the float64 engine on the card on the same
    candidate trees within 5e-5 relative."""
    from bito_tpu_torch.nni.engine import NNIEngine

    inst = _nni_instance(tmp_path, cuda, torch.float32)
    sp = inst.get_tp_engine().site_pattern
    eng = NNIEngine(inst.get_dag(), sp, inst.tree_collection.trees,
                    device=cuda, dtype=torch.float32)
    ref = TreeLikelihoodEngine(sp, PhyloModel(PhyloModelSpecification()),
                               device=cuda, dtype=torch.float64)
    eng.run_init()
    before = paired.paired_ll_onchip.launches
    for _ in range(2):
        assert eng.run_main_loop()
        scores = {**eng.scored, **eng.accepted_scores_this_iter}
        keys = list(eng._candidate_trees)
        got = np.array([scores[k] for k in keys if k in scores])
        want = ref.log_likelihoods(
            [eng._candidate_trees[k] for k in keys if k in scores],
            {}).cpu().numpy()
        assert np.all(np.abs(got - want) <= 5e-5 * np.abs(want))
        eng.run_post_loop()
    assert paired.paired_ll_onchip.launches > before


def test_batched_nni_scorer_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The faithful search's batched scorer in float64 on the card against
    the same scorer on the CPU: within 1e-10 relative wherever the two
    runs' Brent line searches end at the same points, and within 1e-7
    where a step was decided by rounding (tests/test_torch_batch_scorer.py)."""
    from bito_tpu_torch.nni.golden import nni_sort_key
    from bito_tpu_torch.tp import batch_scorer

    inst = _nni_instance(tmp_path, cuda, torch.float32)
    eng = inst.make_nni_engine("tp_likelihood")
    eng.run_init()
    search = eng.search
    nnis = sorted(search.adjacent, key=nni_sort_key)
    best = search.engine.build_best_edge_map(nnis)
    traced = batch_scorer._brent_minimize
    out = {}
    try:
        for dev in ("cuda", "cpu"):
            ys = []

            def rec(f, guess, lo, hi, active=None, **kwargs):
                y, fy = traced(f, guess, lo, hi, active=active, **kwargs)
                ys.append(torch.where(active, y, torch.nan).cpu().numpy())
                return y, fy

            batch_scorer._brent_minimize = rec
            search.engine.device = dev
            out[dev] = (np.asarray(search.engine.score_proposed_nnis_batched(
                nnis, best)), np.stack(ys))
    finally:
        batch_scorer._brent_minimize = traced
    (card, card_y), (cpu, cpu_y) = out["cuda"], out["cpu"]
    rounded = np.any(~np.isclose(card_y, cpu_y, rtol=0, atol=1e-8,
                                 equal_nan=True), axis=0)
    rel = np.abs(card - cpu) / np.abs(cpu)
    assert len(nnis) >= 4 and np.isfinite(card).all()
    assert np.all(rel[~rounded] <= 1e-10) and np.all(rel[rounded] <= 1e-7)


def test_sankoff_on_the_card_equals_the_cpu(cuda, tmp_path):
    """Sankoff on the card in float32 equals Sankoff on the CPU in float64
    (integer sums), for the TP engine's top trees."""
    from bito_tpu_torch.parsimony.sankoff import SankoffHandler

    inst = _nni_instance(tmp_path, cuda, torch.float32, taxa=12)
    tp = inst.get_tp_engine()
    got = tp.top_tree_parsimony_scores()
    want = SankoffHandler(tp.site_pattern, device="cpu",
                          dtype=torch.float64).run_sankoff(tp.top_trees())
    np.testing.assert_array_equal(got, want)
