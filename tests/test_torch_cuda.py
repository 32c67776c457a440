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
Sankoff on the card against the CPU); and the MG94 codon path (both A=64
kernels against their float64 plain versions, the engine's auto taking
them, the float32 scan tape at 64 states refusing TF32; both at 9-32
rate categories, the engine's auto taking them at 16, and their launches
over slices of trees, bit-equal to one launch); and the paired
kernels at 9-32 rate categories (both bodies of both kernels on 16 or 32
lanes a pattern, at short branches too, past the on-chip limit, and the
engine's auto taking them), and the chunked and per-node kernels there
(every body against float64, at short branches too, past the on-chip
limit, and the engine's chunked route at 16); past 32 categories rows
1-6 on the on-chip bodies with K categories a lane and on the wide
kernels, and rows 4 and 6 on the paired grad body at 17 and 32; and the
driver's entry() forward (graft_entry.py), which takes the paired
on-chip LL body alone; and the program's spans and counters
(utils/timing.py): torch's sync debug mode against each entry point's
`host_syncs`, the tree kernels' launches inside `launch` spans, and the
checkpointed grad body (csrc/paired_grad_ckpt.cu) on 200-taxon trees
within the rbcL 500 configuration's limits, counted as
`checkpoint_launches`, with the same body against its plain version on
921-taxon trees and on edge numbers past 15 bits; and
the paired route's prep kernel (models/csrc/transition_prep.cu) against
the torch ops it replaced, and which calls launch it.

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

from bito_tpu_torch import _synthetic, graft_entry
from bito_tpu_torch.api.instances import rooted_instance, unrooted_instance
from bito_tpu_torch.convert import params_from_numpy
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.core.site_pattern import CodonSitePattern, SitePattern
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.models.substitution import EigenDecomp
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
    """What each paired body launched since `before`, in PAIRED's order
    (then the checkpointed grad body's, where `before` counts it too)."""
    return [f.launches - n for f, n in zip(
        PAIRED + (paired.paired_grad_ckpt,), before)]


@pytest.mark.parametrize("model,rooted,num_trees,patterns", [
    ("gtr_gamma4", False, 5, None), ("gtr_gamma4", True, 3, 150),
    ("jc69", False, 4, 200), ("hky_weibull3", True, 2, None),
    ("gtr_gamma8", False, 3, None), ("gtr_gamma8", True, 2, 77)])
def test_kernels_match_plain(cuda, model, rooted, num_trees, patterns):
    """Both bodies of both kernels (the on-chip ones with either staging)
    and the checkpointed grad body (forced, its schedule at 4 ops a clade,
    so that these 11-taxon trees have ops above the cuts and tier slots)
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
    ckpt = paired.ckpt_tape(*(x.cpu().numpy() for x in (
        dst, onchip.child, e, src)), cuda, ops=4)
    bodies["ckpt"] = (
        lambda: paired.paired_ll_onchip(dst, onchip, e, P, tips, pi, prop,
                                        paired.onchip_plan(
                                            "ll", onchip.ll_rows, M, N1, C)),
        lambda: paired.paired_grad_ckpt(ckpt, P, dP, tips, pi, prop, w))
    for body, (ll_body, grad_body) in bodies.items():
        before = [f.launches for f in PAIRED + (paired.paired_grad_ckpt,)]
        ll = ll_body() @ w
        ll2, g = paired.finish_rows(*grad_body(), mask, w)
        torch.cuda.synchronize()
        assert _launched(before) == {"global": [0, 1, 0, 1, 0],
                                     "ckpt": [1, 0, 0, 0, 1]}.get(
                                         body, [1, 0, 1, 0, 0]), body
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


def test_tree_past_the_limit_takes_the_global_ll_and_checkpointed_grad_bodies(
        cuda):
    """On the 921-taxon trees the engine's LL takes the global LL body and
    its gradients the checkpointed grad body (the on-chip grad body gets
    no plan); the global grad body (csrc/paired_grad.cu), which the
    wrapper keeps past 8 categories, through its launcher; each within
    5e-5 of the float64 plain version."""
    eng, trees, params = _large_tree_engine(cuda, torch.float32)
    assert eng.pattern_pad == 128
    before = [f.launches for f in PAIRED + (paired.paired_grad_ckpt,)]
    ll = eng.log_likelihoods(trees, params)
    ll2, g = eng.ll_and_branch_gradients(trees, params)
    torch.cuda.synchronize()
    assert _launched(before) == [0, 1, 0, 0, 1]
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
    before = [f.launches for f in PAIRED + (paired.paired_grad_ckpt,)]
    ll3, g3 = paired.finish_rows(*paired.paired_grad_global(
        dst, tip, src, e, P, dP, eng._kernel_tips, pi, prop,
        eng._kernel_weights), mask, eng._kernel_weights)
    torch.cuda.synchronize()
    assert _launched(before) == [0, 0, 0, 1, 0]
    assert _rel(ll3, ll_ref) < 5e-5 and _norm(g3, g_ref) < 5e-5
    onchip = eng._onchip_tape(enc)
    M, N1 = dst.shape[1], P.shape[1]
    assert paired.onchip_plan("ll", onchip.ll_rows, M, N1, 4) is None
    assert paired.onchip_plan("grad", onchip.grad_rows, M, N1, 4) is None
    assert onchip.ckpt is not None


@pytest.mark.parametrize("model", ["jc69", "hky_weibull3", "gtr_gamma4",
                                   "gtr_gamma8"])
@pytest.mark.parametrize("which", ["comb", "balanced", "both"])
def test_checkpointed_body_matches_its_plain_version_on_921_taxa(
        cuda, model, which):
    """The checkpointed grad body (csrc/paired_grad_ckpt.cu) on
    chip_smoke.py's 921-taxon trees, the cherry comb (nearly every op a
    checkpoint in the device tier) and the balanced tree, alone and
    together, at 1, 3, 4 and 8 categories: within 5e-5 of its plain
    version (paired.paired_grad_ckpt_ref) in float64 on the same float32
    operands and schedule, and of the paired tape's plain version."""
    eng, trees, _ = _large_tree_engine(cuda, torch.float32)
    eng = TreeLikelihoodEngine(
        eng.site_pattern, PhyloModel(PhyloModelSpecification(
            *MODELS[model][0])), device=cuda, dtype=torch.float32)
    params = params_from_numpy(MODELS[model][1], cuda, torch.float32)
    trees = {"comb": trees[:1], "balanced": trees[1:], "both": trees}[which]
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock,
                                       eng.branch_length_matrix(trees, enc))
    tips, w = eng._kernel_tips, eng._kernel_weights
    ckpt = eng._onchip_tape(enc).ckpt
    before = paired.paired_grad_ckpt.launches
    ll, g = paired.finish_rows(*paired.paired_grad_ckpt(
        ckpt, P, dP, tips, pi, prop, w), mask, w)
    torch.cuda.synchronize()
    assert paired.paired_grad_ckpt.launches == before + 1
    f64 = _f64(P, dP, tips, pi, prop, w)
    ll_p, g_p = paired.finish_rows(*paired.paired_grad_ckpt_ref(
        ckpt.sched, ckpt.rows, ckpt.slots, *f64), mask.double(), f64[-1])
    ll_ref, g_ref = paired.paired_ll_and_gradients_ref(dst, tip, src, e,
                                                       mask, *f64)
    assert bool(torch.isfinite(g).all())
    for want_ll, want_g in ((ll_p, g_p), (ll_ref, g_ref)):
        assert _rel(ll, want_ll) < 5e-5 and _norm(g, want_g) < 5e-5


def test_checkpointed_body_takes_edges_and_rows_past_15_bits(cuda):
    """The 921-taxon trees' schedule with every edge and gradient row
    moved up by 40,000, which sets the sign bit of the schedule's packed
    fields, over P and dP moved up as far: the checkpointed body gives
    the LLs and gradients of the tapes' own numbers bit for bit."""
    eng, trees, params = _large_tree_engine(cuda, torch.float32)
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock,
                                       eng.branch_length_matrix(trees, enc))
    tips, w = eng._kernel_tips, eng._kernel_weights
    off = 40_000

    def up(x):  # off rows of zeros below x's edges
        return torch.cat([x.new_zeros((x.shape[0], off) + x.shape[2:]), x],
                         dim=1)

    dst_h, tip_h, src_h, e_h = (x.cpu().numpy() for x in (dst, tip, src, e))
    child = paired.child_tape(dst_h, tip_h)
    ckpt = paired.ckpt_tape(dst_h, child, e_h, src_h, cuda)
    ckpt_hi = paired.ckpt_tape(dst_h, child, e_h + off, src_h + off, cuda)
    assert bool((ckpt_hi.sched[..., 1] < 0).any())
    assert bool((ckpt_hi.sched[..., 7] < 0).any())
    ll, g = paired.finish_rows(*paired.paired_grad_ckpt(
        ckpt, P, dP, tips, pi, prop, w), mask, w)
    ll_hi, g_hi = paired.finish_rows(*paired.paired_grad_ckpt(
        ckpt_hi, up(P), up(dP), tips, pi, prop, w), up(mask), w)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(g).all())
    assert torch.equal(ll_hi, ll) and torch.equal(g_hi[:, off:], g)


def test_wrappers_reject_operands_the_kernels_do_not_take(cuda):
    eng, trees, params = _engine("gtr_gamma4", 9, 8, 2, False, cuda,
                                 torch.float32)
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, 2)
    dst, tip, src, e, _mask = eng._paired_tapes(enc)
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
    other = paired.onchip_tape(
        dst[:1].cpu().numpy(), tip[:1].cpu().numpy(), cuda,
        post_src=src[:1].cpu().numpy(), post_e=e[:1].cpu().numpy(),
        edges=P.shape[1])
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


# 9..32 rate categories: the paired kernels' bodies on 16 or 32 lanes a
# pattern (C = 9 and 17 with idle lanes), both on a tree under the on-chip
# limit and on the large trees past it, and at branches of 1e-6, where
# each category's share of a pattern's likelihood is smallest.
WIDE = (9, 16, 17, 32)


def _wide_operands(eng, trees, params, scale=1.0):
    """The paired kernels' float32 operands of `eng` at its branch lengths
    times `scale`, and the float64 plain version's (ll, grads) on them."""
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(
        eig, rates, clock, eng.branch_length_matrix(trees, enc) * scale)
    tips, w = eng._kernel_tips, eng._kernel_weights
    ops = (dst, tip, src, e, mask, P, dP, tips, pi, prop, w)
    ref = paired.paired_ll_and_gradients_ref(
        dst, tip, src, e, mask, *_f64(P, dP, tips, pi, prop, w))
    return ops, eng._onchip_tape(enc), ref


def _wide_engine(C, large, device, dtype):
    if large:
        eng, trees, _ = _large_tree_engine(device, dtype)
        eng = TreeLikelihoodEngine(
            eng.site_pattern,
            PhyloModel(PhyloModelSpecification("GTR", f"gamma+{C}")),
            device=device, dtype=dtype)
    else:
        text = _synthetic.random_trees_newick(13, 11, 3, False)
        coll = parse_newick_text(text)
        aln = _synthetic.random_alignment(14, coll.taxon_names, 300)
        eng = TreeLikelihoodEngine(
            SitePattern(aln, coll.taxon_names),
            PhyloModel(PhyloModelSpecification("GTR", f"gamma+{C}")),
            device=device, dtype=dtype)
        trees = coll.trees
    return eng, trees, params_from_numpy(GTR, device, dtype)


@pytest.mark.parametrize("C", WIDE)
@pytest.mark.parametrize("scale", [1.0, 1e-6], ids=["bl", "bl1e-6"])
def test_kernels_past_8_categories_match_plain(cuda, C, scale):
    """Both bodies of both kernels at 9..32 categories (the on-chip ones in
    either staging) against their plain versions in float64 on the same
    float32 operands, on an 11-taxon batch, at its branch lengths and at
    those times 1e-6 (about 1e-7 substitutions a branch)."""
    eng, trees, params = _wide_engine(C, False, cuda, torch.float32)
    ops, onchip, (ll_ref, g_ref) = _wide_operands(eng, trees, params, scale)
    dst, tip, src, e, mask, P, dP, tips, pi, prop, w = ops
    M, N1 = dst.shape[1], P.shape[1]
    bodies = {"global": (
        lambda: paired.paired_ll_global(dst, tip, e, P, tips, pi, prop),
        lambda: paired.paired_grad_global(dst, tip, src, e, P, dP, tips, pi,
                                          prop, w))}
    for ring in (False, True):
        ll_plan = paired.onchip_plan("ll", onchip.ll_rows, M, N1, C, ring)
        grad_plan = paired.onchip_plan("grad", onchip.grad_rows, M, N1, C,
                                       ring)
        assert ll_plan.lanes == grad_plan.lanes == (16 if C <= 16 else 32)
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
        assert bool(torch.isfinite(g).all()), body
        assert _rel(ll, ll_ref) < 5e-5 and _rel(ll2, ll_ref) < 5e-5, body
        assert _norm(g, g_ref) < 5e-5, body


@pytest.mark.parametrize("C", [9, 16, 32])
def test_tree_past_the_limit_takes_the_global_bodies_past_8_categories(
        cuda, C):
    """The large trees at 9..32 categories: the wrappers take the global
    bodies (the lane layout in device memory), within 5e-5 of float64."""
    eng, trees, params = _wide_engine(C, True, cuda, torch.float32)
    ops, onchip, (ll_ref, g_ref) = _wide_operands(eng, trees, params)
    dst, tip, src, e, mask, P, dP, tips, pi, prop, w = ops
    M, N1 = dst.shape[1], P.shape[1]
    assert paired.onchip_plan("ll", onchip.ll_rows, M, N1, C) is None
    assert paired.onchip_plan("grad", onchip.grad_rows, M, N1, C) is None
    before = [f.launches for f in PAIRED]
    ll = paired.paired_log_likelihoods(dst, tip, e, P, tips, pi, prop, w,
                                       onchip=onchip)
    ll2, g = paired.paired_ll_and_gradients(*ops, onchip=onchip)
    torch.cuda.synchronize()
    assert _launched(before) == [0, 1, 0, 1]
    assert _rel(ll, ll_ref) < 5e-5 and _rel(ll2, ll_ref) < 5e-5
    assert _norm(g, g_ref) < 5e-5


def test_engine_auto_takes_the_kernels_at_16_categories(cuda):
    """auto on the card at GTR+Gamma16 takes the on-chip bodies of both
    kernels (before, 9 or more categories took the scan tape), within
    5e-5 of the float64 engine on the CPU; at 33 categories auto takes
    the on-chip bodies with two categories a lane (once, the scan tape),
    within 5e-5 as well."""
    eng, trees, params = _wide_engine(16, False, cuda, torch.float32)
    ref, _, ref_params = _wide_engine(16, False, "cpu", torch.float64)
    before = [f.launches for f in PAIRED]
    ll = eng.log_likelihoods(trees, params)
    ll2, g = eng.ll_and_branch_gradients(trees, params)
    assert _launched(before) == [1, 0, 1, 0]
    ll_ref, g_ref = ref.ll_and_branch_gradients(trees, ref_params)
    assert _rel(ll.cpu(), ll_ref) < 5e-5 and _rel(ll2.cpu(), ll_ref) < 5e-5
    assert _norm(g.cpu(), g_ref) < 5e-5
    wide, trees, params = _wide_engine(33, False, cuda, torch.float32)
    ref, _, ref_params = _wide_engine(33, False, "cpu", torch.float64)
    assert wide._route(True) == "paired"
    before = [f.launches for f in PAIRED]
    ll = wide.log_likelihoods(trees, params)
    ll2, g = wide.ll_and_branch_gradients(trees, params)
    torch.cuda.synchronize()
    assert _launched(before) == [1, 0, 1, 0]
    ll_ref, g_ref = ref.ll_and_branch_gradients(trees, ref_params)
    assert _rel(ll.cpu(), ll_ref) < 5e-5 and _rel(ll2.cpu(), ll_ref) < 5e-5
    assert _norm(g.cpu(), g_ref) < 5e-5


# Past 32 categories K = ceil(C / 32) categories a lane of 32: the
# on-chip bodies to K = 4 (csrc/paired_ll_onchip.cuh,
# csrc/paired_grad_onchip.cu), the global bodies' wide kernels at any K
# (csrc/paired_lanes.cuh, csrc/pernode_lanes.cuh)
WIDER = (33, 64, 96, 128)


@pytest.mark.parametrize("C", WIDER)
@pytest.mark.parametrize("scale", [1.0, 1e-6], ids=["bl", "bl1e-6"])
def test_kernels_past_32_categories_match_plain(cuda, C, scale):
    """Both paired kernels at 33-128 categories: the on-chip plans hold K
    = ceil(C / 32) categories a lane on the ring (none staged), and the
    wrappers launch the K bodies; the global bodies' wide kernels through
    their launchers; each within 5e-5 of its plain version in float64 on
    the same float32 operands, on the 11-taxon batch at its branch
    lengths and at those times 1e-6."""
    eng, trees, params = _wide_engine(C, False, cuda, torch.float32)
    ops, onchip, (ll_ref, g_ref) = _wide_operands(eng, trees, params, scale)
    dst, tip, src, e, mask, P, dP, tips, pi, prop, w = ops
    M, N1 = dst.shape[1], P.shape[1]
    for kernel, rows in (("ll", onchip.ll_rows), ("grad", onchip.grad_rows)):
        plan = paired.onchip_plan(kernel, rows, M, N1, C)
        assert plan.categories_per_lane == -(-C // 32) and plan.ring
        assert paired.onchip_plan(kernel, rows, M, N1, C, False) is None
    bodies = {
        "wrappers (K bodies)": (
            lambda: paired.paired_log_likelihoods(
                dst, tip, e, P, tips, pi, prop, w, onchip=onchip),
            lambda: paired.paired_ll_and_gradients(*ops, onchip=onchip),
            [1, 0, 1, 0]),
        "global (wide kernels)": (
            lambda: paired.paired_ll_global(dst, tip, e, P, tips, pi,
                                            prop) @ w,
            lambda: paired.finish_rows(*paired.paired_grad_global(
                dst, tip, src, e, P, dP, tips, pi, prop, w), mask, w),
            [0, 1, 0, 1])}
    for body, (ll_call, grad_call, launched) in bodies.items():
        before = [f.launches for f in PAIRED]
        ll = ll_call()
        ll2, g = grad_call()
        torch.cuda.synchronize()
        assert _launched(before) == launched, body
        assert all(bool(torch.isfinite(x).all()) for x in (ll, ll2, g)), body
        assert _rel(ll, ll_ref) < 5e-5 and _rel(ll2, ll_ref) < 5e-5, body
        assert _norm(g, g_ref) < 5e-5, body


def test_global_tree_slices_give_the_rows_of_one_launch(cuda, monkeypatch):
    """At 64 categories, on a card that holds the scratch of two trees
    (the allocation and paired.scratch_budget faked), the paired,
    chunked and per-node global launchers take 3 trees in two launches
    each, whose rows are bit-equal to one launch's; a budget under one
    tree raises before any launch, naming the bytes."""
    eng, trees, params = _wide_engine(64, False, cuda, torch.float32)
    ops, onchip, _ = _wide_operands(eng, trees, params)
    dst, tip, src, e, mask, P, dP, tips, pi, prop, w = ops
    rops, _ = _rows_3_to_6(eng, trees, params)
    (cdst, ctip, ce, _, con), (post, pre, root, _, _), _, P4, dP4, *_ = rops
    calls = {
        paired.paired_ll_global: lambda: paired.paired_ll_global(
            dst, tip, e, P, tips, pi, prop),
        paired.paired_grad_global: lambda: paired.paired_grad_global(
            dst, tip, src, e, P, dP, tips, pi, prop, w),
        chunked.chunked_ll_global: lambda: chunked.chunked_ll_global(
            cdst, ctip, ce, P4, tips, pi, prop, child=con.child),
        chunked.chunked_grad_global: lambda: chunked.chunked_grad_global(
            cdst, ctip, ce, P4, dP4, tips, pi, prop, w, child=con.child),
        pernode.pernode_ll_global: lambda: pernode.pernode_ll_global(
            post, root, P4, tips, pi, prop),
        pernode.pernode_grad_global: lambda: pernode.pernode_grad_global(
            post, pre, root, P4, dP4, tips, pi, prop, w)}
    launch_sliced = paired.launch_sliced
    for launcher, call in calls.items():
        whole = call()
        whole = whole if isinstance(whole, tuple) else (whole,)
        budget = {}

        def on_a_small_card(entry, B, alloc, launch, device,
                            tree_bytes=None):
            def sized(n, dev):
                out = alloc(n, dev)
                if dev != "meta" and sum(t.numel() * t.element_size()
                                         for t in out) > budget["bytes"]:
                    raise torch.cuda.OutOfMemoryError("the card is full")
                return out
            budget.setdefault("tree", sum(
                t.numel() * t.element_size() for t in alloc(1, "meta")))
            budget.setdefault("bytes", 2 * budget["tree"] + 1)
            return launch_sliced(entry, B, sized, launch, device, tree_bytes)

        monkeypatch.setattr(paired, "launch_sliced", on_a_small_card)
        monkeypatch.setattr(paired, "scratch_budget",
                            lambda device: budget["bytes"])
        before = launcher.launches
        sliced = call()
        sliced = sliced if isinstance(sliced, tuple) else (sliced,)
        torch.cuda.synchronize()
        assert launcher.launches - before == 2, launcher.__name__
        for a, b in zip(whole, sliced):
            assert torch.equal(a, b), launcher.__name__
        budget["bytes"] = budget["tree"] - 1
        with pytest.raises(torch.cuda.OutOfMemoryError,
                           match=f"{budget['tree']} bytes a tree"):
            call()
        assert launcher.launches - before == 2
        monkeypatch.undo()


def _rows_3_to_6(eng, trees, params, scale=1.0):
    """The chunked and per-node kernels' float32 operands of `eng` at its
    branch lengths times `scale` (dP from prep.prepare_inputs_grad, as on
    their routes): (chunked (dst, tip, e, row, on-chip tape), per-node
    (post, pre, root, LL tape, grad tape), mask, P, dP, tips, pi, prop, w)
    and the float64 plain versions' (ll, grads) of each family."""
    enc = eng.encode(trees)
    dev = eng.device
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad(
        eig, rates, clock, eng.branch_length_matrix(trees, enc) * scale)
    tips, w = eng._kernel_tips, eng._kernel_weights
    mask = torch.as_tensor(enc.edge_mask, dtype=torch.float32, device=dev)
    ce = chunked.build_chunked_encoding(enc, chunked.W)
    dst, tip, e, row = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                        for x in (ce.post_dst, ce.tip_slot, ce.post_e,
                                  ce.node_row))
    post, pre, root = _pernode_tapes(enc, dev)
    ctapes = (dst, tip, e, row, chunked.onchip_tape(ce.post_dst, ce.tip_slot,
                                                    dev))
    ptapes = (post, pre, root,
              pernode.ll_tape(enc.post_ops, enc.root, enc.num_taxa,
                              enc.num_slots, dev),
              pernode.onchip_tape(enc.post_ops, enc.pre_ops, enc.root,
                                  enc.num_taxa, enc.num_slots, dev))
    f64 = _f64(P, dP, tips, pi, prop, w)
    refs = (chunked.chunked_ll_and_gradients_ref(dst, tip, e, row, mask,
                                                 *f64),
            pernode.pernode_ll_and_gradients_ref(post, pre, root, mask, *f64))
    return (ctapes, ptapes, mask, P, dP, tips, pi, prop, w), refs


def _rows_3_to_6_bodies(ops, onchip_least):
    """Every body of the chunked and per-node kernels as (name, LL call or
    None, grad call or None, launches in CHUNKED + PERNODE order): the
    on-chip ones with plans at `onchip_least` warps (None: the wrappers'
    own choice, through the wrappers), the global ones through their
    launchers.  Each call returns (ll [B], grads [B, N] or None)."""
    (dst, tip, e, row, con), (post, pre, root, lt, gt), mask, P, dP, tips, \
        pi, prop, w = ops
    C, N1 = P.shape[2], P.shape[1]
    MW, M = dst.shape[1], post.shape[1]
    cgrad = lambda rows: chunked.finish_rows(*rows, row, mask, w)
    pgrad = lambda rows: pernode.finish_rows(*rows, mask, w)
    bodies = [
        ("chunked ll global", lambda: (chunked.chunked_ll_global(
            dst, tip, e, P, tips, pi, prop, child=con.child) @ w, None),
         [0, 1, 0, 0, 0, 0, 0, 0]),
        ("chunked grad global", lambda: cgrad(chunked.chunked_grad_global(
            dst, tip, e, P, dP, tips, pi, prop, w, child=con.child)),
         [0, 0, 0, 1, 0, 0, 0, 0]),
        ("pernode ll global", lambda: (pernode.pernode_ll_global(
            post, root, P, tips, pi, prop) @ w, None),
         [0, 0, 0, 0, 0, 1, 0, 0]),
        ("pernode grad global", lambda: pgrad(pernode.pernode_grad_global(
            post, pre, root, P, dP, tips, pi, prop, w)),
         [0, 0, 0, 0, 0, 0, 0, 1])]
    if onchip_least is not None:
        cl = chunked.ll_plan(con.ll_rows, MW, N1, C)
        cg = chunked.onchip_plan(con.grad_rows, MW, N1, C, onchip_least)
        pl = paired.onchip_plan("ll", lt.ll_rows, M, N1, C)
        pg = pernode.onchip_plan(gt.rows, gt.ints, N1, C, onchip_least)
        assert all(p.lanes == paired.lanes(C) for p in (cl, cg, pl, pg))
        assert cg.op_lanes == (1 if C > 16 else chunked.W)
        bodies += [
            ("chunked ll onchip", lambda: (chunked.chunked_ll_onchip(
                dst, con, e, P, tips, pi, prop, cl) @ w, None),
             [1, 0, 0, 0, 0, 0, 0, 0]),
            ("chunked grad onchip", lambda: cgrad(chunked.chunked_grad_onchip(
                dst, con, e, P, dP, tips, pi, prop, w, cg)),
             [0, 0, 1, 0, 0, 0, 0, 0]),
            ("pernode ll onchip", lambda: (pernode.pernode_ll_onchip(
                lt, P, tips, pi, prop, pl) @ w, None),
             [0, 0, 0, 0, 1, 0, 0, 0]),
            ("pernode grad onchip", lambda: pgrad(pernode.pernode_grad_onchip(
                gt, root, P, dP, tips, pi, prop, w, pg)),
             [0, 0, 0, 0, 0, 0, 1, 0])]
    return bodies


def _check_rows_3_to_6(ops, refs, bodies):
    for name, call, launched in bodies:
        before = [f.launches for f in CHUNKED + PERNODE]
        ll, g = call()
        torch.cuda.synchronize()
        assert [f.launches - n for f, n in zip(CHUNKED + PERNODE,
                                               before)] == launched, name
        ll_ref, g_ref = refs[0 if name.startswith("chunked") else 1]
        assert bool(torch.isfinite(ll).all()), name
        assert _rel(ll, ll_ref) < 5e-5, name
        if g is not None:
            assert bool(torch.isfinite(g).all()), name
            assert _norm(g, g_ref) < 5e-5, name


@pytest.mark.parametrize("C", WIDE)
@pytest.mark.parametrize("scale", [1.0, 1e-6], ids=["bl", "bl1e-6"])
def test_chunked_and_pernode_kernels_past_8_categories_match_plain(
        cuda, C, scale):
    """Every body of the chunked and per-node kernels at 9..32 categories
    (the on-chip ones on 16 or 32 lanes a pattern, the chunked grad on two
    op lanes or one; the global ones in the lane layout) against their
    plain versions in float64 on the same float32 operands, on the
    11-taxon batch, at its branch lengths and at those times 1e-6; and
    the four wrappers, which take the on-chip bodies there."""
    eng, trees, params = _wide_engine(C, False, cuda, torch.float32)
    ops, refs = _rows_3_to_6(eng, trees, params, scale)
    _check_rows_3_to_6(ops, refs, _rows_3_to_6_bodies(ops, 1))
    (dst, tip, e, row, con), (post, pre, root, lt, gt), mask, P, dP, tips, \
        pi, prop, w = ops
    _check_rows_3_to_6(ops, refs, [
        ("chunked wrappers", lambda: (
            chunked.chunked_log_likelihoods(dst, tip, e, P, tips, pi, prop,
                                            w, onchip=con),
            chunked.chunked_ll_and_gradients(dst, tip, e, row, mask, P, dP,
                                             tips, pi, prop, w,
                                             onchip=con)[1]),
         [1, 0, 1, 0, 0, 0, 0, 0]),
        ("pernode wrappers", lambda: (
            pernode.pernode_log_likelihoods(post, root, P, tips, pi, prop, w,
                                            onchip=lt),
            pernode.pernode_ll_and_gradients(post, pre, root, mask, P, dP,
                                             tips, pi, prop, w,
                                             onchip=gt)[1]),
         [0, 0, 0, 0, 1, 0, 1, 0])])


@pytest.mark.parametrize("C", [9, 16, 32])
def test_tree_past_the_limit_takes_the_global_chunked_and_pernode_bodies(
        cuda, C):
    """The 921-taxon trees at 9..32 categories: no warp of any on-chip
    body of the chunked and per-node kernels fits, and their wrappers
    launch the global bodies (the lane layouts in device memory), within
    5e-5 of float64."""
    eng, trees, params = _wide_engine(C, True, cuda, torch.float32)
    ops, refs = _rows_3_to_6(eng, trees, params)
    _check_global_rows_3_to_6(ops, refs, C)


def _check_global_rows_3_to_6(ops, refs, C):
    """No on-chip body of rows 3-6 takes the tree at any warp count, and
    the four wrappers launch the global bodies within 5e-5 of float64."""
    (dst, tip, e, row, con), (post, pre, root, lt, gt), mask, P, dP, tips, \
        pi, prop, w = ops
    N1 = P.shape[1]
    assert chunked.onchip_plan(con.grad_rows, dst.shape[1], N1, C,
                               least=1) is None
    assert pernode.onchip_plan(gt.rows, gt.ints, N1, C, least=1) is None
    assert chunked.ll_plan(con.ll_rows, dst.shape[1], N1, C) is None
    assert paired.onchip_plan("ll", lt.ll_rows, post.shape[1], N1, C) is None
    _check_rows_3_to_6(ops, refs, [
        ("chunked wrappers", lambda: (
            chunked.chunked_log_likelihoods(dst, tip, e, P, tips, pi, prop,
                                            w, onchip=con),
            chunked.chunked_ll_and_gradients(dst, tip, e, row, mask, P, dP,
                                             tips, pi, prop, w,
                                             onchip=con)[1]),
         [0, 1, 0, 1, 0, 0, 0, 0]),
        ("pernode wrappers", lambda: (
            pernode.pernode_log_likelihoods(post, root, P, tips, pi, prop, w,
                                            onchip=lt),
            pernode.pernode_ll_and_gradients(post, pre, root, mask, P, dP,
                                             tips, pi, prop, w,
                                             onchip=gt)[1]),
         [0, 0, 0, 0, 0, 1, 0, 1])])


@pytest.mark.parametrize("C", WIDER)
@pytest.mark.parametrize("scale", [1.0, 1e-6], ids=["bl", "bl1e-6"])
def test_chunked_and_pernode_kernels_past_32_categories_match_plain(
        cuda, C, scale):
    """Rows 3-6 at 33-128 categories on the 11-taxon batch, at its
    branch lengths and at those times 1e-6: every global body (the wide
    kernels) through its launcher, and the four wrappers, which take the
    K bodies (rows 3 and 5 the on-chip LL body, rows 4 and 6 the paired
    grad body on their tapes; their own on-chip bodies have no plan past
    32), within 5e-5 of float64."""
    eng, trees, params = _wide_engine(C, False, cuda, torch.float32)
    ops, refs = _rows_3_to_6(eng, trees, params, scale)
    _check_rows_3_to_6(ops, refs, _rows_3_to_6_bodies(ops, None))
    _check_paired_rows_3_to_6(ops, refs, C, ll_onchip=True)


# Rows 4 and 6 on the paired grad kernel's on-chip body
ROWS_PAIRED = (chunked.chunked_grad_paired, pernode.pernode_grad_paired)


def _check_paired_rows_3_to_6(ops, refs, C, ll_onchip):
    """The own on-chip bodies of rows 4 and 6 get no plan, the paired
    grad body does on their tapes, and the four wrappers launch it for
    rows 4 and 6 (and the on-chip LL body, or with `ll_onchip` False the
    global LL bodies, for rows 3 and 5) within 5e-5 of float64."""
    (dst, tip, e, row, con), (post, pre, root, lt, gt), mask, P, dP, tips, \
        pi, prop, w = ops
    N1, MW = P.shape[1], dst.shape[1]
    assert chunked.onchip_plan(con.grad_rows, MW, N1, C) is None
    assert pernode.onchip_plan(gt.rows, gt.ints, N1, C) is None
    for plan in (chunked.paired_plan(con.grad_rows, MW, N1, C),
                 pernode.paired_plan(gt.paired, N1, C)):
        assert plan.categories_per_lane == -(-C // 32) and plan.lanes == 32
    ll = int(ll_onchip)
    for name, call, launched in [
            ("chunked wrappers", lambda: (
                chunked.chunked_log_likelihoods(dst, tip, e, P, tips, pi,
                                                prop, w, onchip=con),
                chunked.chunked_ll_and_gradients(dst, tip, e, row, mask, P,
                                                 dP, tips, pi, prop, w,
                                                 onchip=con)[1]),
             [ll, 1 - ll, 0, 0, 0, 0, 0, 0, 1, 0]),
            ("pernode wrappers", lambda: (
                pernode.pernode_log_likelihoods(post, root, P, tips, pi,
                                                prop, w, onchip=lt),
                pernode.pernode_ll_and_gradients(post, pre, root, mask, P,
                                                 dP, tips, pi, prop, w,
                                                 onchip=gt)[1]),
             [0, 0, 0, 0, ll, 1 - ll, 0, 0, 0, 1])]:
        bodies = CHUNKED + PERNODE + ROWS_PAIRED
        before = [f.launches for f in bodies]
        ll_k, g = call()
        torch.cuda.synchronize()
        assert [f.launches - n for f, n in zip(bodies, before)] == (
            launched), name
        ll_ref, g_ref = refs[0 if name.startswith("chunked") else 1]
        assert bool(torch.isfinite(ll_k).all() and torch.isfinite(g).all())
        assert _rel(ll_k, ll_ref) < 5e-5 and _norm(g, g_ref) < 5e-5, name


@pytest.mark.parametrize("C", [17, 32])
def test_rows_4_and_6_take_the_paired_grad_body_at_17_and_32(cuda, C):
    """Six trees of the flagship's shape (27 taxa) at 17 and 32
    categories, where the chunked and per-node grad bodies' tree P and dP
    staged at once leave one warp (under their MIN_WARPS): the wrappers
    of rows 4 and 6 launch the paired grad body on their tapes (32 lanes,
    a category each), rows 3 and 5 the on-chip LL body, within 5e-5 of
    float64."""
    text, aln = _synthetic.ds1_shaped(0, 6)
    coll = parse_newick_text(text)
    eng = TreeLikelihoodEngine(
        SitePattern(aln, coll.taxon_names),
        PhyloModel(PhyloModelSpecification("GTR", f"gamma+{C}")),
        device=cuda, dtype=torch.float32)
    ops, refs = _rows_3_to_6(eng, coll.trees,
                             params_from_numpy(GTR, cuda, torch.float32))
    _check_paired_rows_3_to_6(ops, refs, C, ll_onchip=True)


def test_engine_chunked_takes_the_chunked_kernels_at_16_categories(cuda):
    """kernel="chunked" on the card at GTR+Gamma16 on the flagship's shape
    launches the on-chip bodies of both chunked kernels (before, its
    wrappers raised past 8 categories) for log_likelihoods,
    ll_and_branch_gradients and branch_eval_fn, within 5e-5 of the
    float64 scan tape on the card; at 33 categories it launches the
    on-chip LL body and the paired grad body on the chunked tape, two
    categories a lane (once, it raised), within 5e-5 as well."""
    text, aln = _synthetic.ds1_shaped(0, 6)
    coll = parse_newick_text(text)
    sp = SitePattern(aln, coll.taxon_names)
    model = PhyloModel(PhyloModelSpecification("GTR", "gamma+16"))
    eng = TreeLikelihoodEngine(sp, model, device=cuda, dtype=torch.float32)
    eng.kernel = "chunked"
    ref = TreeLikelihoodEngine(sp, model, device=cuda, dtype=torch.float64)
    ref.kernel = "scan"
    trees = coll.trees
    params = params_from_numpy(GTR, cuda, torch.float32)
    params64 = params_from_numpy(GTR, cuda, torch.float64)
    bl = eng.branch_length_matrix(trees, eng.encode(trees))
    before = [f.launches for f in CHUNKED + PAIRED]
    ll = eng.log_likelihoods(trees, params)
    ll2, g = eng.ll_and_branch_gradients(trees, params)
    ll3, g3 = eng.branch_eval_fn(trees, params)(bl * 1.01)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(CHUNKED + PAIRED, before)] == [
        1, 0, 2, 0, 0, 0, 0, 0]
    ll_ref, g_ref = ref.ll_and_branch_gradients(trees, params64)
    ll3_ref, g3_ref = ref.branch_eval_fn(trees, params64)(bl.double() * 1.01)
    assert _rel(ll, ll_ref) < 5e-5 and _rel(ll2, ll_ref) < 5e-5
    assert _norm(g, g_ref) < 5e-5
    assert _rel(ll3, ll3_ref) < 5e-5 and _norm(g3, g3_ref) < 5e-5
    wide, trees, params = _wide_engine(33, False, cuda, torch.float32)
    ref, _, ref_params = _wide_engine(33, False, "cpu", torch.float64)
    wide.kernel = "chunked"
    before = [f.launches for f in CHUNKED + PAIRED + ROWS_PAIRED]
    ll = wide.log_likelihoods(trees, params)
    ll2, g = wide.ll_and_branch_gradients(trees, params)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(CHUNKED + PAIRED + ROWS_PAIRED,
                                           before)] == [
        1, 0, 0, 0, 0, 0, 0, 0, 1, 0]
    ll_ref, g_ref = ref.ll_and_branch_gradients(trees, ref_params)
    assert _rel(ll.cpu(), ll_ref) < 5e-5 and _rel(ll2.cpu(), ll_ref) < 5e-5
    assert _norm(g.cpu(), g_ref) < 5e-5


MG94 = {"substitution_model_rates": np.array([2.5, 0.3]),
        "substitution_model_frequencies": np.array([0.3, 0.2, 0.3, 0.2])}
A64 = (paired.paired_ll_a64, paired.paired_grad_a64)
# The A=64 kernels against float64 on the same float32 operands: 3xTF32
# reads at most 2.7e-7 (chip_smoke.py, tests/test_torch_a64_tf32.py), one
# TF32 pass at least 3.1e-5 on the gradients, so the limit tells them
# apart (5e-5, the guard, does not).
A64_LIMIT = 1e-6


def _codon_engine(site, seed, num_taxa, num_trees, rooted, device, dtype,
                  codons=200, distinct=150):
    """An MG94 engine (with `site` rate categories, Weibull or Gamma shape
    0.8) over a synthetic codon alignment: (engine, trees, params)."""
    coll = parse_newick_text(_synthetic.random_trees_newick(
        seed, num_taxa, num_trees, rooted))
    aln = _synthetic.codon_alignment(seed + 1, coll.taxon_names, codons,
                                     distinct)
    eng = TreeLikelihoodEngine(
        CodonSitePattern(aln, coll.taxon_names),
        PhyloModel(PhyloModelSpecification("MG94", site)),
        device=device, dtype=dtype)
    params = dict(MG94) if site == "constant" else dict(
        MG94, site_model_parameters=np.array([0.8]))
    return eng, coll.trees, params_from_numpy(params, device, dtype)


@pytest.mark.parametrize("site,rooted,num_trees,patterns", [
    ("constant", False, 4, None), ("constant", True, 3, 77),
    ("gamma+2", False, 3, None), ("gamma+2", True, 2, 100),
    ("weibull+4", False, 2, 130), ("weibull+4", True, 3, None)])
def test_a64_kernels_match_plain(cuda, site, rooted, num_trees, patterns):
    """Both A=64 kernels at C = 1, 2 and 4 on trifurcating and bifurcating
    roots against their plain versions in float64 on the same float32
    operands (uniformized P, dP = Q P) within A64_LIMIT; `patterns` cuts
    the pattern axis to a width that is not a multiple of a block's
    patterns."""
    eng, trees, params = _codon_engine(site, 3, 9, num_trees, rooted, cuda,
                                       torch.float32)
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, num_trees)
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(
        eig, rates, clock, eng.branch_length_matrix(trees, enc),
        Q=eng._rate_Q(params))
    assert P.shape[-1] == 64 and P.shape[2] == eng.model.category_count
    S = patterns or eng.pattern_pad
    tips = eng._kernel_tips[..., :S].contiguous()
    w = eng._kernel_weights[:S].contiguous()
    before = [f.launches for f in A64]
    ll = paired.paired_log_likelihoods(dst, tip, e, P, tips, pi, prop, w)
    ll2, g = paired.paired_ll_and_gradients(dst, tip, src, e, mask, P, dP,
                                            tips, pi, prop, w)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(A64, before)] == [1, 1]
    ll_ref, g_ref = paired.paired_ll_and_gradients_ref(
        dst, tip, src, e, mask, *_f64(P, dP, tips, pi, prop, w))
    assert _rel(ll, ll_ref) < A64_LIMIT and _rel(ll2, ll_ref) < A64_LIMIT
    assert _norm(g, g_ref) < A64_LIMIT


def _a64_operands(eng, trees, params):
    """The paired A=64 grad kernel's float32 operands from the engine's
    own prep (uniformized P, dP = Q P)."""
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(
        eig, rates, clock, eng.branch_length_matrix(trees, enc),
        Q=eng._rate_Q(params))
    return (dst, tip, src, e, mask, P, dP, eng._kernel_tips, pi, prop,
            eng._kernel_weights)


def test_a64_kernels_take_three_tf32_passes(cuda):
    """The grad kernel's gradients lie nearer to the 3xTF32 emulation
    (paired.paired_ll_and_gradients_tf32 on the CPU) than to the same walk
    with one TF32 pass, on the same float32 operands."""
    eng, trees, params = _codon_engine("gamma+2", 4, 8, 2, False, cuda,
                                       torch.float32)
    ops = _a64_operands(eng, trees, params)
    _, g = paired.paired_ll_and_gradients(*ops)
    cpu = [x.cpu() for x in ops]
    _, g3 = paired.paired_ll_and_gradients_tf32(*cpu)
    _, g1 = paired.paired_ll_and_gradients_tf32(*cpu, passes=1)
    g = g.cpu()
    assert _norm(g, g3) < 0.1 * _norm(g, g1)


@pytest.mark.parametrize("branch_length", [1e-6, 1e-8])
def test_a64_kernels_keep_float32_range(cuda, branch_length):
    """Tips whose cherries differ at all three codon positions, every
    branch `branch_length` long (_synthetic.disagreeing_codons): each
    cherry's partial is near the cube of the length, so a product of two
    children's scales leaves float32.  Both kernels stay finite and within
    A64_LIMIT of their float64 plain versions."""
    newick, aln = _synthetic.disagreeing_codons(0, 4, 64, branch_length)
    coll = parse_newick_text(newick)
    eng = TreeLikelihoodEngine(
        CodonSitePattern(aln, coll.taxon_names),
        PhyloModel(PhyloModelSpecification("MG94", "constant")),
        device=cuda, dtype=torch.float32)
    params = params_from_numpy(dict(MG94), cuda, torch.float32)
    ops = _a64_operands(eng, coll.trees, params)
    before = [f.launches for f in A64]
    ll = paired.paired_log_likelihoods(*ops[:2], ops[3], ops[5], *ops[7:])
    ll2, g = paired.paired_ll_and_gradients(*ops)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(A64, before)] == [1, 1]
    ll_ref, g_ref = paired.paired_ll_and_gradients_ref(
        *ops[:5], *_f64(*ops[5:]))
    assert all(bool(torch.isfinite(x).all()) for x in (ll, ll2, g))
    assert _rel(ll, ll_ref) < A64_LIMIT and _rel(ll2, ll_ref) < A64_LIMIT
    assert _norm(g, g_ref) < A64_LIMIT


def test_engine_auto_takes_the_a64_kernels(cuda):
    """auto on the card in float32 with a shared MG94 model takes the two
    A=64 kernels and no other, and agrees with the float64 engine on the
    CPU (the uniformized scan tape)."""
    eng, trees, params = _codon_engine("constant", 7, 8, 4, False, cuda,
                                       torch.float32)
    ref, _, ref_params = _codon_engine("constant", 7, 8, 4, False, "cpu",
                                       torch.float64)
    before, others = [f.launches for f in A64], [f.launches for f in PAIRED]
    ll = eng.log_likelihoods(trees, params)
    ll2, g = eng.ll_and_branch_gradients(trees, params)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(A64, before)] == [1, 1]
    assert _launched(others) == [0, 0, 0, 0]
    ll_ref, g_ref = ref.ll_and_branch_gradients(trees, ref_params)
    assert _rel(ll.cpu(), ll_ref) < 5e-5 and _rel(ll2.cpu(), ll_ref) < 5e-5
    assert _norm(g.cpu(), g_ref) < 5e-5


def test_float32_codon_scan_refuses_tf32(cuda):
    """The float32 scan tape at 64 states raises while TF32 matmuls are
    allowed, and runs once they are not."""
    eng, trees, params = _codon_engine("constant", 7, 8, 2, False, cuda,
                                       torch.float32)
    eng.kernel = "scan"
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            eng.log_likelihoods(trees, params)
        with pytest.raises(RuntimeError, match="allow_tf32"):
            eng.ll_and_branch_gradients(trees, params)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert bool(torch.isfinite(eng.ll_and_branch_gradients(trees,
                                                           params)[1]).all())


@pytest.mark.parametrize("C", [9, 16, 32, 33, 64])
@pytest.mark.parametrize("scale", [1.0, 1e-6], ids=["bl", "bl1e-6"])
def test_a64_kernels_past_8_categories_match_plain(cuda, C, scale):
    """Both A=64 kernels at MG94+Gamma9/16/32 (before, they refused a 9th
    category) and 33/64 (before, a 33rd) on 9 taxa x 3 trees, at the
    branch lengths and at those times 1e-6, against their plain versions
    in float64 on the same float32 operands within A64_LIMIT."""
    eng, trees, params = _codon_engine(f"gamma+{C}", 3, 9, 3, False, cuda,
                                       torch.float32)
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(
        eig, rates, clock, eng.branch_length_matrix(trees, enc) * scale,
        Q=eng._rate_Q(params))
    assert P.shape[2] == C
    tips, w = eng._kernel_tips, eng._kernel_weights
    before = [f.launches for f in A64]
    ll = paired.paired_log_likelihoods(dst, tip, e, P, tips, pi, prop, w)
    ll2, g = paired.paired_ll_and_gradients(dst, tip, src, e, mask, P, dP,
                                            tips, pi, prop, w)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(A64, before)] == [1, 1]
    ll_ref, g_ref = paired.paired_ll_and_gradients_ref(
        dst, tip, src, e, mask, *_f64(P, dP, tips, pi, prop, w))
    assert all(bool(torch.isfinite(x).all()) for x in (ll, ll2, g))
    assert _rel(ll, ll_ref) < A64_LIMIT and _rel(ll2, ll_ref) < A64_LIMIT
    assert _norm(g, g_ref) < A64_LIMIT


def test_engine_auto_takes_the_a64_kernels_at_16_categories(cuda):
    """auto on the card in float32 at MG94+Gamma16 takes the two A=64
    kernels (before, it took the scan tape past 8 categories) and agrees
    with the float64 engine on the CPU within 5e-5; at 33 categories auto
    takes them too (before, the scan tape), within 5e-5."""
    eng, trees, params = _codon_engine("gamma+16", 7, 8, 4, False, cuda,
                                       torch.float32)
    ref, _, ref_params = _codon_engine("gamma+16", 7, 8, 4, False, "cpu",
                                       torch.float64)
    assert eng._route(True) == "paired"
    before, others = [f.launches for f in A64], [f.launches for f in PAIRED]
    ll = eng.log_likelihoods(trees, params)
    ll2, g = eng.ll_and_branch_gradients(trees, params)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(A64, before)] == [1, 1]
    assert _launched(others) == [0, 0, 0, 0]
    ll_ref, g_ref = ref.ll_and_branch_gradients(trees, ref_params)
    assert _rel(ll.cpu(), ll_ref) < 5e-5 and _rel(ll2.cpu(), ll_ref) < 5e-5
    assert _norm(g.cpu(), g_ref) < 5e-5
    wide, trees, params = _codon_engine("gamma+33", 7, 8, 2, False, cuda,
                                        torch.float32)
    ref, _, ref_params = _codon_engine("gamma+33", 7, 8, 2, False, "cpu",
                                       torch.float64)
    assert wide._route(True) == "paired"
    before = [f.launches for f in A64]
    ll = wide.log_likelihoods(trees, params)
    ll2, g = wide.ll_and_branch_gradients(trees, params)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(A64, before)] == [1, 1]
    ll_ref, g_ref = ref.ll_and_branch_gradients(trees, ref_params)
    assert _rel(ll.cpu(), ll_ref) < 5e-5 and _rel(ll2.cpu(), ll_ref) < 5e-5
    assert _norm(g.cpu(), g_ref) < 5e-5


def test_a64_tree_slices_give_the_rows_of_one_launch(cuda, monkeypatch):
    """On a card that holds the scratch of two trees
    (paired.a64_tree_bytes), its allocation and paired.scratch_budget faked,
    5 trees at MG94+Gamma9 take three launches of each A=64 kernel, over
    paired.tree_slices under that budget, whose rows are bit-equal to one
    launch's; a budget under one tree raises before any launch."""
    eng, trees, params = _codon_engine("gamma+9", 3, 9, 5, False, cuda,
                                       torch.float32)
    dst, tip, src, e, mask, P, dP, tips, pi, prop, w = _a64_operands(
        eng, trees, params)
    tree = paired.a64_tree_bytes(dst.shape[1], tips.shape[-1], 9)
    whole = (paired.paired_ll_a64(dst, tip, e, P, tips, pi, prop),
             *paired.paired_grad_a64(dst, tip, src, e, P, dP, tips, pi,
                                     prop, w))

    allocate = paired._a64_scratch

    def under(budget):
        """A card on which `budget` bytes of scratch fit."""
        def scratch(B, M, S, C, device):
            if B * paired.a64_tree_bytes(M, S, C) > budget:
                raise torch.cuda.OutOfMemoryError("the card is full")
            return allocate(B, M, S, C, device)

        monkeypatch.setattr(paired, "_a64_scratch", scratch)
        monkeypatch.setattr(paired, "scratch_budget", lambda device: budget)

    before = [f.launches for f in A64]
    under(2 * tree + tree // 2)
    sliced = (paired.paired_ll_a64(dst, tip, e, P, tips, pi, prop),
              *paired.paired_grad_a64(dst, tip, src, e, P, dP, tips, pi,
                                      prop, w))
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(A64, before)] == [3, 3]
    for a, b in zip(whole, sliced):
        assert torch.equal(a, b)
    under(tree - 1)
    with pytest.raises(torch.cuda.OutOfMemoryError, match="bytes a tree"):
        paired.paired_ll_a64(dst, tip, e, P, tips, pi, prop)
    assert [f.launches - n for f, n in zip(A64, before)] == [3, 3]


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


def _codon_pernode_operands(site, rooted, num_trees, patterns, device):
    """An MG94 case's per-node operands in float32 on the card (the
    engine's uniformized P, dP = Q P), the pattern axis cut to
    `patterns`: (enc, post, pre, root, mask, P, dP, tips, pi, prop, w)."""
    eng, trees, params = _codon_engine(site, 5, 8, num_trees, rooted, device,
                                       torch.float32)
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, num_trees)
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(
        eig, rates, clock, eng.branch_length_matrix(trees, enc),
        Q=eng._rate_Q(params))
    S = patterns or eng.pattern_pad
    tips = eng._kernel_tips[..., :S].contiguous()
    w = eng._kernel_weights[:S].contiguous()
    post, pre, root = _pernode_tapes(enc, device)
    mask = torch.as_tensor(enc.edge_mask, dtype=torch.float32, device=device)
    return enc, post, pre, root, mask, P, dP, tips, pi, prop, w


@pytest.mark.parametrize("site,rooted,num_trees,patterns", [
    ("constant", False, 3, None), ("gamma+2", True, 2, 77),
    ("weibull+4", False, 2, 130), ("gamma+16", True, 2, None)])
def test_pernode_a64_functions_match_plain(cuda, site, rooted, num_trees,
                                           patterns):
    """pernode_log_likelihoods and pernode_ll_and_gradients at 64 states
    launch the paired A=64 kernels (one launch each, no per-node body) and
    agree with their plain versions in float64 on the same float32
    operands within A64_LIMIT, with and without the tape given."""
    enc, post, pre, root, mask, P, dP, tips, pi, prop, w = (
        _codon_pernode_operands(site, rooted, num_trees, patterns, cuda))
    tape = pernode.a64_tape(enc.post_ops, enc.root, enc.num_taxa,
                            enc.num_slots, cuda, pre_ops=enc.pre_ops)
    ll_ref, g_ref = pernode.pernode_ll_and_gradients_ref(
        post, pre, root, mask, *_f64(P, dP, tips, pi, prop, w))
    for onchip in (None, tape):
        before = [f.launches for f in A64]
        others = [f.launches for f in PERNODE]
        ll = pernode.pernode_log_likelihoods(post, root, P, tips, pi, prop, w,
                                             onchip=onchip)
        ll2, g = pernode.pernode_ll_and_gradients(
            post, pre, root, mask, P, dP, tips, pi, prop, w, onchip=onchip)
        torch.cuda.synchronize()
        assert [f.launches - n for f, n in zip(A64, before)] == [1, 1]
        assert _pernode_launched(others) == [0, 0, 0, 0]
        assert _rel(ll, ll_ref) < A64_LIMIT and _rel(ll2, ll_ref) < A64_LIMIT
        assert _norm(g, g_ref) < A64_LIMIT


def test_pernode_a64_raises_without_falling_back(cuda):
    """At 64 states the per-node functions raise on a tape that is not the
    operands' a64_tape, on a grad tape derived without pre_ops, on a
    preorder of another tree and on operands the kernels do not take (no
    rate category), before any launch."""
    enc, post, pre, root, mask, P, dP, tips, pi, prop, w = (
        _codon_pernode_operands("constant", False, 2, None, cuda))
    args = (post, pre, root, mask, P, dP, tips, pi, prop, w)
    before = [f.launches for f in A64]
    with pytest.raises(ValueError, match="a64_tape"):
        pernode.pernode_log_likelihoods(
            post, root, P, tips, pi, prop, w, onchip=pernode.ll_tape(
                enc.post_ops, enc.root, enc.num_taxa, enc.num_slots, cuda))
    with pytest.raises(ValueError, match="pre_ops"):
        pernode.pernode_ll_and_gradients(*args, onchip=pernode.a64_tape(
            enc.post_ops, enc.root, enc.num_taxa, enc.num_slots, cuda))
    swapped = pre[[1, 0]].contiguous()  # the other tree's preorder
    with pytest.raises(ValueError, match="parent"):
        pernode.pernode_ll_and_gradients(post, swapped, *args[2:])
    with pytest.raises(TypeError):
        pernode.pernode_ll_and_gradients(*args[:4], P.double(), dP.double(),
                                         *args[6:])
    with pytest.raises(ValueError, match="1 or more rate categories"):
        pernode.pernode_log_likelihoods(
            post, root, P[:, :, :0].contiguous(), tips, pi, prop[:0], w)
    assert [f.launches for f in A64] == before


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
    on-chip bodies on the bifurcating root, and its gradients' P and dP
    the prep kernel."""
    card, cpu = _rooted_instances(tmp_path, spec, cuda)
    before = [w.launches for w in PAIRED + (prep.transition_prep,)]
    ll = card.log_likelihoods()
    ll0 = card.log_likelihoods(include_log_det_jacobian=False)
    pgs = card.phylo_gradients()
    torch.cuda.synchronize()
    launched = {w.__name__: w.launches - b
                for w, b in zip(PAIRED + (prep.transition_prep,), before)}
    assert launched == {"paired_ll_onchip": 2, "paired_ll_global": 0,
                        "paired_grad_onchip": 1, "paired_grad_global": 0,
                        "transition_prep": 1}
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


# ---------------------------------------------------------------------------
# The pattern-sharded engines and the leveled variant on the card
# ---------------------------------------------------------------------------
def test_two_gloo_ranks_shard_the_kernels_on_one_card(cuda, tmp_path):
    """chip_smoke.py's dist worker on two ranks of one card over Gloo, as
    dist.launch starts it: the flagship's auto (rows 1-2) and chunked (rows
    3-4) routes within 5e-5 and the codon shape's auto (rows 1b-2b) within
    1e-6 of the unsharded float64 tape, the route's kernels launched on
    every rank, the same results on both ranks, and the GP engine within
    1e-9 of the unsharded one (the worker checks; any failure exits it
    non-zero)."""
    import json
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "bito_tpu_torch.dist.launch", "-n", "2",
         "--backend", "gloo", "--device", "cuda", "--stall-timeout", "120",
         "--hard-timeout", "600", str(root / "chip_smoke.py"),
         "--dist-worker", "gloo", str(tmp_path)],
        cwd=root, capture_output=True, text=True, timeout=660)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    ranks = [json.loads((tmp_path / f"gloo.{r}.json").read_text())
             for r in range(2)]
    for r in ranks:
        assert r["backend"] == "gloo" and r["size"] == 2
        assert max(r["auto"]["errs"]) <= 5e-5
        assert max(r["chunked"]["errs"]) <= 5e-5
        assert max(r["codon"]["errs"]) <= 1e-6
        assert all(n > 0 for n in r["codon"]["launches"].values())
        assert max(r["gp"]["errs"]) <= 1e-9


def test_launcher_refuses_nccl_for_more_ranks_than_cards(cuda, tmp_path):
    """NCCL takes one card a rank: asked for one rank more than the visible
    cards, the launcher exits before any worker starts."""
    from bito_tpu_torch.dist import launch

    marker = tmp_path / "started"
    script = tmp_path / "worker.py"
    script.write_text(f"open({str(marker)!r}, 'w').close()\n")
    with pytest.raises(SystemExit) as exc:
        launch.main(["-n", str(torch.cuda.device_count() + 1), "--backend",
                     "nccl", "--device", "cuda", str(script)])
    assert "NCCL takes one card a rank" in str(exc.value.code)
    assert not marker.exists()


@pytest.mark.parametrize("rooted", [False, True])
def test_leveled_variant_on_the_card_matches_the_scan_tape(cuda, rooted):
    """use_leveled in float64 on the card: LL and branch gradients within
    1e-10 of the scan tape (relative and of the largest gradient), with no
    kernel launched."""
    eng, trees, params = _engine("gtr_gamma4", 21, 16, 8, rooted, cuda,
                                 torch.float64)
    eng.kernel = "scan"
    ll_s, g_s = eng.ll_and_branch_gradients(trees, params)
    eng.use_leveled = True
    before = paired.paired_ll_onchip.launches
    ll_l = eng.log_likelihoods(trees, params)
    ll_g, g_l = eng.ll_and_branch_gradients(trees, params)
    assert paired.paired_ll_onchip.launches == before
    for ll in (ll_l, ll_g):
        assert ((ll - ll_s).abs() / ll_s.abs()).max().item() <= 1e-10
    assert ((g_l - g_s).abs().max() / g_s.abs().max()).item() <= 1e-10


def test_graft_entry_forward_takes_the_onchip_ll_kernel(cuda):
    """entry() defaults to the card in float32, and its forward launches
    the paired on-chip LL body once a call and no other paired body; its
    LLs within 5e-5 of the float64 plain version (entry on the CPU) on the
    same inputs."""
    fn, args = graft_entry.entry()
    assert all(a.device.type == "cuda" and a.dtype == torch.float32
               for a in args)
    before = [f.launches for f in PAIRED]
    ll = fn(*args)
    torch.cuda.synchronize()
    assert _launched(before) == [1, 0, 0, 0]
    fn64, _ = graft_entry.entry(device="cpu")
    ref = fn64(*[a.cpu().double() for a in args])
    assert ll.shape == (4,) and torch.isfinite(ll).all()
    assert _rel(ll.cpu(), ref) <= 5e-5


# -- the program's spans and counters on the card (utils/timing.py) --------

def _traced_engine(model, cuda):
    """The flagship (GTR+Gamma4) or the codon path (MG94), at DS1's 27
    taxa, on auto in float32: (engine, trees, params, branch lengths)."""
    if model == "gtr_gamma4":
        eng, trees, params = _flagship_engine(20, cuda, torch.float32)
    else:
        eng, trees, params = _codon_engine("constant", 5, 27, 16, False,
                                           cuda, torch.float32)
    bl = eng.branch_length_matrix(trees, eng.encode(trees))
    return eng, trees, params, bl


def _bound(eng, trees, params, entry):
    if entry == "branch_eval":
        return eng.branch_eval_fn(trees, params)
    return eng.ll_eval_fn(trees, params)


@pytest.mark.parametrize("entry", ["branch_eval", "ll_eval"])
@pytest.mark.parametrize("model", ["gtr_gamma4", "mg94"])
def test_sync_debug_warnings_of_a_call_are_its_host_syncs(cuda, model,
                                                           entry):
    """torch's sync debug mode over one call warns once for each host
    sync the call counts, each inside a `host_sync` span.  The flagship's
    closure makes none; the codon closure reads q t and q and copies q
    back.  The LL closure rebuilds the model every call: at the flagship
    GTR's two index copies, eigh's error code and the Gamma rates' series
    length (4); on the codon path the host eigensystem's three reads and
    four copies back, Q's four mask copies and its padding's three, and
    the three of P (17)."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from bito_tpu_torch.utils import timing

    eng, trees, params, bl = _traced_engine(model, cuda)
    fn = _bound(eng, trees, params, entry)
    fn(bl)
    torch.cuda.synchronize()
    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            open_spans = timing._session.open
            seen.append((f"{filename}:{lineno}",
                         open_spans[-1].name if open_spans else None))

    with profile(activities=[ProfilerActivity.CUDA]):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn(bl)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    records = timing.recorded()
    assert [r.name for r in records if r.parent is None] == ["eval"]
    syncs = sum(r.counts.get("host_syncs", 0) for r in records)
    expected = {("gtr_gamma4", "branch_eval"): 0, ("gtr_gamma4", "ll_eval"): 4,
                ("mg94", "branch_eval"): 3, ("mg94", "ll_eval"): 17}
    assert syncs == len(seen) == expected[model, entry], seen
    assert all(name == "host_sync" for _, name in seen), seen


@pytest.mark.parametrize("model", ["gtr_gamma4", "mg94"])
def test_tree_kernel_launches_lie_inside_launch_spans(cuda, tmp_path,
                                                      model):
    """In device_trace's Chrome trace of a few calls, the CUDA runtime's
    launch of every tree kernel lies inside an exported `launch` span
    (within 20 us: the spans' map onto the trace's clock)."""
    import json

    from bito_tpu_torch.utils import timing

    eng, trees, params, bl = _traced_engine(model, cuda)
    fn = eng.branch_eval_fn(trees, params)
    fn(bl)
    torch.cuda.synchronize()
    with timing.device_trace(str(tmp_path)):
        for _ in range(3):
            fn(bl)
        torch.cuda.synchronize()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "bito_tpu_torch" and e["name"] == "launch"]
    tree = {e["args"]["correlation"] for e in events
            if e.get("cat") == "kernel" and "paired_" in e.get("name", "")}
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and e.get("args", {}).get("correlation") in tree]
    assert len(spans) == 3 and len(launches) == len(tree) == 3
    for e in launches:
        assert any(a - 20 <= e["ts"] and e["ts"] + e["dur"] <= b + 20
                   for a, b in spans), (e, spans)


def test_large_trees_take_the_checkpointed_grad_body_within_rbcl500s_limits(
        cuda):
    """branch_eval_fn on random 200-taxon trees (the rbcL 500
    configuration's alignment shape and model, past the grad body's
    on-chip limit) takes the checkpointed grad body, which took the place
    of the global one there: one launch a call and no on-chip or global
    grad launch, within the configuration's limits of the benchmark's
    float64 reference (portbench/reference).  Under a profiler session
    the call records one `checkpoint_launches` inside its `launch` span
    and no `global_launches`; a DS1-sized call, on the on-chip body,
    records neither."""
    import json
    import pathlib

    from torch.profiler import ProfilerActivity, profile

    from bito_tpu_torch.core.tree import Topology, Tree
    from bito_tpu_torch.utils import timing
    from portbench import inputs, reference
    from portbench.reference import patterns

    config = json.loads((pathlib.Path(__file__).resolve().parents[1]
                         / "portbench/configs/rbcl500_gtr_gamma4.json")
                        .read_text())
    config.update(taxa=200, trees=8, topologies=8)
    inp = inputs.make_inputs(config, 2147483659, 16)
    eng = TreeLikelihoodEngine(
        SitePattern(inp.alignment, inp.names),
        PhyloModel(PhyloModelSpecification("GTR", "gamma+4")),
        device=cuda, dtype=torch.float32)
    trees = [Tree(Topology(p, 200), t)
             for p, t in zip(inp.trees.parents, inp.trees.lengths)]
    params = {k: torch.tensor(v, dtype=torch.float64, device=cuda)
              for k, v in config["params"].items()}
    fn = eng.branch_eval_fn(trees, params)
    base = torch.as_tensor(inp.trees.lengths, device=cuda,
                           dtype=torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(5)
    bl = base * torch.exp(0.1 * torch.randn(base.shape, generator=gen,
                                            device=cuda))
    before = [f.launches for f in PAIRED + (paired.paired_grad_ckpt,)]
    ll, g = fn(bl)
    fn(bl)
    torch.cuda.synchronize()
    assert _launched(before) == [0, 0, 0, 0, 2]
    tips, w = patterns.site_patterns(inp.alignment, inp.names, "nucleotide")
    ref_ll, ref_g = reference.evaluate(reference.model_of(config), tips, w,
                                       inp.trees.parents, bl.double())
    ll_err = float(((ll.double() - ref_ll).abs() / ref_ll.abs()).max())
    grad_err = float(((g.double() - ref_g).abs().amax(1)
                      / ref_g.abs().amax(1)).max())
    assert ll_err <= config["limits"]["ll_err"], ll_err
    assert grad_err <= config["limits"]["grad_err"], grad_err
    with profile(activities=[ProfilerActivity.CUDA]):
        fn(bl)
        torch.cuda.synchronize()
    counted = ("checkpoint_launches", "global_launches")
    counts = {r.name: [r.counts.get(c, 0) for c in counted]
              for r in timing.recorded()}
    assert counts["launch"] == [1, 0], counts
    assert [sum(n) for n in zip(*counts.values())] == [1, 0], counts
    eng, trees, params, bl = _traced_engine("gtr_gamma4", cuda)
    fn = eng.branch_eval_fn(trees, params)
    before = [f.launches for f in PAIRED + (paired.paired_grad_ckpt,)]
    with profile(activities=[ProfilerActivity.CUDA]):
        fn(bl)
        torch.cuda.synchronize()
    assert _launched(before) == [0, 0, 1, 0, 0]
    assert not any(c in r.counts for r in timing.recorded()
                   for c in counted)


# -- the paired route's prep (models/csrc/transition_prep.cu) --------------

def _prep_operands(C, per_tree, device, B=400, num_taxa=27):
    """The paired route's prep operands at the flagship's shape (B trees,
    N = 2 * 27 - 2 slots), in the rooted oracle's regime: GTR+Gamma(C) at
    shape 0.1 (the slowest category's rate 1e-8 at C = 4), every tree's
    first branch 0 and its second 0.0005 substitutions, the rest log-normal
    about 0.1.  Shared: one row expanded over the trees (tree stride 0),
    clock 1; per-tree: GTR rates, frequencies and shape a row a tree, and
    clock rates 0.5-2."""
    gen = np.random.default_rng(11 + C + 100 * per_tree)
    N = 2 * num_taxa - 2
    model = PhyloModel(PhyloModelSpecification("GTR", f"gamma+{C}"))
    kw = dict(device=device, dtype=torch.float64)
    rows = B if per_tree else 1
    rates6 = gen.uniform(0.5, 2.0, (rows, 6))
    freqs = gen.uniform(0.15, 0.35, (rows, 4))
    shape = np.full((rows, 1), 0.1) if not per_tree else gen.uniform(
        0.1, 1.0, (rows, 1))
    vals = {"substitution_model_rates": torch.as_tensor(
                rates6 / rates6.sum(-1, keepdims=True), **kw),
            "substitution_model_frequencies": torch.as_tensor(
                freqs / freqs.sum(-1, keepdims=True), **kw),
            "site_model_parameters": torch.as_tensor(shape, **kw)}
    eig = model.eigen(vals, **kw)
    rates = model.category_rates(vals, **kw)
    if not per_tree:
        eig = EigenDecomp(*(x.expand((B,) + x.shape[1:]) for x in eig))
        rates = rates.expand(B, C)
    clock = (torch.as_tensor(gen.uniform(0.5, 2.0, B), **kw) if per_tree
             else torch.ones((), **kw).expand(B))
    bl = np.exp(gen.normal(np.log(0.1), 1.0, (B, N)))
    bl[:, 0], bl[:, 1] = 0.0, 0.0005
    return eig, rates, clock, torch.as_tensor(bl, dtype=torch.float32,
                                              device=device)


def _within_one_ulp(a, b, tiny=4e-16):
    """Each entry of float32 a within one float32 ulp of b's, or within
    `tiny` absolute (where float64 rounding of O(1) terms decides an entry
    near 0, clamped or not)."""
    a64, b64 = a.double(), b.double()
    big = torch.maximum(a.abs(), b.abs())
    ulp = (torch.nextafter(big, torch.full_like(big, float("inf"))) - big
           ).double()
    diff = (a64 - b64).abs()
    bad = (diff > ulp) & (diff > tiny)
    return bad.sum().item(), diff.max().item()


@pytest.mark.parametrize("per_tree", [False, True], ids=["shared", "rows"])
@pytest.mark.parametrize("C", [1, 4, 16, 33, 64])
def test_transition_prep_matches_the_torch_ops(cuda, C, per_tree):
    """The prep kernel's P and dP against the torch ops on the same
    operands on the card (prep.transition_prep_plain, the route before
    it): at 400 trees x 27 taxa, every entry within one float32 ulp, or
    within 4e-16 absolute; row N exactly the identity and zero."""
    eig, rates, clock, bl = _prep_operands(C, per_tree, cuda)
    before = prep.transition_prep.launches
    P, dP = prep.transition_prep(eig, rates, clock, bl)
    P0, dP0 = prep.transition_prep_plain(eig, rates, clock, bl)
    torch.cuda.synchronize()
    assert prep.transition_prep.launches == before + 1
    B, N = bl.shape
    assert P.shape == dP.shape == (B, N + 1, C, 4, 4)
    assert P.is_contiguous() and dP.is_contiguous()
    assert P.dtype == dP.dtype == torch.float32
    assert _within_one_ulp(P, P0)[0] == 0, _within_one_ulp(P, P0)
    assert _within_one_ulp(dP, dP0)[0] == 0, _within_one_ulp(dP, dP0)
    eye = torch.eye(4, device=cuda).expand(B, C, 4, 4)
    assert torch.equal(P[:, N], eye) and not dP[:, N].any()
    assert torch.isfinite(P).all() and (P >= 0).all()


def test_transition_prep_reads_float64_branch_lengths(cuda):
    """graft_entry's training step hands the prep float64 branch lengths:
    the kernel reads them as they are, as the torch ops do."""
    eig, rates, clock, bl = _prep_operands(4, False, cuda, B=16)
    bl = bl.double() * (1 + 1e-3)
    P, dP = prep.transition_prep(eig, rates, clock, bl)
    P0, dP0 = prep.transition_prep_plain(eig, rates, clock, bl)
    assert _within_one_ulp(P, P0)[0] == 0
    assert _within_one_ulp(dP, dP0)[0] == 0


def test_engine_calls_launch_the_prep_kernel_once(cuda):
    """One branch_eval_fn call of a float32 GTR+Gamma4 engine on the card
    (auto, the paired route) launches the prep kernel once; the codon
    engine's (a shared Q, the uniformized route) and a float64 prep on the
    card launch it zero times, and the latter gives the torch ops'
    operands."""
    eng, trees, params = _engine("gtr_gamma4", 3, 27, 8, False, cuda,
                                 torch.float32)
    enc = eng.encode(trees)
    bl = eng.branch_length_matrix(trees, enc)
    fn = eng.branch_eval_fn(trees, params)
    fn(bl)
    torch.cuda.synchronize()
    before = prep.transition_prep.launches
    fn(bl)
    torch.cuda.synchronize()
    assert prep.transition_prep.launches == before + 1

    codon, ctrees, cparams = _codon_engine("constant", 7, 8, 4, False, cuda,
                                           torch.float32)
    cfn = codon.branch_eval_fn(ctrees, cparams)
    cbl = codon.branch_length_matrix(ctrees, codon.encode(ctrees))
    before = prep.transition_prep.launches
    cfn(cbl)
    eig, rates, _, clock = eng._model_ingredients(params, len(trees))
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl, torch.float64)
    P0, dP0 = prep.transition_prep_plain(eig, rates, clock, bl,
                                         torch.float64)
    torch.cuda.synchronize()
    assert prep.transition_prep.launches == before
    assert P.dtype == torch.float64
    assert torch.equal(P, P0) and torch.equal(dP, dP0)


@pytest.mark.parametrize("case", ["int32", "float16", "A64"])
def test_transition_prep_refuses_on_the_card(cuda, case):
    """On the card the launcher raises, and launches nothing, for branch
    lengths that are not float32 / float64 and for a 64-state eigensystem
    forced into it with Q None."""
    eig, rates, clock, bl = _prep_operands(4, False, cuda, B=8)
    if case == "int32":
        bl = bl.int()
    elif case == "float16":
        bl = bl.half()
    else:
        eig = EigenDecomp(
            torch.eye(64, dtype=torch.float64, device=cuda).expand(8, 64, 64),
            torch.zeros((8, 64), dtype=torch.float64, device=cuda),
            torch.eye(64, dtype=torch.float64, device=cuda).expand(8, 64, 64),
            torch.full((8, 64), 1 / 64, dtype=torch.float64, device=cuda))
    before = prep.transition_prep.launches
    with pytest.raises((ValueError, TypeError)):
        prep.transition_prep(eig, rates, clock, bl)
    assert prep.transition_prep.launches == before


def test_sliced_branch_lengths_take_the_prep_kernel(cuda):
    """Branch lengths that are a slice of a wider buffer (not contiguous)
    go through the prep kernel as they lie, read through their strides:
    its P and dP equal those of a contiguous copy, and a flagship
    engine's branch_eval_fn and ll_and_branch_gradients give the copy's
    LL and gradients bit for bit, one prep launch a call.  float16
    branch lengths in the closure take the torch ops, as before the
    kernel."""
    eig, rates, clock, bl = _prep_operands(4, True, cuda, B=16)
    sliced = torch.cat([bl, 2 * bl], 1)[:, :bl.shape[1]]
    assert not sliced.is_contiguous()
    for a, b in zip(prep.transition_prep(eig, rates, clock, sliced),
                    prep.transition_prep(eig, rates, clock, bl)):
        assert torch.equal(a, b)

    eng, trees, params = _engine("gtr_gamma4", 3, 27, 8, False, cuda,
                                 torch.float32)
    bl = eng.branch_length_matrix(trees, eng.encode(trees))
    sliced = torch.cat([bl, bl + 1], 1)[:, :bl.shape[1]]
    fn = eng.branch_eval_fn(trees, params)
    before = prep.transition_prep.launches
    outs = [fn(sliced), fn(bl),
            eng.ll_and_branch_gradients(trees, params,
                                        branch_lengths=sliced)]
    torch.cuda.synchronize()
    assert prep.transition_prep.launches == before + 3
    for out in outs[::2]:
        assert all(torch.equal(x, y) for x, y in zip(out, outs[1]))
    ll16, g16 = fn(bl.half())
    torch.cuda.synchronize()
    assert prep.transition_prep.launches == before + 3
    assert _rel(ll16, outs[1][0]) <= 1e-3
