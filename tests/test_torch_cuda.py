"""The CUDA kernels on the card, against their plain torch versions.

Every test here needs an NVIDIA card and is marked `cuda`; where no card
is visible each skips.  The file imports neither jax nor bito_tpu, so it
runs on a machine without them; the repository's tests/conftest.py imports
jax, so run it there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Bounds, as bench.py's on-device guard: float32 kernel against the float64
plain version within 5e-5 relative on log likelihoods and 5e-5 of the
largest gradient."""
import numpy as np
import pytest
import torch

from bito_tpu_torch import _synthetic
from bito_tpu_torch.convert import params_from_numpy
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.core.site_pattern import SitePattern
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.treelike import paired, prep
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

pytestmark = pytest.mark.cuda

GTR = _synthetic.GTR_GAMMA4_PARAMS
MODELS = {
    "gtr_gamma4": (("GTR", "gamma+4"), GTR),
    "jc69": (("JC69", "constant"), {}),
    "hky_weibull3": (("HKY", "weibull+3"), {
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


@pytest.mark.parametrize("model,rooted,num_trees,patterns", [
    ("gtr_gamma4", False, 5, None), ("gtr_gamma4", True, 3, 150),
    ("jc69", False, 4, 200), ("hky_weibull3", True, 2, None)])
def test_kernels_match_plain(cuda, model, rooted, num_trees, patterns):
    """Both kernels against their plain versions in float64 on the same
    float32 operands; `patterns` cuts the pattern axis to a width that is
    not a multiple of the block."""
    eng, trees, params = _engine(model, 3, 11, num_trees, rooted, cuda,
                                 torch.float32)
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, num_trees)
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock,
                                       eng.branch_length_matrix(trees, enc))
    S = patterns or eng.pattern_pad
    tips = eng._kernel_tips[..., :S].contiguous()
    w = eng._kernel_weights[:S].contiguous()
    ll = paired.paired_log_likelihoods(dst, tip, e, P, tips, pi, prop, w)
    ll2, g = paired.paired_ll_and_gradients(dst, tip, src, e, mask, P, dP,
                                            tips, pi, prop, w)
    torch.cuda.synchronize()
    d = torch.float64
    ll_ref, g_ref = paired.paired_ll_and_gradients_ref(
        dst, tip, src, e, mask, P.to(d), dP.to(d), tips.to(d), pi.to(d),
        prop.to(d), w.to(d))
    assert _rel(ll, ll_ref) < 5e-5 and _rel(ll2, ll_ref) < 5e-5
    assert _norm(g, g_ref) < 5e-5


def test_engine_takes_the_kernels(cuda):
    """auto on the card takes both kernels for a shared model in float32,
    and agrees with the float64 engine on the CPU (the scan tape)."""
    eng, trees, params = _engine("gtr_gamma4", 7, 9, 4, False, cuda,
                                 torch.float32)
    ref, _, ref_params = _engine("gtr_gamma4", 7, 9, 4, False, "cpu",
                                 torch.float64)
    before = (paired.paired_log_likelihoods.launches,
              paired.paired_ll_and_gradients.launches)
    ll = eng.log_likelihoods(trees, params)
    ll2, g = eng.ll_and_branch_gradients(trees, params)
    assert (paired.paired_log_likelihoods.launches,
            paired.paired_ll_and_gradients.launches) == (before[0] + 1,
                                                         before[1] + 1)
    ll_ref, g_ref = ref.ll_and_branch_gradients(trees, ref_params)
    assert _rel(ll.cpu(), ll_ref) < 5e-5 and _rel(ll2.cpu(), ll_ref) < 5e-5
    assert _norm(g.cpu(), g_ref) < 5e-5


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
