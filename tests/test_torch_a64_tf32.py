"""The arithmetic of the A=64 kernels (csrc/paired_a64.cuh: every 64x64
product in 3xTF32 on the tensor cores) in plain torch on the CPU:
paired.tf32_round rounds as cvt.rna.tf32.f32 does, paired.tf32_mm forms a
product as the kernels do, and paired.paired_ll_and_gradients_tf32 walks
the paired tape with every P p, dP p and P^T o through it.

Cases: MG94 on 6-8 taxa, 128 patterns, C = 1, 2, 9 and 16 (Gamma shape
0.8), trifurcating and bifurcating roots (synthetic codon alignments),
the float32 operands of the engine's own prep (uniformized P, dP = Q P);
and the edge of float32's range (_synthetic.disagreeing_codons: 8 taxa
in cherries whose tips differ at all three codon positions, every branch
1e-6 to 1e-8 long, so that a cherry's partial is near 1e-20 and a walk
that let the scales of two children meet in one product would leave
float32), at C = 1 and at C = 9, where the categories' own powers of two
span the slowest category's and the fastest's.  The three passes are
held there at every branch 1e-6, 1e-7 and 1e-8; the one-pass control
takes all but C = 9 at 1e-8, where one TF32 pass lies 3.4e-5 of the
largest gradient from float64, 370 times the three passes' 9.0e-8 but
inside the guard, so that case would not separate the two by the
guard.

Bounds: the 3xTF32 walk within 5e-5 of the float64 plain version (LL
relative, gradients of the largest), the kernels' guard, and within
1e-6 (CARD_LIMIT), the limit that chip_smoke.py and the card tests hold
the kernels to: it reads at most 2.7e-7 here, as the float32 plain
version does.  One TF32 pass (hi hi only) keeps 11 bits of each operand:
on the random cases its gradients lie 3.1e-5 to 5.3e-5 of the largest
from float64, two of the four past the guard (so the guard alone does
not separate the two there), 430-760 times the three passes' error, and
the control asserts 100 times and 1e-5; at the edge of the range they
lie 2.1e-4 to 4.2e-4 off, past the guard in every case."""
import functools

import numpy as np
import pytest
import torch

from bito_tpu_torch import _synthetic
from bito_tpu_torch.convert import params_from_numpy
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.core.site_pattern import CodonSitePattern
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.treelike import paired, prep
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

from torch_port_cases import max_norm, max_rel, one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


BOUND = 5e-5
CARD_LIMIT = 1e-6
MG94 = {"substitution_model_rates": np.array([2.5, 0.3]),
        "substitution_model_frequencies": np.array([0.3, 0.2, 0.3, 0.2])}


def _operands(site, seed, num_taxa, rooted, num_trees=3):
    """The paired A=64 grad kernel's float32 operands on the CPU."""
    coll = parse_newick_text(_synthetic.random_trees_newick(
        seed, num_taxa, num_trees, rooted))
    aln = _synthetic.codon_alignment(seed + 1, coll.taxon_names, 120, 100)
    ops, eng = _kernel_operands(coll, aln, site)
    assert eng.pattern_pad == 128
    return ops


def _kernel_operands(coll, aln, site):
    """(operands, engine) of the paired A=64 grad kernel in float32 on the
    CPU, for the trees of `coll` over the codon alignment `aln`."""
    num_trees = len(coll.trees)
    eng = TreeLikelihoodEngine(
        CodonSitePattern(aln, coll.taxon_names),
        PhyloModel(PhyloModelSpecification("MG94", site)),
        device="cpu", dtype=torch.float32)
    params = params_from_numpy(dict(MG94) if site == "constant" else dict(
        MG94, site_model_parameters=np.array([0.8])), "cpu", torch.float32)
    enc = eng.encode(coll.trees)
    eig, rates, props, clock = eng._model_ingredients(params, num_trees)
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(
        eig, rates, clock, eng.branch_length_matrix(coll.trees, enc),
        Q=eng._rate_Q(params))
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    assert P.shape[-1] == 64
    return (dst, tip, src, e, mask, P, dP, eng._kernel_tips, pi, prop,
            eng._kernel_weights), eng


CASES = {  # id -> (site, seed, taxa, rooted)
    "c1-8-trifurcating": ("constant", 3, 8, False),
    "c1-7-bifurcating": ("constant", 5, 7, True),
    "c2-6-trifurcating": ("gamma+2", 4, 6, False),
    "c2-8-bifurcating": ("gamma+2", 9, 8, True),
    "c9-8-trifurcating": ("gamma+9", 3, 8, False),
    "c9-7-bifurcating": ("gamma+9", 5, 7, True),
    "c16-6-trifurcating": ("gamma+16", 4, 6, False),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    ops = _operands(*CASES[request.param])
    ll64, g64 = paired.paired_ll_and_gradients_ref(
        *[x.double() if x.is_floating_point() else x for x in ops])
    return ops, ll64.numpy(), g64.numpy()


def test_tf32_round_is_cvt_rna():
    """10 explicit mantissa bits, round to nearest, ties away from zero,
    on either sign and on subnormals (2^-137 is a tie of TF32's last
    subnormal bit); exact TF32 values kept."""
    one = 1.0
    cases = {one: one, one + 2**-12: one, one + 2**-11: one + 2**-10,
             one + 3 * 2**-12: one + 2**-10, one + 2**-10: one + 2**-10,
             -(one + 2**-11): -(one + 2**-10), 0.0: 0.0,
             2.0**-130: 2.0**-130, 2.0**-137: 2.0**-136,
             3 * 2.0**-20: 3 * 2.0**-20}
    x = torch.tensor(list(cases), dtype=torch.float32)
    want = torch.tensor(list(cases.values()), dtype=torch.float32)
    torch.testing.assert_close(paired.tf32_round(x), want, rtol=0, atol=0)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi = paired.tf32_round(r)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((r - hi).abs() <= r.abs() * 2**-11).all()


def test_tf32_mm_three_passes_against_one():
    """A 64-deep product of random P-like operands: three passes within
    4e-7 of float64 (relative to the largest output), one pass about 2^-12
    off."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.uniform(0, 1, (32, 64)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-1, 1, (64, 48)).astype(np.float32))
    exact = a.double() @ b.double()
    err3 = max_norm(paired.tf32_mm(a, b).numpy(), exact.numpy())
    err1 = max_norm(paired.tf32_mm(a, b, passes=1).numpy(), exact.numpy())
    assert err3 < 4e-7 and 2e-5 < err1 < 1e-3
    with pytest.raises(ValueError, match="passes"):
        paired.tf32_mm(a, b, passes=2)


def test_three_passes_hold_the_guard(case):
    """The 3xTF32 walk against the float64 plain version: within the
    5e-5 guard, and within 1e-6, the float32 plain version's level."""
    ops, ll64, g64 = case
    ll, g = paired.paired_ll_and_gradients_tf32(*ops)
    assert ll.dtype == g.dtype == torch.float32
    err_ll, err_g = max_rel(ll.numpy(), ll64), max_norm(g.numpy(), g64)
    assert err_ll < BOUND and err_g < BOUND
    assert err_ll < 1e-6 and err_g < 1e-6


def test_one_pass_is_the_control(case):
    """The same walk with one TF32 pass: its LL stays within the guard,
    its gradients are at least 100 times further from float64 than three
    passes' and 1e-5 of the largest or more; dP p cancels, so the
    gradients feel the 11-bit operands first."""
    ops, ll64, g64 = case
    ll3, g3 = paired.paired_ll_and_gradients_tf32(*ops)
    ll1, g1 = paired.paired_ll_and_gradients_tf32(*ops, passes=1)
    err3, err1 = max_norm(g3.numpy(), g64), max_norm(g1.numpy(), g64)
    assert err1 >= 1e-5 and err1 >= 100 * err3
    assert max_rel(ll1.numpy(), ll64) < BOUND
    assert max_rel(ll1.numpy(), ll64) > 10 * max_rel(ll3.numpy(), ll64)


EDGES = [1e-6, 1e-7, 1e-8,
         pytest.param((1e-6, "gamma+9"), id="gamma9-1e-06"),
         pytest.param((1e-7, "gamma+9"), id="gamma9-1e-07")]


@functools.cache
def _edge(param):
    """Every branch `length` long, at C = 1 where the parameter is the
    length alone, else at (length, site)."""
    length, site = (param if isinstance(param, tuple)
                    else (param, "constant"))
    newick, aln = _synthetic.disagreeing_codons(0, 4, 64, length)
    ops, _ = _kernel_operands(parse_newick_text(newick), aln, site)
    ll64, g64 = paired.paired_ll_and_gradients_ref(
        *[x.double() if x.is_floating_point() else x for x in ops])
    return ops, ll64.numpy(), g64.numpy()


@pytest.fixture(scope="module", params=EDGES)
def edge_case(request):
    """The edge cases where one TF32 pass leaves the guard."""
    return _edge(request.param)


@pytest.fixture(scope="module", params=EDGES + [
    pytest.param((1e-8, "gamma+9"), id="gamma9-1e-08")])
def range_case(request):
    """Every edge case, with C = 9 at every branch 1e-8, where one TF32
    pass stays inside the guard (so the control does not take it)."""
    return _edge(request.param)


def test_three_passes_keep_float32_range(range_case):
    """At the edge of float32's range the 3xTF32 walk, which scales each
    category of a stored output by its own power of two and each child's
    product by its own factor before two are multiplied, stays finite and
    within CARD_LIMIT of float64 on the LL and the gradients."""
    ops, ll64, g64 = range_case
    ll, g = paired.paired_ll_and_gradients_tf32(*ops)
    assert bool(torch.isfinite(ll).all()) and bool(torch.isfinite(g).all())
    assert max_rel(ll.numpy(), ll64) < CARD_LIMIT
    assert max_norm(g.numpy(), g64) < CARD_LIMIT


def test_one_pass_fails_the_guard_at_the_range_edge(edge_case):
    """At the edge of float32's range one TF32 pass puts the gradients
    past the 5e-5 guard."""
    ops, _, g64 = edge_case
    _, g1 = paired.paired_ll_and_gradients_tf32(*ops, passes=1)
    assert max_norm(g1.numpy(), g64) > BOUND
