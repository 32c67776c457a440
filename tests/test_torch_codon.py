"""The port's MG94 codon path (models/codon.py, CodonSitePattern, the MG94
spec, the uniformized transition route and the engine at 64 states)
against bito_tpu's on the same numpy inputs: synthetic trees and codon
alignments (_synthetic.codon_alignment), 5-6 taxa, 40 codons.

Bounds: the copies (codon tables, masks, CodonSitePattern) are bito_tpu's
code by AST and give equal outputs; the rate matrix within 1e-12; the
eigensystems by what they rebuild (Q, P(t), pi) within 1e-12, since
eigenvectors are unique only up to sign and within degenerate
eigenspaces; the uniformized P within 1e-12 of bito_tpu's at q*t <= 5,
and within 1e-10 of scipy's expm at q*t = 31, where bito_tpu's K = 40 P
is more than 1% short (the fault is shown, not copied); the float64
engine within 1e-10 of bito_tpu's scan (LL relative, gradients of the
largest), but for the gradients of rows a tree, which both packages take
by the eigen route: 1e-9 (GRAD_BOUND says why); the plain A=64 kernel versions in float32 within 1e-5 (LL
relative) and 5e-5 of the largest gradient of bito_tpu's paired Pallas
kernel run in interpret mode at CA = 64, the bounds of the A=4 rows."""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from bito_tpu.core.newick import parse_newick_text as jax_parse
from bito_tpu.core.site_pattern import CodonSitePattern as JaxCodonPattern
from bito_tpu.models import codon as jcd
from bito_tpu.models import substitution as jsub
from bito_tpu.models.phylo_model import PhyloModel as JaxModel
from bito_tpu.models.phylo_model import PhyloModelSpecification as JaxSpec
from bito_tpu.treelike.engine import TreeLikelihoodEngine as JaxEngine
from bito_tpu_torch import _synthetic
from bito_tpu_torch.convert import params_from_numpy
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.core.site_pattern import CodonSitePattern
from bito_tpu_torch.models import codon as cd
from bito_tpu_torch.models import substitution as sub
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.treelike import paired, prep
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

from torch_port_cases import (max_norm, max_rel, one_torch_thread,
                              paired_launches, per_tree_rows,
                              without_docstrings)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


ROOT = pathlib.Path(__file__).resolve().parent.parent
F64 = dict(device="cpu", dtype=torch.float64)
MG94 = {"substitution_model_rates": np.array([2.5, 0.3]),
        "substitution_model_frequencies": np.array([0.3, 0.2, 0.3, 0.2])}
MG94_WEIBULL = {**MG94, "site_model_parameters": np.array([1.3])}
SITES = {"constant": MG94, "weibull+4": MG94_WEIBULL}
# What models/codon.py copies from bito_tpu's (its numpy parts).
COPIED = ("_BASES", "_CODE", "sense_codons", "SENSE_CODONS", "CODON_INDEX",
          "NUM_CODONS", "PADDED_STATES", "_aa", "_is_transition",
          "mg94_rate_matrix", "codon_frequencies_f1x4", "padded_eigen",
          "codon_tip_partials", "_structure_masks", "SINGLE_MASK",
          "CODON_NT_IDX")


def _top_level(path, name):
    """The AST dump of module `path`'s top-level definition or assignment
    of `name`, docstrings removed."""
    tree = ast.parse(pathlib.Path(path).read_text())
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, ast.Assign):
            names = [n.id for t in node.targets
                     for n in ast.walk(t) if isinstance(n, ast.Name)]
        else:
            continue
        if name in names:
            for sub_node in ast.walk(node):
                body = getattr(sub_node, "body", None)
                if (isinstance(body, list) and body
                        and isinstance(body[0], ast.Expr)
                        and isinstance(body[0].value, ast.Constant)
                        and isinstance(body[0].value.value, str)):
                    sub_node.body = body[1:]
            return ast.dump(node)
    raise KeyError(f"{name} not in {path}")


@pytest.mark.parametrize("name", COPIED)
def test_copied_codon_code_is_identical(name):
    assert (_top_level(ROOT / "bito_tpu_torch/models/codon.py", name)
            == _top_level(ROOT / "bito_tpu/models/codon.py", name))


def test_codon_site_pattern_is_bito_tpus_code():
    assert (_top_level(ROOT / "bito_tpu_torch/core/site_pattern.py",
                       "CodonSitePattern")
            == _top_level(ROOT / "bito_tpu/core/site_pattern.py",
                          "CodonSitePattern"))
    # The rest of the module is the nucleotide SitePattern, pinned by
    # tests/test_torch_encode.py; nothing else was added.
    assert without_docstrings(
        ROOT / "bito_tpu_torch/core/site_pattern.py") == without_docstrings(
        ROOT / "bito_tpu/core/site_pattern.py")


def test_codon_tables_and_masks_equal():
    assert cd.SENSE_CODONS == jcd.SENSE_CODONS
    assert _synthetic._SENSE_CODONS == jcd.SENSE_CODONS
    assert (cd.NUM_CODONS, cd.PADDED_STATES) == (61, 64)
    for name in ("SINGLE_MASK", "TI_MASK", "NONSYN_MASK", "CODON_NT_IDX"):
        np.testing.assert_array_equal(getattr(cd, name), getattr(jcd, name))
    pi = cd.codon_frequencies_f1x4((0.3, 0.2, 0.3, 0.2))
    Q = cd.mg94_rate_matrix(2.5, 0.3, pi)
    np.testing.assert_array_equal(Q, jcd.mg94_rate_matrix(2.5, 0.3, pi))
    for a, b in zip(cd.padded_eigen(Q, pi), jcd.padded_eigen(Q, pi)):
        np.testing.assert_array_equal(a, b)


def _codon_case(seed=3, num_taxa=6, num_codons=40, num_distinct=30,
                num_trees=3):
    text = _synthetic.random_trees_newick(seed, num_taxa, num_trees)
    tc, jc = parse_newick_text(text), jax_parse(text)
    aln = _synthetic.codon_alignment(seed + 1, tc.taxon_names, num_codons,
                                     num_distinct)
    return tc, jc, aln


def test_codon_site_pattern_outputs_equal():
    tc, jc, aln = _codon_case()
    t, j = CodonSitePattern(aln, tc.taxon_names), JaxCodonPattern(
        aln, jc.taxon_names)
    assert t.pattern_count == j.pattern_count == 30
    for field in ("patterns", "weights", "site_to_pattern"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field))
    np.testing.assert_array_equal(t.tip_partials(), j.tip_partials())
    np.testing.assert_array_equal(
        cd.codon_tip_partials(aln, tc.taxon_names),
        jcd.codon_tip_partials(aln, jc.taxon_names))
    # About 5% of the triplets are missing ('---') or stop codons.
    rows = t.tip_partials().reshape(-1, 64)
    assert 0 < (rows.sum(axis=1) == 61).mean() < 0.15
    assert (t.tip_partials()[..., 61:] == 0).all()


ROWS = [(2.5, 0.3, (0.3, 0.2, 0.3, 0.2)), (1.0, 1.0, (0.25,) * 4),
        (4.0, 0.05, (0.1, 0.4, 0.2, 0.3))]


@pytest.mark.parametrize("kappa,omega,freqs", ROWS)
def test_mg94_q_padded_matches(kappa, omega, freqs):
    Qj = np.asarray(jcd.mg94_q_padded(kappa, omega, jnp.asarray(freqs)))
    Qt = cd.mg94_q_padded(torch.tensor(kappa, **F64),
                          torch.tensor(omega, **F64),
                          torch.tensor(freqs, **F64)).numpy()
    np.testing.assert_allclose(Qt, Qj, rtol=0, atol=1e-12)
    assert (Qt[61:] == 0).all() and (Qt[:, 61:] == 0).all()


def _rebuilt(eig):
    """(Q, P(0.3), pi) from an eigensystem, as float64 numpy."""
    U, lam, Ui, pi = (np.asarray(x, np.float64) for x in eig)
    return (U * lam) @ Ui, (U * np.exp(0.3 * lam)) @ Ui, pi


def test_mg94_eigen_both_branches_rebuild_bito_tpus():
    """One plain row takes the numpy host path; rows a tree (and values
    autograd follows) the torch build.  Each rebuilds bito_tpu's Q, P(t)
    and pi (its concrete and its traced build) within 1e-12."""
    jax_plain = [_rebuilt(jcd.mg94_eigen(k, o, jnp.asarray(f)))
                 for k, o, f in ROWS]
    jax_traced = jax.jit(jax.vmap(jcd.mg94_eigen))(
        *(jnp.asarray(np.array(x)) for x in zip(*ROWS)))
    k, o, f = (torch.tensor(np.array(x), **F64) for x in zip(*ROWS))
    batched = cd.mg94_eigen(k, o, f)
    tracked = cd.mg94_eigen(k[0].clone().requires_grad_(), o[0], f[0])
    for i, want in enumerate(jax_plain):
        plain = cd.mg94_eigen(k[i], o[i], f[i])
        traced = _rebuilt([np.asarray(x[i]) for x in jax_traced])
        got = [_rebuilt(plain),
               _rebuilt([x[i].numpy() for x in batched])]
        if i == 0:
            got.append(_rebuilt([x.detach().numpy() for x in tracked]))
        for g in got:
            for a, b, c in zip(g, want, traced):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
                np.testing.assert_allclose(a, c, rtol=0, atol=1e-12)


def _jax_uniformized(Q, t):
    stack, q = jsub.uniformized_stack(jnp.asarray(Q))
    return np.asarray(jsub.uniformized_transition_matrices(
        stack, q, jnp.asarray(t)))


def _port_uniformized(Q, t):
    Qt = torch.tensor(Q, **F64)
    tt = torch.as_tensor(t, **F64)
    stack, q = sub.uniformized_stack(Qt, float(tt.max()))
    return sub.uniformized_transition_matrices(stack, q, tt).numpy()


def _q_and_rate():
    Q = np.asarray(jcd.mg94_q_padded(2.5, 0.3, jnp.asarray(
        [0.3, 0.2, 0.3, 0.2])))
    return Q, float(np.max(-np.diag(Q)))


def test_uniformized_P_matches_bito_tpu_below_qt_5():
    Q, q = _q_and_rate()
    t = np.array([0.0, 0.01, 0.5, 2.0, 5.0]) / q
    np.testing.assert_allclose(_port_uniformized(Q, t),
                               _jax_uniformized(Q, t), rtol=0, atol=1e-12)


def test_uniformized_P_does_not_truncate_at_qt_31():
    """At q*t = 31 the port's P is scipy's expm within 1e-10, and
    bito_tpu's K = 40 series leaves its rows more than 1% short."""
    Q, q = _q_and_rate()
    t = np.array([31.0 / q])
    want = scipy.linalg.expm(Q * t[0])
    got = _port_uniformized(Q, t)[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    short = 1.0 - _jax_uniformized(Q, t)[0][:61].sum(axis=1)
    assert short.min() > 0.01
    assert sub.uniformized_terms(31.0) > 40


def test_uniformized_terms_and_limit():
    assert sub.uniformized_terms(0.0) == 0
    terms = [sub.uniformized_terms(x) for x in (0.1, 1.0, 5.0, 15.0, 100.0)]
    assert terms == sorted(terms) and terms[2] <= 40
    with pytest.raises(ValueError, match="q\\*t"):
        sub.uniformized_terms(sub.MAX_UNIFORMIZED_QT * 1.01)


def _engines(site, per_tree, batch=3, seed=5, dtype=torch.float64):
    tc, jc, aln = _codon_case(seed=seed, num_trees=batch)
    params = SITES[site]
    if per_tree:
        params = per_tree_rows(params, batch, seed)
        params["substitution_model_rates"] = (
            MG94["substitution_model_rates"][None]
            * np.random.default_rng(seed).uniform(0.8, 1.25, (batch, 2)))
    je = JaxEngine(JaxCodonPattern(aln, jc.taxon_names),
                   JaxModel(JaxSpec("MG94", site)))
    je.kernel = "scan"
    te = TreeLikelihoodEngine(CodonSitePattern(aln, tc.taxon_names),
                              PhyloModel(PhyloModelSpecification("MG94", site)),
                              device="cpu", dtype=dtype)
    return je, te, jc.trees, tc.trees, params


# Gradients against bito_tpu, of the largest: 1e-10 for a shared model
# (the uniformized route in both); 1e-9 for rows a tree, which take the
# eigen route in both packages.  Its float64 products rebuild P's small
# entries by cancellation, so each package's eigensolver leaves its own
# rounding there: on the constant-rate case here each package's
# gradients lie about 3e-10 of the largest from the exact (uniformized)
# route, and 5.7e-10 from each other.
GRAD_BOUND = {False: 1e-10, True: 1e-9}


@pytest.mark.parametrize("site", ["constant", "weibull+4"])
@pytest.mark.parametrize("per_tree", [False, True], ids=["shared", "rows"])
def test_engine_scan_matches_bito_tpu(site, per_tree):
    """The float64 scan tape: the uniformized route for a shared model,
    the eigen route for rows a tree, as in bito_tpu.  Rows a tree are also
    held to each tree's exact result (the shared route, a tree at a
    time) within GRAD_BOUND."""
    je, te, jt, tt, params = _engines(site, per_tree)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = params_from_numpy(params, "cpu", torch.float64)
    assert te._route(te._shared_model(tp)) == "scan"
    assert (te._rate_Q(tp) is None) == per_tree
    ll_j, g_j = (np.asarray(x) for x in je.ll_and_branch_gradients(jt, jp))
    ll_t, g_t = (x.numpy() for x in te.ll_and_branch_gradients(tt, tp))
    assert max_rel(ll_t, ll_j) < 1e-10
    assert max_norm(g_t, g_j) < GRAD_BOUND[per_tree]
    assert max_rel(te.log_likelihoods(tt, tp).numpy(),
                   np.asarray(je.log_likelihoods(jt, jp))) < 1e-10
    if per_tree:
        exact = [te.ll_and_branch_gradients(
            [tt[b]], {k: v[b] for k, v in tp.items()}) for b in range(3)]
        assert max_rel(ll_t, torch.cat([x[0] for x in exact]).numpy()) < 1e-10
        assert max_norm(g_t, torch.cat([x[1] for x in exact]).numpy()) < (
            GRAD_BOUND[True])


def test_params_from_numpy_carries_mg94_blocks():
    """One numpy dict of MG94 + Weibull4 blocks (rates [2], frequencies
    [4], the Weibull shape [1]) gives both packages the same model."""
    je, te, jt, tt, params = _engines("weibull+4", False)
    tp = params_from_numpy(params, "cpu", torch.float64)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        "substitution_model_rates": (2,),
        "substitution_model_frequencies": (4,),
        "site_model_parameters": (1,)}
    assert set(tp) == set(te.model.blocks) == set(je.model.blocks)
    assert max_rel(te.log_likelihoods(tt, tp).numpy(), np.asarray(
        je.log_likelihoods(jt, {k: jnp.asarray(v) for k, v in
                                params.items()}))) < 1e-10


@pytest.mark.parametrize("categories", [None, 3])
def test_codon_free_functions_match(categories):
    tc, jc, aln = _codon_case(seed=9)
    tips = cd.codon_tip_partials(aln, tc.taxon_names)
    w = np.ones(tips.shape[1])
    topos = [t.topology for t in tc.trees]
    bl = np.stack([t.branch_lengths for t in tc.trees])
    extra = {} if categories is None else dict(
        category_rates=np.array([0.3, 1.0, 1.7]),
        category_proportions=np.array([0.2, 0.5, 0.3]))
    model = cd.CodonModel(kappa=2.5, omega=0.3, nuc_freqs=(0.3, 0.2, 0.3, 0.2))
    jmodel = jcd.CodonModel(kappa=2.5, omega=0.3,
                            nuc_freqs=(0.3, 0.2, 0.3, 0.2))
    jtopos = [t.topology for t in jc.trees]
    ll_j = np.asarray(jcd.codon_log_likelihoods(jtopos, bl, tips, w, jmodel,
                                                **extra))
    ll_gj, g_j = (np.asarray(x) for x in jcd.codon_ll_and_gradients(
        jtopos, bl, tips, w, jmodel, **extra))
    ll_t = cd.codon_log_likelihoods(topos, bl, tips, w, model, **extra, **F64)
    ll_gt, g_t = cd.codon_ll_and_gradients(topos, bl, tips, w, model,
                                           **extra, **F64)
    assert max_rel(ll_t.numpy(), ll_j) < 1e-10
    assert max_rel(ll_gt.numpy(), ll_gj) < 1e-10
    assert max_norm(g_t.numpy(), g_j) < 1e-10


def test_routes_at_64_states_on_the_cpu():
    """auto on the CPU takes the scan tape at 64 states; kernel="chunked"
    raises, as bito_tpu's does; kernel="cuda" runs the plain A=64
    versions, which agree with the scan tape in float64 within 1e-10."""
    _, te, _, tt, params = _engines("constant", False)
    tp = params_from_numpy(params, "cpu", torch.float64)
    assert te.num_states == 64 and te._route(True) == "scan"
    before = paired_launches()
    ll, g = te.ll_and_branch_gradients(tt, tp)
    te.kernel = "cuda"
    assert te._route(True) == "paired"
    ll_k, g_k = te.ll_and_branch_gradients(tt, tp)
    assert max_rel(ll_k.numpy(), ll.numpy()) < 1e-10
    assert max_norm(g_k.numpy(), g.numpy()) < 1e-10
    assert max_rel(te.log_likelihoods(tt, tp).numpy(), ll.numpy()) < 1e-10
    assert paired_launches() == before
    te.kernel = "chunked"
    with pytest.raises(ValueError, match="4-state"):
        te.log_likelihoods(tt, tp)


def test_wrappers_refuse_other_state_counts():
    with pytest.raises(ValueError, match="4 or 64-state"):
        paired._check_cuda_operands({}, {}, 1, 20, paired.KERNEL_STATES)
    with pytest.raises(ValueError, match="4-state"):  # the other kernels
        paired._check_cuda_operands({}, {}, 1, 64)


@pytest.fixture(scope="module")
def pallas_codon():
    """5 taxa x 40 codons x 4 trees, MG94: bito_tpu's paired Pallas
    kernels in interpret mode at CA = 64 and the port's float32 operands
    from its own prep (uniformized P, dP = Q P)."""
    tc, jc, aln = _codon_case(seed=13, num_taxa=5, num_trees=4)
    jp = {k: jnp.asarray(v) for k, v in MG94.items()}
    je = JaxEngine(JaxCodonPattern(aln, jc.taxon_names),
                   JaxModel(JaxSpec("MG94")))
    je.kernel = "pallas_interpret"
    assert je._padded_CA() == 64
    ll_pl, g_pl = je.ll_and_branch_gradients(jc.trees, jp)
    llo_pl = je.log_likelihoods(jc.trees, jp)
    te = TreeLikelihoodEngine(CodonSitePattern(aln, tc.taxon_names),
                              PhyloModel(PhyloModelSpecification("MG94")),
                              **F64)
    tp = params_from_numpy(MG94, "cpu", torch.float64)
    enc = te.encode(tc.trees)
    eig, rates, props, clock = te._model_ingredients(tp, 4)
    dst, tip, src, e, mask = te._paired_tapes(enc)
    bl = te.branch_length_matrix(tc.trees, enc)
    Q = te._rate_Q(tp)

    def operands(dtype):
        pi, prop = prep.kernel_model(eig, props, dtype)
        P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl, dtype, Q=Q)
        ops = dict(post_dst=dst, tip_slot=tip, post_e=e, P=P,
                   tips=te._kernel_tips.to(dtype), pi=pi, props=prop,
                   weights=te._kernel_weights.to(dtype))
        return ops, dict(post_src=src, edge_mask=mask.to(dtype), dP=dP)

    return dict(pallas=(np.asarray(ll_pl), np.asarray(g_pl),
                        np.asarray(llo_pl)),
                scan=[x.numpy() for x in te.ll_and_branch_gradients(
                    tc.trees, tp)],
                f32=operands(torch.float32), f64=operands(torch.float64))


def test_plain_a64_versions_match_pallas_interpret(pallas_codon):
    ops, extra = pallas_codon["f32"]
    assert ops["P"].shape[-1] == 64 and ops["P"].dtype == torch.float32
    ll_pl, g_pl, llo_pl = pallas_codon["pallas"]
    ll = paired.paired_log_likelihoods_ref(**ops).numpy()
    ll_g, g = (x.numpy() for x in paired.paired_ll_and_gradients_ref(
        **ops, **extra))
    assert max_rel(ll, llo_pl) < 1e-5 and max_rel(ll, ll_pl) < 1e-5
    assert max_rel(ll_g, ll_pl) < 1e-5
    assert max_norm(g, g_pl) < 5e-5
    ll_s, g_s = pallas_codon["scan"]
    assert max_rel(ll, ll_s) < 1e-5 and max_norm(g, g_s) < 5e-5


def test_plain_a64_versions_in_float64_match_the_scan(pallas_codon):
    """The paired-slot algorithm at 64 states without float32 rounding:
    within 1e-10 of the port's float64 scan tape (the same uniformized P)."""
    ops, extra = pallas_codon["f64"]
    ll_s, g_s = pallas_codon["scan"]
    assert max_rel(paired.paired_log_likelihoods_ref(**ops).numpy(),
                   ll_s) < 1e-10
    ll, g = paired.paired_ll_and_gradients_ref(**ops, **extra)
    assert max_rel(ll.numpy(), ll_s) < 1e-10
    assert max_norm(g.numpy(), g_s) < 1e-10


def test_a64_kernels_are_in_the_build():
    """Both A=64 sources, their header and their C entry points are part
    of the kernel library the card builds; the launchers count launches."""
    from bito_tpu_torch.treelike import _kernels

    for name in ("paired_ll_a64.cu", "paired_grad_a64.cu"):
        assert f"treelike/csrc/{name}" in _kernels._SOURCES
    assert "treelike/csrc/paired_a64.cuh" in _kernels._HEADERS
    assert (_kernels._SIGNATURES["bito_paired_ll_a64"]
            == _kernels._SIGNATURES["bito_paired_ll"])
    assert (_kernels._SIGNATURES["bito_paired_grad_a64"]
            == _kernels._SIGNATURES["bito_paired_grad"])
    assert isinstance(paired.paired_ll_a64.launches, int)
    assert isinstance(paired.paired_grad_a64.launches, int)
