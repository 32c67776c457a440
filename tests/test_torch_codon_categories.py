"""The A=64 kernels (csrc/paired_ll_a64.cu, csrc/paired_grad_a64.cu) past
8 rate categories, on the CPU: what runs here of them.

  - the port's float64 engine at MG94+Gamma9 and MG94+Weibull16 on the
    paired route (kernel="cuda": the plain A=64 versions on the CPU) and
    on the scan tape, and the per-node functions at 64 states (their
    plain versions), against bito_tpu's float64 scan engine, within 1e-10
    (LL relative, gradients of the largest);
  - the port's float32 plain A=64 versions at MG94+Gamma9 against
    bito_tpu's paired Pallas kernels in interpret mode (CA = 576: at 64
    states bito_tpu pads no category), within 1e-5 (LL) and 5e-5
    (gradients), the bounds of the A=4 rows;
  - the launchers' slices of trees (paired.tree_slices) and the scratch
    a tree (paired.a64_tree_bytes);
  - no category limit: the header has no kMaxCategories, both launchers
    refuse only C < 1, and the operand check takes any count.
The 3xTF32 emulation at C = 9 is in tests/test_torch_a64_tf32.py."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu.core.newick import parse_newick_text as jax_parse
from bito_tpu.core.site_pattern import CodonSitePattern as JaxCodonPattern
from bito_tpu.models.phylo_model import PhyloModel as JaxModel
from bito_tpu.models.phylo_model import PhyloModelSpecification as JaxSpec
from bito_tpu.treelike.engine import TreeLikelihoodEngine as JaxEngine
from bito_tpu_torch import _synthetic
from bito_tpu_torch.convert import params_from_numpy
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.core.site_pattern import CodonSitePattern
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.treelike import paired, pernode, prep
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

from torch_port_cases import max_norm, max_rel, one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


CSRC = (pathlib.Path(__file__).resolve().parent.parent
        / "bito_tpu_torch" / "treelike" / "csrc")
MG94 = {"substitution_model_rates": np.array([2.5, 0.3]),
        "substitution_model_frequencies": np.array([0.3, 0.2, 0.3, 0.2]),
        "site_model_parameters": np.array([0.8])}


def _engines(site, seed, num_taxa, num_trees, codons, distinct,
             dtype=torch.float64):
    """bito_tpu's engine and the port's on the CPU over one synthetic
    MG94 case with `site` rate categories: (bito_tpu engine, port engine,
    bito_tpu trees, port trees, the port's params in `dtype`)."""
    text = _synthetic.random_trees_newick(seed, num_taxa, num_trees)
    tc, jc = parse_newick_text(text), jax_parse(text)
    aln = _synthetic.codon_alignment(seed + 1, tc.taxon_names, codons,
                                     distinct)
    je = JaxEngine(JaxCodonPattern(aln, jc.taxon_names),
                   JaxModel(JaxSpec("MG94", site)))
    te = TreeLikelihoodEngine(CodonSitePattern(aln, tc.taxon_names),
                              PhyloModel(PhyloModelSpecification("MG94", site)),
                              device="cpu", dtype=dtype)
    return je, te, jc.trees, tc.trees, params_from_numpy(MG94, "cpu", dtype)


def _jax_params():
    return {k: jnp.asarray(v) for k, v in MG94.items()}


@pytest.mark.parametrize("site", ["gamma+9", "weibull+16"])
def test_float64_engine_and_pernode_match_bito_tpu_at_64_states(site):
    """The port's float64 engine on kernel='cuda' (the plain A=64 versions
    here) and on the scan tape, and the per-node functions at 64 states
    on the engine's own operands (uniformized P, dP = Q P), against
    bito_tpu's float64 scan engine within 1e-10."""
    je, te, jt, tt, params = _engines(site, 7, 6, 3, 40, 30)
    je.kernel = "scan"
    assert te.model.category_count == int(site.split("+")[1])
    ll_ref, g_ref = (np.asarray(x) for x in je.ll_and_branch_gradients(
        jt, _jax_params()))
    for kernel in ("cuda", "scan"):
        te.kernel = kernel
        ll = te.log_likelihoods(tt, params)
        ll2, g = te.ll_and_branch_gradients(tt, params)
        assert max_rel(ll.numpy(), ll_ref) < 1e-10, kernel
        assert max_rel(ll2.numpy(), ll_ref) < 1e-10, kernel
        assert max_norm(g.numpy(), g_ref) < 1e-10, kernel
    enc = te.encode(tt)
    eig, rates, props, clock = te._model_ingredients(params, len(tt))
    pi, prop = prep.kernel_model(eig, props, torch.float64)
    P, dP = prep.prepare_inputs_grad_q(
        eig, rates, clock, te.branch_length_matrix(tt, enc), torch.float64,
        Q=te._rate_Q(params))
    post, pre, root = (torch.as_tensor(x, dtype=torch.int32)
                       for x in (enc.post_ops, enc.pre_ops, enc.root))
    mask = torch.as_tensor(enc.edge_mask, dtype=torch.float64)
    tips, w = te._kernel_tips, te._kernel_weights
    ll = pernode.pernode_log_likelihoods(post, root, P, tips, pi, prop, w)
    ll2, g = pernode.pernode_ll_and_gradients(post, pre, root, mask, P, dP,
                                              tips, pi, prop, w)
    assert max_rel(ll.numpy(), ll_ref) < 1e-10
    assert max_rel(ll2.numpy(), ll_ref) < 1e-10
    assert max_norm(g.numpy(), g_ref) < 1e-10


def test_plain_a64_versions_match_pallas_interpret_at_9_categories():
    """5 taxa x 30 patterns x 2 trees, MG94+Gamma9: bito_tpu's paired
    Pallas kernels in interpret mode at CA = 576 against the port's
    float32 plain A=64 versions on its own operands (uniformized P, dP =
    Q P)."""
    je, te, jt, tt, params = _engines("gamma+9", 13, 5, 2, 40, 30,
                                      torch.float32)
    je.kernel = "pallas_interpret"
    assert je._padded_CA() == 9 * 64
    ll_pl, g_pl = (np.asarray(x) for x in je.ll_and_branch_gradients(
        jt, _jax_params()))
    llo_pl = np.asarray(je.log_likelihoods(jt, _jax_params()))
    enc = te.encode(tt)
    eig, rates, props, clock = te._model_ingredients(params, len(tt))
    dst, tip, src, e, mask = te._paired_tapes(enc)
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(
        eig, rates, clock, te.branch_length_matrix(tt, enc),
        Q=te._rate_Q(params))
    assert P.dtype == torch.float32 and P.shape[2:] == (9, 64, 64)
    tips, w = te._kernel_tips, te._kernel_weights
    ll = paired.paired_log_likelihoods(dst, tip, e, P, tips, pi, prop, w)
    ll2, g = paired.paired_ll_and_gradients(dst, tip, src, e, mask, P, dP,
                                            tips, pi, prop, w)
    assert g.shape == g_pl.shape
    assert max_rel(ll.numpy(), llo_pl) < 1e-5
    assert max_rel(ll2.numpy(), ll_pl) < 1e-5
    assert max_norm(g.numpy(), g_pl) < 5e-5


@pytest.mark.parametrize("B,tree_bytes,budget,want", [
    (128, 10, 10_000, [(0, 128)]),           # the batch fits: one launch
    (128, 10, 1_280, [(0, 128)]),            # exactly
    (128, 10, 1_279, [(0, 127), (127, 128)]),
    (200, 314_466_460, 40_000_000_000,       # C = 32 at config6's shape
     [(0, 127), (127, 200)]),
    (7, 3, 6, [(0, 2), (2, 4), (4, 6), (6, 7)]),
    (5, 3, 3, [(i, i + 1) for i in range(5)]),  # one tree a launch
    (0, 3, 10, []),
])
def test_tree_slices_cover_the_batch_in_order(B, tree_bytes, budget, want):
    """Consecutive slices from tree 0 to B, none empty, each of as many
    trees as the budget holds (the last the rest)."""
    got = paired.tree_slices(B, tree_bytes, budget)
    assert got == want
    assert [t for b0, b1 in got for t in range(b0, b1)] == list(range(B))
    assert all(b1 > b0 for b0, b1 in got)
    assert all(b1 - b0 <= budget // tree_bytes for b0, b1 in got)


def test_tree_slices_stop_at_the_grid_and_refuse_a_tree_too_large():
    """At most GRID_TREES (65,535, the grid's y extent) trees a launch; a
    tree whose scratch exceeds the budget raises and names the bytes."""
    assert paired.GRID_TREES == 65_535
    assert paired.tree_slices(140_000, 1, 10**9) == [
        (0, 65_535), (65_535, 131_070), (131_070, 140_000)]
    with pytest.raises(torch.cuda.OutOfMemoryError,
                       match="314466460 bytes a tree; 314466459 bytes"):
        paired.tree_slices(1, 314_466_460, 314_466_459)


def test_a64_tree_bytes_is_a_tree_of_the_scratch():
    """A tree's bytes are a B-th of what the launchers allocate
    (_a64_scratch, here on the meta device): buf [NS, C, 64, S], the
    scales [NS, 2 + C, S] floats and the slot codes [tiles, NS] ints, NS
    = 2M + 3; at config6's shape (M = 28, S = 640) 88.7 / 157.4 / 314.5
    MB at C = 9 / 16 / 32."""
    for B, M, S, C in ((128, 28, 640, 9), (128, 28, 640, 16),
                       (200, 28, 640, 32), (1, 4, 4, 1), (3, 6, 132, 3)):
        buf, rest = paired._a64_scratch(B, M, S, C, "meta")
        assert buf.shape == (B, 2 * M + 3, C, 64, S)
        assert buf.dtype == rest.dtype == torch.float32
        assert 4 * (buf.numel() + rest.numel()) == B * paired.a64_tree_bytes(
            M, S, C)
    assert paired.a64_tree_bytes(6, 132, 3) == 4 * 15 * (
        3 * 64 * 132 + 5 * 132 + 2)
    assert [paired.a64_tree_bytes(28, 640, C) for C in (9, 16, 32)] == [
        88_661_660, 157_384_860, 314_466_460]


def test_one_category_limit_for_both_state_counts():
    """No category cap at 4 or 64 states: the A=64 header has no
    kMaxCategories (its tile is A64_TILE), both A=64 launchers refuse
    only C < 1, and the operand check takes every count C >= 1 at both
    state counts and refuses 0."""
    assert not hasattr(paired, "max_categories")
    assert not hasattr(paired, "MAX_CATEGORIES")
    header = (CSRC / "paired_a64.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\w+);", header)[1])

    assert "kMaxCategories" not in header
    assert const("kWarps") * const("kCols") == paired.A64_TILE
    for name in ("paired_ll_a64.cu", "paired_grad_a64.cu"):
        src = (CSRC / name).read_text()
        assert "kMaxCategories" not in src, name
        assert "|| C < 1)" in src, name
        assert not re.search(r"C > \d", src), name
    for C in (1, 9, 16, 32, 33, 48, 64):
        for A in paired.KERNEL_STATES:
            paired._check_cuda_operands({}, {}, C, A, paired.KERNEL_STATES)
    with pytest.raises(ValueError, match="1 or more"):
        paired._check_cuda_operands({}, {}, 0, 64, paired.KERNEL_STATES)
