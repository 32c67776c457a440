"""The per-node functions at 64 states (treelike/pernode.py), which run on
the paired A=64 kernels over the tape that pernode.a64_tape derives from
the per-node one: the derived tapes, the plain versions on them against
pernode's own plain versions, and one small case against bito_tpu's
per-node Pallas kernel (pallas_pruning.pallas_ll_and_gradients) at A = 64
in interpret mode.

Cases: MG94 on synthetic codon alignments, 5-7 taxa, trifurcating and
bifurcating roots, C = 1 and 2; the operands of the engines' own prep
(uniformized P, dP = Q P).

Bounds: in float64 the paired plain versions on the derived tapes equal
pernode's within 1e-10 (LL relative, gradients of the largest); the port's
float32 plain versions within 1e-5 (LL) and 5e-5 (gradients) of the
Pallas kernel, the bounds of the A=4 rows."""
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
from bito_tpu_torch.treelike import paired, pernode, prep
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

from torch_port_cases import max_norm, max_rel

MG94 = {"substitution_model_rates": np.array([2.5, 0.3]),
        "substitution_model_frequencies": np.array([0.3, 0.2, 0.3, 0.2])}


def _case(site, seed, num_taxa, rooted, num_trees=3, dtype=torch.float64,
          codons=60, distinct=50):
    """(trees newick, alignment, encoding, per-node operands, grad extras)
    of an MG94 case from the port's engine."""
    text = _synthetic.random_trees_newick(seed, num_taxa, num_trees, rooted)
    coll = parse_newick_text(text)
    aln = _synthetic.codon_alignment(seed + 1, coll.taxon_names, codons,
                                     distinct)
    eng = TreeLikelihoodEngine(
        CodonSitePattern(aln, coll.taxon_names),
        PhyloModel(PhyloModelSpecification("MG94", site)),
        device="cpu", dtype=dtype)
    params = params_from_numpy(dict(MG94) if site == "constant" else dict(
        MG94, site_model_parameters=np.array([0.8])), "cpu", dtype)
    enc = eng.encode(coll.trees)
    eig, rates, props, clock = eng._model_ingredients(params, num_trees)
    pi, prop = prep.kernel_model(eig, props, dtype)
    P, dP = prep.prepare_inputs_grad_q(
        eig, rates, clock, eng.branch_length_matrix(coll.trees, enc), dtype,
        Q=eng._rate_Q(params))
    post, pre, root = (torch.as_tensor(x, dtype=torch.int32)
                       for x in (enc.post_ops, enc.pre_ops, enc.root))
    ops = dict(post_ops=post, root=root, P=P,
               tips=eng._kernel_tips.to(dtype), pi=pi, props=prop,
               weights=eng._kernel_weights.to(dtype))
    extra = dict(pre_ops=pre, dP=dP,
                 edge_mask=torch.as_tensor(enc.edge_mask, dtype=dtype))
    return text, aln, enc, ops, extra


@pytest.mark.parametrize("site,seed,num_taxa,rooted", [
    ("constant", 3, 7, False), ("constant", 4, 6, True),
    ("gamma+2", 5, 6, False), ("gamma+2", 6, 7, True)])
def test_paired_plain_on_the_derived_tape_is_pernode_plain(site, seed,
                                                           num_taxa, rooted):
    """The paired walk on a64_tape's tape computes what the per-node plain
    versions compute, in float64, within 1e-10; the tape's post_dst and
    edges are ll_tape's, and each tip sits at the slot that reads it."""
    _, _, enc, ops, extra = _case(site, seed, num_taxa, rooted)
    tape = pernode.a64_tape(enc.post_ops, enc.root, enc.num_taxa,
                            enc.num_slots, "cpu", pre_ops=enc.pre_ops)
    ll_tape = pernode.ll_tape(enc.post_ops, enc.root, enc.num_taxa,
                              enc.num_slots, "cpu")
    assert torch.equal(tape.post_dst, ll_tape.post_dst)
    assert torch.equal(tape.post_e, ll_tape.post_e)
    child = ll_tape.child.numpy()
    for b, t in np.ndindex(*tape.tip_slot.shape):
        m, j = divmod(int(tape.tip_slot[b, t]), 2)
        assert child[b, m, j] == -1 - t
    pops = dict(post_dst=tape.post_dst, tip_slot=tape.tip_slot,
                post_e=tape.post_e, P=ops["P"], tips=ops["tips"],
                pi=ops["pi"], props=ops["props"], weights=ops["weights"])
    ll_n = pernode.pernode_log_likelihoods_ref(**ops).numpy()
    ll_gn, g_n = (x.numpy() for x in pernode.pernode_ll_and_gradients_ref(
        **ops, **extra))
    assert max_rel(paired.paired_log_likelihoods_ref(**pops).numpy(),
                   ll_n) < 1e-10
    ll_p, g_p = paired.paired_ll_and_gradients_ref(
        **pops, post_src=tape.post_src, edge_mask=extra["edge_mask"],
        dP=extra["dP"])
    assert max_rel(ll_p.numpy(), ll_gn) < 1e-10
    assert max_norm(g_p.numpy(), g_n) < 1e-10


def test_a64_tape_refuses_what_the_paired_walk_cannot_take():
    """Another tree's preorder, a node under another parent, and a tip read
    twice are refused."""
    _, _, enc, _, _ = _case("constant", 3, 7, False)
    args = (enc.num_taxa, enc.num_slots, "cpu")
    with pytest.raises(ValueError, match="parent"):
        pernode.a64_tape(enc.post_ops, enc.root, *args,
                         pre_ops=enc.pre_ops[::-1].copy())
    pre = enc.pre_ops.copy()
    pre[0, 0, 1] = pre[0, -1, 1] if pre[0, -1, 1] != pre[0, 0, 1] else (
        pre[0, 1, 1])
    with pytest.raises(ValueError):
        pernode.a64_tape(enc.post_ops, enc.root, *args, pre_ops=pre)
    post = enc.post_ops.copy()
    tip_reader = next(m for m in range(post.shape[1])
                      if post[0, m, 1] < enc.num_taxa)
    other = next(m for m in range(post.shape[1]) if m != tip_reader
                 and post[0, m, 3] < enc.num_taxa)
    post[0, other, 3] = post[0, other, 4] = post[0, tip_reader, 1]
    with pytest.raises(ValueError, match="tip"):
        pernode.a64_tape(post, enc.root, *args)


def test_wrappers_at_64_states_run_the_plain_versions_on_the_cpu():
    """CPU tensors at 64 states take the plain versions and launch
    nothing."""
    _, _, _, ops, extra = _case("gamma+2", 5, 6, False, dtype=torch.float32)
    before = (paired.paired_ll_a64.launches, paired.paired_grad_a64.launches)
    torch.testing.assert_close(pernode.pernode_log_likelihoods(**ops),
                               pernode.pernode_log_likelihoods_ref(**ops),
                               rtol=0, atol=0)
    for a, b in zip(pernode.pernode_ll_and_gradients(**ops, **extra),
                    pernode.pernode_ll_and_gradients_ref(**ops, **extra)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (paired.paired_ll_a64.launches,
            paired.paired_grad_a64.launches) == before


def test_plain_versions_at_64_states_match_pallas_interpret():
    """5 taxa x 30 patterns x 2 trees, MG94: bito_tpu's per-node Pallas
    LL+gradient kernel in interpret mode at A = 64 (its uniformized
    operands, pallas_pruning.prepare_inputs_grad_q) against the port's
    float32 per-node plain versions and the 3xTF32 emulation of the A=64
    kernels on the derived tape."""
    text, aln, enc, ops, extra = _case("constant", 13, 5, False, num_trees=2,
                                       dtype=torch.float32, codons=40,
                                       distinct=30)
    jc = jax_parse(text)
    je = JaxEngine(JaxCodonPattern(aln, jc.taxon_names),
                   JaxModel(JaxSpec("MG94")))
    jp = {k: jnp.asarray(v) for k, v in MG94.items()}
    jenc = je.encode(jc.trees)
    np.testing.assert_array_equal(jenc.post_ops, enc.post_ops)
    eig, rates, props, clock = je._model_ingredients(jp, 2)
    sp = je.site_pattern
    kargs = pallas_pruning.prepare_inputs_grad_q(
        jenc, jnp.asarray(sp.tip_partials(), jnp.float32), sp.weights, eig,
        rates, props, clock, je.branch_length_matrix(jc.trees, jenc),
        je.pattern_pad, Q=je._rate_Q(jp))
    ll_pl, g_pl = (np.asarray(x) for x in pallas_pruning.pallas_ll_and_gradients(
        *(jnp.asarray(x) for x in (jenc.post_ops, jenc.pre_ops, jenc.root)),
        jnp.asarray(jenc.edge_mask, jnp.float32), *kargs,
        num_slots=jenc.num_slots, category_count=1,
        s_tile=je._pallas_s_tile(), interpret=True))
    ll, g = (x.numpy() for x in pernode.pernode_ll_and_gradients_ref(
        **ops, **extra))
    assert g.shape == g_pl.shape
    assert max_rel(ll, ll_pl) < 1e-5 and max_norm(g, g_pl) < 5e-5
    tape = pernode.a64_tape(enc.post_ops, enc.root, enc.num_taxa,
                            enc.num_slots, "cpu", pre_ops=enc.pre_ops)
    ll_e, g_e = (x.numpy() for x in paired.paired_ll_and_gradients_tf32(
        tape.post_dst, tape.tip_slot, tape.post_src, tape.post_e,
        extra["edge_mask"], ops["P"], extra["dP"], ops["tips"], ops["pi"],
        ops["props"], ops["weights"]))
    assert max_rel(ll_e, ll_pl) < 1e-5 and max_norm(g_e, g_pl) < 5e-5


def test_grad_refuses_a_tape_derived_without_pre_ops():
    """a64_tape records whether pre_ops was checked, and the grad's route
    refuses a tape derived without it (before any operand check)."""
    _, _, enc, ops, extra = _case("constant", 3, 7, False)
    args = (enc.num_taxa, enc.num_slots, "cpu")
    ll_only = pernode.a64_tape(enc.post_ops, enc.root, *args)
    both = pernode.a64_tape(enc.post_ops, enc.root, *args,
                            pre_ops=enc.pre_ops)
    assert not ll_only.with_pre and both.with_pre
    with pytest.raises(ValueError, match="pre_ops"):
        pernode._a64_of(ll_only, ops["post_ops"], ops["root"],
                        extra["pre_ops"], enc.num_taxa, enc.num_slots + 1,
                        "cpu")
