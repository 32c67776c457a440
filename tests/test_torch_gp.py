"""The port's GP engine (bito_tpu_torch/gp, api/gp.py) against bito_tpu's,
in float64 on the CPU, on synthetic credible sets
(bito_tpu_torch._synthetic.credible_set_newick) with the same branch
lengths and SBN parameters carried by convert.gp_state_from_numpy.

Bounds: PLVs, per-PCSP log likelihoods, the log marginal, the SBN
estimate and the hybrid marginals within 1e-10; one optimization sweep's
branch lengths within 1e-8 for brent, gradient_ascent and newton.  Two
methods' argmin is decided by rounding, in bito_tpu itself:
brent_with_gradients' gradient step lands within rounding of the trial
point near an optimum, and Brent resolves the argmin to 2^-9 only
(bito_tpu's own jitted and eager runs of it differ by 1e-4 on one
objective, and by 3.6e-8 relative in the log marginal one sweep reaches
on this file's 8-taxon set); the log-space ascent's fixed step of x f'(x)
oscillates on steep edges (bito_tpu's two runs differ by 0.32 in a branch
length there, at the same log marginal).  So the optimizers are held to
bito_tpu's on polynomial objectives, and these two methods' sweeps by the
log marginal they reach, within 1e-7 relative.  estimate_branch_lengths,
whose sweeps compound such ties, is held by its log marginal within 1e-8
relative (1e-7 for those two).  Then the exact-
marginal oracle of tests/test_gp.py through the port's own likelihood
engine, growth against a fresh engine, hot start and take-first, and the
engine in float32 against float64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp

from bito_tpu.api.gp import gp_instance as jax_gp_instance
from bito_tpu.gp import optimize as jax_optimize
from bito_tpu_torch import _synthetic
from bito_tpu_torch.api.gp import gp_instance
from bito_tpu_torch.convert import gp_state, gp_state_from_numpy
from bito_tpu_torch.core.newick import parse_newick_text, read_fasta
from bito_tpu_torch.core.site_pattern import SitePattern
from bito_tpu_torch.dag.subsplit_dag import build_dag_from_topologies
from bito_tpu_torch.gp import engine as gpe
from bito_tpu_torch.gp import optimize
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.treelike import pruning
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine

from torch_port_cases import one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


F64 = torch.float64
METHODS = gpe.METHODS
# The methods whose argmin rounding decides (see the module docstring).
TIE_METHODS = ["brent_with_gradients", "log_space_gradient_ascent"]
ARGMIN_METHODS = [m for m in METHODS if m not in TIE_METHODS]


def _write(tmp, seed, taxa, trees, nnis, sites):
    nwk, fasta = tmp / "trees.nwk", tmp / "alignment.fasta"
    nwk.write_text(_synthetic.credible_set_newick(seed, taxa, trees, nnis))
    fasta.write_text(_synthetic.fasta_text(_synthetic.random_alignment(
        seed + 1, _synthetic.taxon_names(taxa), sites)))
    return str(nwk), str(fasta)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """8 taxa, 4 trees of 2 NNIs, 120 columns."""
    return _write(tmp_path_factory.mktemp("gp"), 3, 8, 4, 2, 120)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """6 taxa, 3 trees of 1 NNI, 80 columns: the optimizers' estimates."""
    return _write(tmp_path_factory.mktemp("gp_small"), 3, 6, 3, 1, 80)


def _instances(files, method="brent", dtype=F64):
    """(bito_tpu's instance, the port's on the CPU in `dtype`), each with
    an engine, and the port's state carried from bito_tpu's: branch
    lengths uniform in (0.01, 0.3) from a seed, q the uniform prior."""
    nwk, fasta = files
    out = []
    for inst in (jax_gp_instance(), gp_instance(device="cpu", dtype=dtype)):
        inst.read_fasta_file(fasta)
        inst.read_newick_file(nwk)
        inst.make_gp_engine()
        inst.set_optimization_method(method)
        out.append(inst)
    j, t = out
    rng = np.random.default_rng(17)
    j.set_branch_lengths(rng.uniform(0.01, 0.3, j.get_dag().edge_count()))
    gp_state_from_numpy(t.get_gp_engine(), **gp_state(j.get_gp_engine()))
    return j, t


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_state_carries_over(files):
    j, t = _instances(files)
    for key, value in gp_state(j.get_gp_engine()).items():
        np.testing.assert_array_equal(gp_state(t.get_gp_engine())[key],
                                      value)
    with pytest.raises(ValueError, match="edges"):
        gp_state_from_numpy(t.get_gp_engine(), np.ones(3), np.ones(3))


def test_plvs_and_likelihoods_match(files):
    j, t = _instances(files)
    for inst in (j, t):
        inst.populate_plvs()
        inst.compute_likelihoods()
    je, te = j.get_gp_engine(), t.get_gp_engine()
    assert te.plv.shape == je.plv.shape and te.plv.dtype == F64
    np.testing.assert_allclose(te.plv.numpy(), np.asarray(je.plv),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(te.ls.numpy(), np.asarray(je.ls),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(t.get_per_gpcsp_log_likelihoods(),
                               j.get_per_gpcsp_log_likelihoods(),
                               rtol=1e-10, atol=0)
    assert _rel(t.get_log_marginal_likelihood(),
                j.get_log_marginal_likelihood()) < 1e-10
    np.testing.assert_allclose(
        te.per_gpcsp_components_of_full_log_marginal(),
        je.per_gpcsp_components_of_full_log_marginal(), rtol=1e-10)
    np.testing.assert_allclose(te.log_marginal_site.numpy(),
                               np.asarray(je.log_marginal_site), rtol=1e-10)


@pytest.mark.parametrize("method", ARGMIN_METHODS)
def test_one_sweep_branch_lengths_match(small, method):
    """One sweep from the same state: the same branch lengths (and their
    differences from the start) within 1e-8."""
    j, t = _instances(small, method)
    for inst in (j, t):
        inst.populate_plvs()
        inst.get_gp_engine().optimize_branch_lengths_once()
    np.testing.assert_allclose(t.get_branch_lengths(), j.get_branch_lengths(),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(
        t.get_gp_engine().branch_length_differences.numpy(),
        np.asarray(j.get_gp_engine().branch_length_differences),
        rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("method", TIE_METHODS)
def test_rounding_decided_sweep_reaches_the_same_objective(files, method):
    j, t = _instances(files, method)
    for inst in (j, t):
        inst.populate_plvs()
        inst.get_gp_engine().optimize_branch_lengths_once()
        inst.populate_plvs()
        inst.compute_likelihoods()
    assert _rel(t.get_log_marginal_likelihood(),
                j.get_log_marginal_likelihood()) < 1e-7


@pytest.mark.parametrize("method", METHODS)
def test_estimate_branch_lengths_reaches_the_same_marginal(small, method):
    """estimate_branch_lengths (tol 1e-4, at most 3 sweeps) from the same
    state: the same log marginal within 1e-8 relative (1e-7 for
    TIE_METHODS), finite lengths."""
    j, t = _instances(small, method)
    mj = j.estimate_branch_lengths(1e-4, 3)
    mt = t.estimate_branch_lengths(1e-4, 3)
    bound = 1e-7 if method in TIE_METHODS else 1e-8
    assert np.isfinite(mt) and _rel(mt, mj) < bound
    assert mt == t.get_log_marginal_likelihood()
    assert np.isfinite(t.get_branch_lengths()).all()


def _polynomial(y, a, b, c):
    """A quartic with a unique minimum in each lane, evaluated by the same
    operations in both packages (its jvp, which each package derives by
    its own product rule, may differ in the last bit)."""
    d = y - b
    return a * d * d + c * d * d * d * d


@pytest.mark.parametrize("use_gradients", [False, True])
def test_brent_matches_bito_tpu_on_a_polynomial(use_gradients):
    rng = np.random.default_rng(2)
    K = 64
    a, b, c = (rng.uniform(0.2, 3, K), rng.uniform(-6, 0.5, K),
               rng.uniform(0.01, 0.5, K))
    guess, lo, hi = rng.uniform(-8, 0.8, K), np.full(K, -13.9), np.full(K, 1.1)
    j = jax_optimize.brent_minimize_batched(
        lambda y: _polynomial(y, a, b, c), jnp.asarray(guess),
        jnp.asarray(lo), jnp.asarray(hi), iterations=60,
        use_gradients=use_gradients)
    T = torch.as_tensor
    x = optimize.brent_minimize_batched(
        lambda y: _polynomial(y, T(a), T(b), T(c)), T(guess), T(lo), T(hi),
        iterations=60, use_gradients=use_gradients)
    np.testing.assert_allclose(x.numpy(), np.asarray(j), rtol=0,
                               atol=1e-10 if use_gradients else 1e-12)
    np.testing.assert_allclose(x.numpy(), b, atol=1e-2)


def test_ascents_and_newton_match_bito_tpu_on_a_polynomial():
    rng = np.random.default_rng(3)
    K = 32
    # Gentle slopes: the log-space ascent steps by x f'(x) * 1.0005.
    a, b, c = rng.uniform(0.02, 0.2, K), rng.uniform(0.05, 1.0, K), 0.01
    x0 = rng.uniform(0.05, 1.5, K)
    T = torch.as_tensor

    def jffp(x):
        return -_polynomial(x, a, b, c), -(2 * a * (x - b)
                                          + 4 * c * (x - b) ** 3)

    def tffp(x):
        return -_polynomial(x, T(a), T(b), c), -(2 * T(a) * (x - T(b))
                                                + 4 * c * (x - T(b)) ** 3)

    for jfn, tfn, floor in (
            (jax_optimize.gradient_ascent_batched,
             optimize.gradient_ascent_batched, -13.9),
            (jax_optimize.log_space_gradient_ascent_batched,
             optimize.log_space_gradient_ascent_batched, 1e-6)):
        j = jfn(jffp, jnp.asarray(x0), jnp.full(K, floor), max_iter=200)
        x = tfn(tffp, T(x0), torch.full((K,), floor, dtype=F64), max_iter=200)
        np.testing.assert_allclose(x.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-12)

    def jf3(y):
        return (-_polynomial(y, a, b, c),
                -(2 * a * (y - b) + 4 * c * (y - b) ** 3),
                -(2 * a + 12 * c * (y - b) ** 2))

    def tf3(y):
        return (-_polynomial(y, T(a), T(b), c),
                -(2 * T(a) * (y - T(b)) + 4 * c * (y - T(b)) ** 3),
                -(2 * T(a) + 12 * c * (y - T(b)) ** 2))

    lo, hi = np.full(K, -13.9), np.full(K, 1.1)
    j = jax_optimize.newton_raphson_batched(jf3, jnp.asarray(x0),
                                            jnp.asarray(lo), jnp.asarray(hi))
    x = optimize.newton_raphson_batched(tf3, T(x0), T(lo), T(hi))
    np.testing.assert_allclose(x.numpy(), np.asarray(j), rtol=0, atol=1e-12)
    j = jax_optimize.newton_maximize_batched(
        lambda y: jf3(y)[1:], jnp.asarray(x0), jnp.asarray(lo),
        jnp.asarray(hi))
    x = optimize.newton_maximize_batched(lambda y: tf3(y)[1:], T(x0), T(lo),
                                         T(hi))
    np.testing.assert_allclose(x.numpy(), np.asarray(j), rtol=0, atol=1e-12)
    assert optimize.GOLDEN == jax_optimize.GOLDEN


def test_sbn_estimate_and_hybrid_marginals_match(files):
    j, t = _instances(files)
    for inst in (j, t):
        inst.calculate_hybrid_marginals()
    hj, ht = j.get_hybrid_marginals(), t.get_hybrid_marginals()
    assert (np.isfinite(hj) == np.isfinite(ht)).all() and np.isfinite(hj).any()
    np.testing.assert_allclose(ht[np.isfinite(hj)], hj[np.isfinite(hj)],
                               rtol=1e-10)
    for inst in (j, t):
        inst.estimate_sbn_parameters()
    np.testing.assert_allclose(t.get_sbn_parameters(), j.get_sbn_parameters(),
                               rtol=0, atol=1e-10)
    assert _rel(t.get_log_marginal_likelihood(),
                j.get_log_marginal_likelihood()) < 1e-10
    # One request alone, as the reference's per-edge verb computes it.
    dag = t.get_dag()
    parent, side, child, _ = next(
        (p, s, c, e) for p, s, c, e in dag.topological_edge_traversal()
        if p != dag.root_id and c >= dag.taxon_count
        and t.get_gp_engine().calculate_quartet_hybrid_likelihoods(
            p, s == 1, c) is not None)
    np.testing.assert_allclose(
        t.get_gp_engine().calculate_quartet_hybrid_likelihoods(
            parent, side == 1, child),
        j.get_gp_engine().calculate_quartet_hybrid_likelihoods(
            parent, side == 1, child), rtol=1e-10)


def test_hot_start_and_take_first_match(files):
    j, t = _instances(files)
    for verb in ("hot_start_branch_lengths", "take_first_branch_length"):
        getattr(j, verb)()
        getattr(t, verb)()
        np.testing.assert_array_equal(t.get_branch_lengths(),
                                      j.get_branch_lengths())


def test_grown_engine_matches_fresh(files):
    """grow() onto a larger DAG: surviving PLVs carried bit for bit and
    branch lengths by PCSP; then the same likelihoods as a fresh engine on
    the grown DAG, and as bito_tpu's grown engine."""
    nwk, fasta = files
    coll = parse_newick_text(open(nwk).read())
    sp = SitePattern(read_fasta(fasta), coll.taxon_names)
    dags = [build_dag_from_topologies([t.topology for t in coll.trees[:k]],
                                      coll.taxon_names) for k in (2, 4)]
    eng = gpe.GPEngine(sp, dags[0], device="cpu", dtype=F64)
    eng.populate_plvs()
    old_plv = eng.plv.clone()
    old_ids = {s.to_string(): i for i, s in enumerate(dags[0].nodes)}
    eng.grow(dags[1])
    carried = 0
    for new_id, ss in enumerate(dags[1].nodes):
        old_id = old_ids.get(ss.to_string())
        if old_id is not None and old_id < dags[0].node_count() - 1:
            assert torch.equal(eng.plv[:, new_id], old_plv[:, old_id])
            carried += 1
    assert carried >= dags[0].node_count() - 2
    fresh = gpe.GPEngine(sp, dags[1], device="cpu", dtype=F64)
    fresh.branch_lengths = eng.branch_lengths
    for e in (eng, fresh):
        e.populate_plvs()
        e.compute_likelihoods()
    np.testing.assert_allclose(eng.per_edge_ll.numpy(),
                               fresh.per_edge_ll.numpy(), rtol=0, atol=1e-12)
    assert abs(eng.log_marginal_likelihood()
               - fresh.log_marginal_likelihood()) < 1e-12


def _exact_marginal(collection, alignment, dag):
    """tests/test_gp.py's compute_exact_marginal through the port's
    likelihood engine: the per-site marginal over a complete tree set under
    a uniform prior, and per-edge log marginals."""
    trees = collection.trees
    sp = SitePattern(alignment, collection.taxon_names)
    engine = TreeLikelihoodEngine(sp, PhyloModel(PhyloModelSpecification()),
                                  device="cpu", dtype=F64)
    enc = engine.encode(trees)
    bl = engine.branch_length_matrix(trees, enc)
    eig, rates, props, clock = engine._model_ingredients({}, len(trees))
    P = pruning.transition_matrices_ext(eig, bl, rates, clock)
    buf, logs = pruning.init_partials(engine.tip_partials, len(trees),
                                      enc.num_slots, 1, engine.pattern_pad)
    buf, logs = pruning.postorder_pass(torch.as_tensor(enc.post_ops), P, buf,
                                       logs)
    per_pattern = pruning.root_log_likelihood(
        buf, logs, torch.as_tensor(enc.root), eig.pi, props
    ).numpy()[:, : sp.pattern_count]
    log_prior = -np.log(len(trees))
    exact = float((logsumexp(per_pattern, axis=0) + log_prior) @ sp.weights)
    reps = [dag.indexer_representation_of_topology(t.topology) for t in trees]
    per_edge = {}
    for e in range(dag.edge_count()):
        members = [i for i, rep in enumerate(reps) if e in rep]
        if members:
            per_edge[e] = float((logsumexp(per_pattern[members], axis=0)
                                 + log_prior) @ sp.weights)
    return exact, per_edge


@pytest.mark.parametrize("optimize_first", [False, True])
def test_composite_marginal_equals_the_exact_marginal(tmp_path,
                                                      optimize_first):
    """tests/test_gp.py's oracle on a synthetic five-taxon set: the GP
    composite marginal equals the brute-force marginal over every
    topology of the DAG (each with the GP branch lengths), before and after
    optimization, and so does each PCSP's component."""
    nwk, fasta = _write(tmp_path, 9, 5, 5, 3, 80)
    inst = gp_instance(device="cpu", dtype=F64)
    inst.read_fasta_file(fasta)
    inst.read_newick_file(nwk)
    inst.make_gp_engine()
    inst.take_first_branch_length()
    if optimize_first:
        inst.estimate_branch_lengths(1e-5, 8)
    inst.populate_plvs()
    inst.compute_likelihoods()
    complete = inst.generate_complete_rooted_tree_collection()
    assert len(complete.trees) == int(inst.get_dag().topology_count()) > 3
    exact, per_edge = _exact_marginal(complete, read_fasta(fasta),
                                      inst.get_dag())
    tol = 1e-6 if optimize_first else 1e-10
    assert abs(inst.get_log_marginal_likelihood() - exact) < tol
    comps = inst.get_gp_engine().per_gpcsp_components_of_full_log_marginal()
    for e, value in per_edge.items():
        assert abs(comps[e] - value) < max(tol, 1e-5), e


def test_float32_engine_matches_float64(files):
    """The engine in float32 (the card's dtype, here on the CPU) against
    float64 at the same state: the log marginal and the per-PCSP LLs
    within 5e-5 relative, every PLV finite (the padded entries too)."""
    j, t64 = _instances(files)
    _, t32 = _instances(files, dtype=torch.float32)
    for inst in (t64, t32):
        inst.populate_plvs()
        inst.compute_likelihoods()
    e32 = t32.get_gp_engine()
    assert e32.plv.dtype == torch.float32 and torch.isfinite(e32.plv).all()
    assert _rel(t32.get_log_marginal_likelihood(),
                t64.get_log_marginal_likelihood()) < 5e-5
    np.testing.assert_allclose(t32.get_per_gpcsp_log_likelihoods(),
                               t64.get_per_gpcsp_log_likelihoods(), rtol=5e-5)
    for inst in (t64, t32):
        inst.get_gp_engine().optimize_branch_lengths_once()
        inst.populate_plvs()
        inst.compute_likelihoods()
    assert torch.isfinite(e32.plv).all()
    assert _rel(t32.get_log_marginal_likelihood(),
                t64.get_log_marginal_likelihood()) < 5e-5


def test_cuda_engine_raises_without_a_card(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gp_instance()
    with pytest.raises(ValueError, match="Unknown optimization method"):
        _instances(files)[1].set_optimization_method("lbfgs")
