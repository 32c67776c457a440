"""The port's unrooted instance (bito_tpu_torch/api/instances.py, CPU,
float64) against bito_tpu.api.instances.unrooted_instance on the same
Nexus and FASTA files: ingest, SBN training and sampling, the CSV of SBN
parameters, log likelihoods and phylo gradients (within 1e-10 relative),
and the parameter rows the instance hands its engine: one shared 1-D row
where every tree's model is the same, per-tree 2-D rows otherwise, with
the same results either way."""
import numpy as np
import pytest
import torch

from bito_tpu.api.instances import unrooted_instance as jax_instance
from bito_tpu.models.phylo_model import PhyloModelSpecification as JaxSpec
from bito_tpu_torch import TEST_DEVICE, TEST_DTYPE, _synthetic
from bito_tpu_torch.api.instances import unrooted_instance
from bito_tpu_torch.models.phylo_model import PhyloModelSpecification

from torch_port_cases import GTR, one_torch_thread, per_tree_rows


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


TOL = 1e-10
TAXA, MCMC_TREES, SITES, SAMPLED = 10, 12, 200, 6
SPECS = {
    "jc69_strict": (("JC69", "constant", "strict"), {}),
    "gtr_gamma4": (("GTR", "gamma+4", "none"), GTR),
    "hky_weibull4": (("HKY", "weibull+4", "none"), {
        "substitution_model_rates": np.array([2.5]),
        "substitution_model_frequencies": np.array([0.2, 0.3, 0.3, 0.2]),
        "site_model_parameters": np.array([1.3]),
    }),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _synthetic.write_vbpi_inputs(tmp_path_factory.mktemp("vbpi"), 11,
                                        TAXA, MCMC_TREES, SITES)


def _pair(files, seed=3):
    """bito_tpu's instance and the port's, each fed the same files and
    trained by simple average, with the same topology rng."""
    nexus, fasta = files
    out = []
    for inst in (jax_instance("jax"), unrooted_instance(
            "torch", device=TEST_DEVICE, dtype=TEST_DTYPE)):
        inst.read_nexus_file(nexus)
        inst.process_loaded_trees()
        inst.read_fasta_file(fasta)
        inst.train_simple_average()
        inst.rng = np.random.default_rng(seed)
        out.append(inst)
    return out


def _prepared(files, spec, seed=3):
    """The pair with SAMPLED trees drawn from the SBN, random branch
    lengths, and the spec's model parameters in every tree's row."""
    (subst, site, clock), params = SPECS[spec]
    j, t = _pair(files, seed)
    rng = np.random.default_rng(seed + 1)
    for inst, Spec in ((j, JaxSpec), (t, PhyloModelSpecification)):
        inst.sample_trees(SAMPLED)
        inst.prepare_for_phylo_likelihood(Spec(subst, site, clock), 1)
        blocks = inst.get_phylo_model_param_block_map()
        for key, value in params.items():
            blocks[key][:] = value
    for jt, tt in zip(j.tree_collection.trees, t.tree_collection.trees,
                      strict=True):
        assert jt.topology.key() == tt.topology.key()
        tt.branch_lengths[:] = jt.branch_lengths[:] = rng.uniform(
            0.01, 0.3, jt.branch_lengths.shape)
    return j, t


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _gradients(inst):
    pgs = inst.phylo_gradients()
    return (np.array([g.log_likelihood() for g in pgs]),
            [g.gradient["branch_lengths"] for g in pgs])


def test_ingest_from_files(files):
    j, t = _pair(files)
    assert t.tree_count() == j.tree_count() == MCMC_TREES
    assert t.taxon_names() == j.taxon_names()
    for jt, tt in zip(j.tree_collection.trees, t.tree_collection.trees,
                      strict=True):
        assert jt.topology.key() == tt.topology.key()
        np.testing.assert_array_equal(jt.branch_lengths, tt.branch_lengths)
    assert t.alignment == j.alignment
    assert t.pretty_indexer() == j.pretty_indexer()
    assert t.split_counters() == j.split_counters()
    assert t.psp_indexer.details() == j.psp_indexer.details()
    assert t.make_psp_indexer_representations() == (
        j.make_psp_indexer_representations())
    assert [np.array(r).tolist() for r in t.make_indexer_representations()] \
        == [np.array(r).tolist() for r in j.make_indexer_representations()]
    np.testing.assert_allclose(t.sbn_parameters, j.sbn_parameters,
                               rtol=1e-12, atol=1e-12)
    assert [sorted(x) for x in t.split_lengths()] == [
        sorted(x) for x in j.split_lengths()]


def test_sample_trees_and_probabilities_match(files):
    j, t = _pair(files, seed=8)
    for inst in (j, t):
        inst.sample_trees(20)
    assert [x.topology.key() for x in t.tree_collection.trees] == [
        x.topology.key() for x in j.tree_collection.trees]
    np.testing.assert_allclose(t.calculate_sbn_probabilities(),
                               j.calculate_sbn_probabilities(), rtol=1e-12)
    np.testing.assert_allclose(t.normalized_sbn_parameters(),
                               j.normalized_sbn_parameters(), rtol=1e-12)


@pytest.mark.parametrize("spec", SPECS)
def test_likelihoods_and_gradients_match_bito_tpu(files, spec):
    j, t = _prepared(files, spec)
    assert _rel(t.log_likelihoods(), j.log_likelihoods()) <= TOL
    jll, jg = _gradients(j)
    tll, tg = _gradients(t)
    assert _rel(tll, jll) <= TOL
    for a, b in zip(tg, jg, strict=True):
        assert a.shape == b.shape
        assert _rel(a, b) <= TOL


@pytest.mark.parametrize("spec", SPECS)
def test_params_dict_rows(files, spec):
    """Equal rows: one shared 1-D row a block, so the engine sees a shared
    model; differing rows: 2-D rows.  Both give bito_tpu's results, which
    always come from 2-D rows."""
    j, t = _prepared(files, spec)
    params = t._params_dict()
    assert set(params) == set(t.phylo_model.blocks)
    assert all(v.dim() == 1 for v in params.values())
    assert t.engine._shared_model(params)
    trees = t.tree_collection.trees
    tiled = {k: v.expand(len(trees), -1) for k, v in params.items()}
    ll_shared, g_shared = t.engine.ll_and_branch_gradients(trees, params)
    ll_tiled, g_tiled = t.engine.ll_and_branch_gradients(trees, tiled)
    assert _rel(ll_shared, ll_tiled) <= TOL
    assert _rel(g_shared, g_tiled) <= TOL

    rows = per_tree_rows(SPECS[spec][1], SAMPLED, seed=5)
    if not rows:  # a model with no free parameter but the clock's rate
        rows = {"clock_model_rates": np.linspace(0.8, 1.2, SAMPLED)[:, None]}
    for inst in (j, t):
        blocks = inst.get_phylo_model_param_block_map()
        for key, value in rows.items():
            blocks[key][:] = value
    params = t._params_dict()
    assert all(v.dim() == 2 and v.shape[0] == SAMPLED
               for v in params.values())
    assert not t.engine._shared_model(params)
    assert _rel(t.log_likelihoods(), j.log_likelihoods()) <= TOL
    jll, jg = _gradients(j)
    tll, tg = _gradients(t)
    assert _rel(tll, jll) <= TOL
    assert all(_rel(a, b) <= TOL for a, b in zip(tg, jg, strict=True))


@pytest.mark.parametrize("spec", SPECS)
def test_cuda_route_on_the_cpu_equals_the_scan_tape(files, spec):
    """kernel="cuda" runs the paired kernels' plain versions on the CPU;
    with the instance's shared row it gives the scan tape's results, and
    with per-tree rows it refuses."""
    _, t = _prepared(files, spec)
    t.engine.kernel = "scan"
    ll_scan, g_scan = _gradients(t)
    t.engine.kernel = "cuda"
    ll_cuda, g_cuda = _gradients(t)
    assert _rel(t.log_likelihoods(), ll_scan) <= TOL
    assert _rel(ll_cuda, ll_scan) <= TOL
    assert all(_rel(a, b) <= TOL for a, b in zip(g_cuda, g_scan, strict=True))
    t.phylo_model_params[0] *= 1.01
    with pytest.raises(ValueError, match="per-tree"):
        t.phylo_gradients()


def test_csv_round_trip(files, tmp_path):
    j, t = _pair(files)
    t.sbn_parameters_to_csv(tmp_path / "torch.csv")
    j.sbn_parameters_to_csv(tmp_path / "jax.csv")
    for path in ("torch.csv", "jax.csv"):
        _, back = _pair(files)
        back.sbn_parameters = np.zeros_like(back.sbn_parameters)
        back.read_sbn_parameters_from_csv(tmp_path / path)
        np.testing.assert_allclose(back.normalized_sbn_parameters(),
                                   t.normalized_sbn_parameters(), rtol=1e-12)
    rows = [line.split(",")[0] for line in
            (tmp_path / "torch.csv").read_text().splitlines()]
    assert rows == t.pretty_indexer()


@pytest.mark.parametrize("alpha, score_epsilon", [(0.0, 0.0), (0.3, 1e-5)])
def test_em_on_the_instance(files, alpha, score_epsilon):
    """The device backend (torch on the CPU here) against the numpy
    backend and against bito_tpu's device backend."""
    j, t = _pair(files)
    want = j.train_expectation_maximization(alpha, 30, score_epsilon)
    want_params = j.sbn_parameters.copy()
    score = t.train_expectation_maximization(alpha, 30, score_epsilon)
    params = t.sbn_parameters.copy()
    np.testing.assert_allclose(score, want, rtol=TOL)
    np.testing.assert_allclose(params, want_params, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        t.train_expectation_maximization(alpha, 30, score_epsilon,
                                         backend="numpy"), score, rtol=TOL)
    # The numpy loop adds in log space; the device loop (bito_tpu's and the
    # port's alike) in linear space after a shift, where a PCSP's mass
    # under exp(-745) of the largest is 0: -inf beside a log value far
    # below that, the same probability.
    numpy = t.sbn_parameters
    tiny = numpy < -745.0
    assert np.isneginf(params[tiny]).all() and np.isfinite(params[~tiny]).all()
    np.testing.assert_allclose(params[~tiny], numpy[~tiny], rtol=TOL,
                               atol=TOL)
    with pytest.raises(ValueError, match="backend"):
        t.train_expectation_maximization(alpha, 30, backend="xla")


@pytest.mark.parametrize("use_vimco", [True, False])
def test_topology_gradients_on_the_instance(files, use_vimco):
    j, t = _pair(files, seed=4)
    log_f = np.random.default_rng(2).normal(-50.0, 3.0, 8)
    for inst in (j, t):
        inst.sample_trees(8)
    want = j.topology_gradients(log_f, use_vimco)
    got = t.topology_gradients(log_f, use_vimco)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * scale
    np.testing.assert_allclose(t.topology_gradients(log_f, use_vimco,
                                                    backend="numpy"), got,
                               rtol=0, atol=TOL * scale)


def test_instance_takes_the_card_by_default_and_never_falls_back():
    """The default device is the card; where none is visible the instance
    refuses rather than running on the CPU."""
    if torch.cuda.is_available():
        inst = unrooted_instance("default")
        assert inst.device.type == "cuda" and inst.dtype == torch.float32
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            unrooted_instance("default")
