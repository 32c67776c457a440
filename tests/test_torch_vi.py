"""The port's VBPI trainer (bito_tpu_torch/vi, on the port's instance on
the CPU in float64) against bito_tpu.vi: the scalar models' samples and
Jacobians (torch.func.jacfwd against jax.jacfwd, within 1e-12), the Adam
step on the same gradients, three Burrito steps from one seed in both
branch models and both optimizers (ELBO trace, SBN parameters and
q_params within 1e-8), and a trainer's state carried from bito_tpu into
the port by convert.load_burrito_state."""
import numpy as np
import pytest
import torch

from bito_tpu.models.phylo_model import PhyloModelSpecification as JaxSpec
from bito_tpu.vi import optimizers as jax_optimizers
from bito_tpu.vi import scalar_model as jax_scalar_model
from bito_tpu.vi.burrito import Burrito as JaxBurrito
from bito_tpu_torch import TEST_DEVICE, TEST_DTYPE, _synthetic
from bito_tpu_torch.convert import BURRITO_STATE, load_burrito_state
from bito_tpu_torch.models.phylo_model import PhyloModelSpecification
from bito_tpu_torch.vi import optimizers, scalar_model
from bito_tpu_torch.vi.burrito import Burrito

from torch_port_cases import one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


SCALAR_MODELS = ["lognormal", "jax_lognormal", "jax_gamma",
                 "jax_truncated_lognormal"]
TAXA, MCMC_TREES, SITES, PARTICLES = 10, 10, 200, 4
SPEC = ("JC69", "constant", "strict")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _synthetic.write_vbpi_inputs(tmp_path_factory.mktemp("vbpi"), 21,
                                        TAXA, MCMC_TREES, SITES)


def _scalar_pair(name, variables=7, seed=4):
    """bito_tpu's scalar model and the port's, with the same random
    q_params and rng seed."""
    rng = np.random.default_rng(seed)
    out = [module.of_name(name, variables)
           for module in (jax_scalar_model, scalar_model)]
    jitter = rng.uniform(-0.2, 0.2, out[0].q_params.shape)
    for model in out:
        model.q_params[:] += jitter
        model.rng = np.random.default_rng(seed + 1)
    return out


def _which(variables, size, particles, seed):
    rng = np.random.default_rng(seed)
    return [rng.permutation(variables)[:size] for _ in range(particles)]


@pytest.mark.parametrize("name", SCALAR_MODELS)
def test_scalar_model_samples_and_jacobians_match(name):
    j, t = _scalar_pair(name)
    assert type(t).__name__ == ("LogNormalModel" if name == "lognormal"
                                else "TorchScalarModel")
    wv = _which(7, 5, 6, seed=9)
    for want, got in zip(j.sample_and_gradients(wv),
                         t.sample_and_gradients(wv), strict=True):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(t.sample(wv), j.sample(wv), rtol=1e-12)
    np.testing.assert_allclose(t.sample_all(3), j.sample_all(3), rtol=1e-12)
    values = j.sample(wv)[0]
    assert t.log_prob(values, wv[0]) == pytest.approx(
        j.log_prob(values, wv[0]), rel=1e-12)
    modes = np.linspace(0.01, 0.3, 7)
    j.mode_match(modes)
    t.mode_match(modes)
    np.testing.assert_array_equal(t.q_params, j.q_params)
    np.testing.assert_allclose(t.suggested_step_size(),
                               j.suggested_step_size(), rtol=1e-15)


def test_prebaked_lognormal_sample_matches():
    j, t = _scalar_pair("jax_lognormal")
    wv = [np.arange(7)] * 4
    sample = j.sample(wv)
    for want, got in zip(j.sample_and_gradients(wv, prebaked_sample=sample),
                         t.sample_and_gradients(wv, prebaked_sample=sample)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    with pytest.raises(ValueError, match="prebaked"):
        scalar_model.of_name("jax_gamma", 7).sample_and_gradients(
            wv, prebaked_sample=sample)


class _Params:
    def __init__(self, name, shape, seed):
        setattr(self, name, np.random.default_rng(seed).normal(size=shape))


@pytest.mark.parametrize("name", ["simple", "bump"])
def test_adam_steps_match(name):
    """Both optimizers on the same gradients, a non-finite one among them:
    the parameters, the moments and the step sizes agree."""
    elbos = iter(np.linspace(-100.0, -90.0, 12)[[0, 1, 2, 3, 2, 1, 0, 4, 5,
                                                 6, 7, 8]])
    opts = []
    for module in (jax_optimizers, optimizers):
        scalar = _Params("q_params", (5, 2), 1)
        scalar.suggested_step_size = lambda s=scalar: np.average(
            np.abs(s.q_params), axis=0) / 100
        sbn = _Params("sbn_parameters", (9,), 2)
        opts.append(module.of_name(name, sbn, scalar,
                                   lambda particle_count: 0.0))
    rng = np.random.default_rng(3)
    for step in range(12):
        grads = {"scalar_params": rng.normal(size=(5, 2)),
                 "sbn_params": rng.normal(size=9)}
        if step == 4:
            grads["scalar_params"][0, 0] = np.nan
        elbo = next(elbos)
        for opt in opts:
            opt.estimate_elbo = lambda particle_count, e=elbo: e
            opt.gradient_step({k: v.copy() for k, v in grads.items()})
    j, t = opts
    np.testing.assert_array_equal(t.scalar_model.q_params,
                                  j.scalar_model.q_params)
    np.testing.assert_array_equal(t.sbn_model.sbn_parameters,
                                  j.sbn_model.sbn_parameters)
    assert t.adam_count == j.adam_count == 11
    for k in ("scalar_params", "sbn_params"):
        np.testing.assert_array_equal(t.adam_mu[k], j.adam_mu[k])
        np.testing.assert_array_equal(t.adam_nu[k], j.adam_nu[k])
    np.testing.assert_array_equal(t.step_size, j.step_size)
    assert t.step_number == j.step_number
    t.set_adam_state(3, j.adam_mu, j.adam_nu)
    assert t.adam_count == 3 and t.opt_state.count.dtype == np.int32


def _burritos(files, branch_model, scalar_model_name, optimizer, seed=5,
              torch_seed=None):
    nexus, fasta = files
    kw = dict(mcmc_nexus_path=nexus, burn_in_fraction=0.0, fasta_path=fasta,
              branch_model_name=branch_model,
              scalar_model_name=scalar_model_name, optimizer_name=optimizer,
              particle_count=PARTICLES)
    j = JaxBurrito(phylo_model_specification=JaxSpec(*SPEC), seed=seed, **kw)
    t = Burrito(phylo_model_specification=PhyloModelSpecification(*SPEC),
                seed=seed if torch_seed is None else torch_seed,
                device=TEST_DEVICE, dtype=TEST_DTYPE, **kw)
    return j, t


def _assert_same_state(j, t, tol):
    np.testing.assert_allclose(t.inst.sbn_parameters, j.inst.sbn_parameters,
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(t.branch_model.scalar_model.q_params,
                               j.branch_model.scalar_model.q_params,
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("branch_model, optimizer",
                         [("split", "simple"), ("split", "bump"),
                          ("psp", "simple"), ("psp", "bump")])
def test_burrito_steps_match(files, branch_model, optimizer):
    j, t = _burritos(files, branch_model, "lognormal", optimizer)
    j.gradient_steps(3)
    t.gradient_steps(3)
    assert t.inst.engine._shared_model(t.inst._params_dict())
    np.testing.assert_allclose(t.elbo_trace, j.elbo_trace, rtol=1e-8)
    np.testing.assert_allclose(t.opt.trace, j.opt.trace, rtol=1e-8)
    _assert_same_state(j, t, 1e-8)
    assert [x.topology.key() for x in t.inst.tree_collection.trees] == [
        x.topology.key() for x in j.inst.tree_collection.trees]


def test_burrito_with_an_autodiff_scalar_model_matches(files):
    j, t = _burritos(files, "split", "jax_gamma", "simple")
    j.gradient_steps(2)
    t.gradient_steps(2)
    np.testing.assert_allclose(t.elbo_trace, j.elbo_trace, rtol=1e-8)
    _assert_same_state(j, t, 1e-8)


def _state_of(burrito):
    """A bito_tpu Burrito's state as numpy, as load_burrito_state takes
    it."""
    opt = burrito.opt
    return dict(
        sbn_parameters=np.array(burrito.inst.sbn_parameters),
        q_params=np.array(burrito.branch_model.scalar_model.q_params),
        scalar_rng_state=burrito.branch_model.scalar_model.rng.bit_generator
        .state,
        topology_rng_state=burrito.inst.rng.bit_generator.state,
        adam_count=opt.adam_count, adam_mu=opt.adam_mu, adam_nu=opt.adam_nu,
        step_size=np.array(opt.step_size), sbn_step_size=opt.sbn_step_size,
        step_number=opt.step_number,
        phylo_model_params=np.array(burrito.inst.phylo_model_params))


@pytest.mark.parametrize("branch_model", ["split", "psp"])
def test_state_carried_from_bito_tpu_reproduces_the_next_step(files,
                                                              branch_model):
    """K steps in bito_tpu, the state carried into a port trainer that
    started from another seed, then one more step in both."""
    j, t = _burritos(files, branch_model, "lognormal", "simple",
                     torch_seed=99)
    j.gradient_steps(2)
    state = _state_of(j)
    assert set(state) == set(BURRITO_STATE)
    load_burrito_state(t, state)
    _assert_same_state(j, t, 0.0)
    assert t.opt.adam_count == j.opt.adam_count == 2
    j.gradient_step()
    t.gradient_step()
    _assert_same_state(j, t, 1e-8)
    assert t.estimate_elbo(PARTICLES) == pytest.approx(
        j.estimate_elbo(PARTICLES), rel=1e-8)
    with pytest.raises(KeyError, match="adam_mu"):
        load_burrito_state(t, {k: v for k, v in state.items()
                               if k != "adam_mu"})
