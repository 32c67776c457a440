"""The port's substitution, site and clock models against bito_tpu's, in
float64 within 1e-12.  Transition matrices are compared, not
eigenvectors, whose signs eigh may choose differently."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu.models import site as jsite
from bito_tpu.models import substitution as jsub
from bito_tpu.models.phylo_model import PhyloModel as JaxModel
from bito_tpu.models.phylo_model import PhyloModelSpecification as JaxSpec
from bito_tpu_torch.models import site as tsite
from bito_tpu_torch.models import substitution as tsub
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.treelike import prep, pruning

from torch_port_cases import GTR, MODELS

TOL = 1e-12
F64 = dict(device="cpu", dtype=torch.float64)
TIMES = np.array([0.0, 1e-4, 0.02, 0.1, 0.4, 1.5, 7.0])


def _t(x):
    return torch.as_tensor(np.asarray(x), **F64)


def _eigens():
    rates = GTR["substitution_model_rates"]
    freqs = GTR["substitution_model_frequencies"]
    hky_f = np.array([0.2, 0.3, 0.3, 0.2])
    return {
        "jc69": (jsub.jc69_eigen(jnp.float64), tsub.jc69_eigen(**F64)),
        "hky": (jsub.hky_eigen(jnp.asarray(2.5), jnp.asarray(hky_f)),
                tsub.hky_eigen(_t(2.5), _t(hky_f))),
        "gtr": (jsub.gtr_eigen(jnp.asarray(rates), jnp.asarray(freqs)),
                tsub.gtr_eigen(_t(rates), _t(freqs))),
    }


@pytest.mark.parametrize("model", ["jc69", "hky", "gtr"])
@pytest.mark.parametrize("fn", ["transition_matrices", "transition_derivatives"])
def test_transition_matrices(model, fn):
    je, te = _eigens()[model]
    ref = np.asarray(getattr(jsub, fn)(je, jnp.asarray(TIMES)))
    got = getattr(tsub, fn)(te, _t(TIMES)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_gtr_q_and_pi():
    rates = GTR["substitution_model_rates"]
    freqs = GTR["substitution_model_frequencies"]
    ref = np.asarray(jsub.build_gtr_q(jnp.asarray(rates), jnp.asarray(freqs)))
    np.testing.assert_allclose(tsub.build_gtr_q(_t(rates), _t(freqs)).numpy(),
                               ref, rtol=0, atol=TOL)
    te = tsub.gtr_eigen(_t(rates), _t(freqs))
    np.testing.assert_allclose(tsub.rate_matrix_of(te).numpy(), ref,
                               rtol=0, atol=TOL)


def test_batched_gtr_rows_match_one_by_one():
    """Per-tree rows [B, 6] give, row by row, bito_tpu's P(t)."""
    rng = np.random.default_rng(5)
    rates = rng.uniform(0.05, 1.0, size=(3, 6))
    rates /= rates.sum(axis=1, keepdims=True)
    freqs = rng.uniform(0.1, 1.0, size=(3, 4))
    freqs /= freqs.sum(axis=1, keepdims=True)
    te = tsub.gtr_eigen(_t(rates), _t(freqs))
    te = tsub.EigenDecomp(te.U[:, None], te.values[:, None],
                          te.U_inv[:, None], te.pi)
    got = tsub.transition_matrices(te, _t(np.tile(TIMES, (3, 1)))).numpy()
    for b in range(3):
        je = jsub.gtr_eigen(jnp.asarray(rates[b]), jnp.asarray(freqs[b]))
        ref = np.asarray(jsub.transition_matrices(je, jnp.asarray(TIMES)))
        np.testing.assert_allclose(got[b], ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", [0.1, 0.5, 1.0, 3.0, 20.0])
@pytest.mark.parametrize("count", [2, 4, 8])
def test_gamma_rates(shape, count):
    ref = np.asarray(jsite.gamma_median_category_rates(jnp.asarray(shape),
                                                       count))
    got = tsite.gamma_median_category_rates(_t(shape), count).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=0)


@pytest.mark.parametrize("shape", [0.3, 1.0, 2.5])
def test_weibull_rates(shape):
    ref = np.asarray(jsite.weibull_category_rates(jnp.asarray(shape), 4))
    got = tsite.weibull_category_rates(_t(shape), 4).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=0)


def test_batched_gamma_rates():
    shapes = np.array([0.2, 0.5, 4.0])
    got = tsite.gamma_median_category_rates(_t(shapes), 4).numpy()
    for b, a in enumerate(shapes):
        ref = np.asarray(jsite.gamma_median_category_rates(jnp.asarray(a), 4))
        np.testing.assert_allclose(got[b], ref, rtol=TOL, atol=0)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_phylo_model_blocks_and_defaults(model):
    (sub, site), _ = MODELS[model]
    for clock in ("none", "strict"):
        jm = JaxModel(JaxSpec(sub, site, clock))
        tm = PhyloModel(PhyloModelSpecification(sub, site, clock))
        assert jm.blocks == tm.blocks and jm.param_count == tm.param_count
        np.testing.assert_array_equal(jm.default_param_vector(),
                                      tm.default_param_vector())


def test_kernel_dP_is_the_derivative():
    """prep's dP = rate*clock*Q P agrees with the eigen-route derivative the
    scan tape uses, and is zero on the identity edge."""
    rates = GTR["substitution_model_rates"]
    freqs = GTR["substitution_model_frequencies"]
    te = tsub.gtr_eigen(_t(rates), _t(freqs))
    B = 2
    eig = tsub.EigenDecomp(*(x.expand((B,) + x.shape) for x in te))
    cat = tsite.gamma_median_category_rates(_t(0.5), 4).expand(B, 4)
    clock = _t([1.0, 1.3])
    bl = _t(np.random.default_rng(0).uniform(0.02, 0.4, size=(B, 5)))
    _, dP = prep.prepare_inputs_grad_q(eig, cat, clock, bl)
    ref = pruning.transition_matrices_ext(eig, bl, cat, clock,
                                          derivative=True)
    np.testing.assert_allclose(dP.double().numpy(), ref.numpy(), atol=2e-6)
    assert not dP[:, -1].any()
