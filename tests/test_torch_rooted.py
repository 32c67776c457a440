"""The port's rooted time-tree instance against bito_tpu's, in float64 on
synthetic dated inputs (bito_tpu_torch._synthetic): the copied numpy
modules by their code; the stick-breaking pair; tip dates from names, a
CSV and constant; log likelihoods with and without the log-det Jacobian,
the Jacobian and its gradient, and every phylo_gradients key within 1e-10
(the model keys, from autodiff through different programs, within 1e-8);
the instance in float32 against float64;
the clock gradient against central differences; the unconditional
subsplit probabilities; and the on-chip bodies' float64 emulation on the
bifurcating root against the scan tape."""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bito_tpu.api.instances import rooted_instance as jax_rooted_instance
from bito_tpu.models import site as jax_site
from bito_tpu.models.phylo_model import PhyloModelSpecification as JaxSpec
from bito_tpu.models.transforms import (
    stick_breaking_forward as jax_stick_forward,
    stick_breaking_inverse as jax_stick_inverse)
from bito_tpu_torch import _synthetic
from bito_tpu_torch.api.instances import rooted_instance
from bito_tpu_torch.convert import load_rooted_state, rooted_state
from bito_tpu_torch.models import site
from bito_tpu_torch.models.phylo_model import PhyloModelSpecification
from bito_tpu_torch.models.transforms import (stick_breaking_forward,
                                              stick_breaking_inverse)
from bito_tpu_torch.treelike import paired, prep

from torch_port_cases import (emulate_grad, emulate_ll, max_norm, max_rel,
                              one_torch_thread, without_docstrings)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


ROOT = pathlib.Path(__file__).resolve().parent.parent
F64 = torch.float64
RATE = 0.001  # test_rooted.py's strict-clock rate

# (substitution, site): JC69 with constant rates, and GTR/HKY with
# Weibull4/Gamma4; each with a strict clock.
SPECS = [("JC69", "constant"), ("GTR", "weibull+4"), ("GTR", "gamma+4"),
         ("HKY", "weibull+4"), ("HKY", "gamma+4")]
# test_rooted.py's parameter values.
PARAMS = {"substitution_model_frequencies": [0.1, 0.2, 0.3, 0.4],
          "site_model_parameters": [0.7]}
SUBST_RATES = {"GTR": [0.05, 0.1, 0.15, 0.20, 0.25, 0.25], "HKY": [3.0]}
MODEL_KEYS = ("substitution_model", "site_model")  # from autodiff


@pytest.mark.parametrize("module", ["treelike/rooted.py",
                                    "dag/subsplit_dag.py", "dag/graft.py"])
def test_copied_module_code_is_identical(module):
    """Apart from docstrings, the copied modules are bito_tpu's code."""
    assert (without_docstrings(ROOT / "bito_tpu_torch" / module)
            == without_docstrings(ROOT / "bito_tpu" / module))


@pytest.mark.parametrize("K", [2, 4, 6])
def test_stick_breaking_pair_matches_bito_tpu(K):
    rng = np.random.default_rng(K)
    y = rng.normal(size=(3, K - 1))
    got = stick_breaking_forward(torch.as_tensor(y, dtype=F64)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_stick_forward(
        jnp.asarray(y))), rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(got.sum(axis=-1), 1.0, rtol=1e-14)
    x = rng.dirichlet(np.ones(K))
    y0 = stick_breaking_inverse(x)
    np.testing.assert_array_equal(y0, jax_stick_inverse(x))
    np.testing.assert_allclose(
        stick_breaking_forward(torch.as_tensor(y0)).numpy(), x, rtol=1e-13)
    # The Jacobian by forward mode on both sides.
    jac = torch.func.jacfwd(stick_breaking_forward)(torch.as_tensor(y0))
    np.testing.assert_allclose(jac.numpy(), np.asarray(
        jax.jacfwd(jax_stick_forward)(jnp.asarray(y0))), rtol=1e-12,
        atol=1e-14)


@pytest.mark.parametrize("shape", [0.1, 0.5, 1.0, 3.0, 20.0])
def test_gamma_rates_derivative_matches_jax_jacfwd(shape):
    """The Gamma quantile's implicit derivative (reverse mode, one row of
    the Jacobian a rate) against jax.jacfwd through bito_tpu's 30 Newton
    steps: d rates / d shape at K = 4."""
    got = torch.autograd.functional.jacobian(
        lambda a: site.gamma_median_category_rates(a, 4),
        torch.tensor(shape, dtype=F64))
    want = jax.jacfwd(lambda a: jax_site.gamma_median_category_rates(a, 4))(
        jnp.asarray(shape))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12)


def _inputs(tmp_path, seed, num_taxa, num_trees, num_sites=60,
            date_span=_synthetic.DATE_SPAN):
    """Write dated trees, their alignment and the dates as a CSV; returns
    (newick path, fasta path, csv path)."""
    text, dates = _synthetic.dated_trees_newick(seed, num_taxa, num_trees,
                                                date_span)
    paths = [tmp_path / name for name in ("trees.nwk", "aln.fasta",
                                          "dates.csv")]
    paths[0].write_text(text)
    paths[1].write_text(_synthetic.fasta_text(_synthetic.random_alignment(
        seed + 7, list(dates), num_sites)))
    paths[2].write_text(_synthetic.dates_csv(dates))
    return [str(p) for p in paths]


def _instances(paths, spec, dates="names", native=True):
    """(bito_tpu's instance, the port's on the CPU in float64), each with
    the trees, the dates, the alignment and the model, test_rooted.py's
    parameters and rates."""
    nwk, fasta, csv = paths
    out = []
    for make, Spec, kw in ((jax_rooted_instance, JaxSpec, {}),
                           (rooted_instance, PhyloModelSpecification,
                            dict(device="cpu", dtype=F64, native=native))):
        inst = make("rooted", **kw)
        inst.read_newick_file(nwk)
        if dates == "names":
            inst.parse_dates_from_taxon_names(True)
        elif dates == "csv":
            inst.parse_dates_from_csv(csv, True)
        else:
            inst.set_dates_to_be_constant(True)
        inst.read_fasta_file(fasta)
        inst.prepare_for_phylo_likelihood(Spec(*spec, clock="strict"), 1)
        block = inst.get_phylo_model_param_block_map()
        for key, value in PARAMS.items():
            if key in block:
                block[key][:] = value
        if spec[0] in SUBST_RATES:
            block["substitution_model_rates"][:] = SUBST_RATES[spec[0]]
        for state in inst.tree_states:
            state.rates[:] = RATE
        out.append(inst)
    return out


@pytest.mark.parametrize("dates", ["names", "csv", "constant"])
def test_dates_and_time_trees_match(dates, tmp_path):
    paths = _inputs(tmp_path, 1, 9, 3,
                    date_span=0.0 if dates == "constant" else 20.0)
    jax_inst, inst = _instances(paths, ("JC69", "constant"), dates)
    assert len(inst.tree_states) == 3
    for js, ts in zip(jax_inst.tree_states, inst.tree_states, strict=True):
        for key in ("node_heights", "node_bounds", "height_ratios", "rates"):
            np.testing.assert_array_equal(getattr(js, key), getattr(ts, key))
    if dates != "constant":
        assert inst.tree_states[0].node_bounds[:9].max() > 0
    np.testing.assert_allclose(
        inst.log_likelihoods(), jax_inst.log_likelihoods(), rtol=1e-10)


@pytest.mark.parametrize("spec", SPECS)
def test_log_likelihoods_and_jacobian_match(spec, tmp_path):
    jax_inst, inst = _instances(_inputs(tmp_path, 2, 10, 3), spec)
    assert max_rel(inst.log_likelihoods(),
                   jax_inst.log_likelihoods()) < 1e-10
    assert max_rel(inst.log_likelihoods(include_log_det_jacobian=False),
                   jax_inst.log_likelihoods(include_log_det_jacobian=False)
                   ) < 1e-10
    assert max_rel(inst.log_det_jacobian_of_height_transform(),
                   jax_inst.log_det_jacobian_of_height_transform()) < 1e-10
    for got, want in zip(
            inst.gradient_log_det_jacobian_of_height_transform(),
            jax_inst.gradient_log_det_jacobian_of_height_transform(),
            strict=True):
        assert max_norm(got, want) < 1e-10


@pytest.mark.parametrize("spec", SPECS)
def test_every_gradient_key_matches(spec, tmp_path):
    """Every key of phylo_gradients within 1e-10 of bito_tpu's (max-abs
    over max |g|), the model keys within 1e-8: both come from autodiff
    through different programs (here one reverse pass and the Gamma
    quantile's implicit derivative, there jax.jacfwd through 30 Newton
    steps)."""
    jax_inst, inst = _instances(_inputs(tmp_path, 3, 11, 3), spec)
    got, want = inst.phylo_gradients(), jax_inst.phylo_gradients()
    keys = {"branch_lengths", "ratios_root_height", "clock_model",
            "clock_model_rates"}
    if spec[0] != "JC69":
        keys |= set(MODEL_KEYS)
    for g, w in zip(got, want, strict=True):
        assert set(g.gradient) == set(w.gradient) == keys
        assert max_rel(g.log_likelihood(), w.log_likelihood()) < 1e-10
        for key in keys:
            bound = 1e-8 if key in MODEL_KEYS else 1e-10
            assert np.shape(g.gradient[key]) == np.shape(w.gradient[key])
            assert max_norm(g.gradient[key], w.gradient[key]) < bound, key


def test_flags_restrict_the_map(tmp_path):
    jax_inst, inst = _instances(_inputs(tmp_path, 4, 8, 2),
                                ("GTR", "weibull+4"))
    flags = ["site_model"]
    got = inst.phylo_gradients(flags)[0].gradient
    want = jax_inst.phylo_gradients(flags)[0].gradient
    assert set(got) == set(want)
    for key in got:
        assert max_norm(got[key], want[key]) < 1e-8


def test_per_tree_model_rows_match(tmp_path):
    """Rows that differ between trees: per-tree rows to the engine (the
    scan tape), the same numbers as bito_tpu."""
    jax_inst, inst = _instances(_inputs(tmp_path, 5, 9, 3),
                                ("HKY", "gamma+4"))
    for i in (jax_inst, inst):
        i.get_phylo_model_param_block_map()["substitution_model_rates"][
            1] = 2.0
    assert inst._params_dict()["substitution_model_rates"].dim() == 2
    assert max_rel(inst.log_likelihoods(), jax_inst.log_likelihoods()) < 1e-10
    for g, w in zip(inst.phylo_gradients(), jax_inst.phylo_gradients(),
                    strict=True):
        assert max_norm(g.gradient["branch_lengths"],
                        w.gradient["branch_lengths"]) < 1e-10


def test_clock_gradient_vs_central_differences(tmp_path):
    """test_rooted.py's check: scale every rate of tree 0 by 1 +- eps."""
    _, inst = _instances(_inputs(tmp_path, 6, 10, 2), ("JC69", "constant"))
    clock = inst.phylo_gradients()[0].gradient["clock_model"][0]
    eps = 1e-6
    base = inst.tree_states[0].rates.copy()
    inst.tree_states[0].rates[:] = base * (1 + eps)
    lp = inst.log_likelihoods(include_log_det_jacobian=False)[0]
    inst.tree_states[0].rates[:] = base * (1 - eps)
    lm = inst.log_likelihoods(include_log_det_jacobian=False)[0]
    inst.tree_states[0].rates[:] = base
    fd = (lp - lm) / (2 * eps)
    # clock_model is sum_i dLL/db_i * t_i; the rate-scaled FD gives
    # sum_i dLL/db_i * t_i * rate_i.
    assert abs(fd - clock * RATE) < 1e-6 * max(1.0, abs(fd))


def test_unconditional_subsplit_probabilities_match(tmp_path):
    nwk, fasta, csv = _inputs(tmp_path, 7, 7, 6)
    got_want = []
    for inst in _instances((nwk, fasta, csv), ("JC69", "constant")):
        inst.process_loaded_trees()
        inst.train_simple_average()
        got_want.append(inst.unconditional_subsplit_probabilities())
        inst.unconditional_subsplit_probabilities_to_csv(
            str(tmp_path / f"usp{len(got_want)}.csv"))
    want, got = got_want
    assert list(got) == list(want) and len(got) > 6
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=1e-12)
    assert ((tmp_path / "usp1.csv").read_text()
            == (tmp_path / "usp2.csv").read_text())


def test_state_carried_from_bito_tpu(tmp_path):
    """Heights from random ratios in bito_tpu's instance, carried across
    (convert.rooted_state / load_rooted_state): the same likelihoods and
    ratio gradients."""
    from bito_tpu.treelike import rooted as jax_rooted

    jax_inst, inst = _instances(_inputs(tmp_path, 8, 9, 3),
                                ("GTR", "weibull+4"))
    rng = np.random.default_rng(8)
    for state in jax_inst.tree_states:
        ratios = state.height_ratios.copy()
        ratios[:-1] = rng.uniform(0.2, 0.8, ratios.size - 1)
        ratios[state.root_id - state.leaf_count] *= 1.5  # the root height
        jax_rooted.initialize_time_tree_using_height_ratios(state, ratios)
        state.rates[:] = rng.uniform(0.5, 2.0) * RATE
    jax_inst.get_phylo_model_param_block_map()["site_model_parameters"][:] = (
        1.7)
    load_rooted_state(inst, rooted_state(jax_inst))
    assert max_rel(inst.log_likelihoods(), jax_inst.log_likelihoods()) < 1e-10
    for g, w in zip(inst.phylo_gradients(), jax_inst.phylo_gradients(),
                    strict=True):
        for key in ("ratios_root_height", "clock_model_rates", "site_model"):
            bound = 1e-8 if key in MODEL_KEYS else 1e-10
            assert max_norm(g.gradient[key], w.gradient[key]) < bound


@pytest.mark.parametrize("spec,num_taxa", [(("GTR", "weibull+4"), 9),
                                           (("HKY", "gamma+4"), 16),
                                           (("JC69", "constant"), 23)])
def test_onchip_emulation_on_the_bifurcating_root(spec, num_taxa, tmp_path):
    """The on-chip bodies' schedule in float64 (torch_port_cases'
    emulations) on the rooted instance's trees and substitution lengths,
    against the scan tape, within 1e-10; the two branches below the root
    carry their gradients, and the paired plain versions (the CPU's
    kernel="cuda") agree too."""
    _, inst = _instances(_inputs(tmp_path, 9, num_taxa, 3), spec)
    eng, trees = inst.engine, inst.tree_collection.trees
    bl = inst._subst_branch_lengths()
    params = inst._params_dict()
    assert all(v.dim() == 1 for v in params.values())  # the shared row
    ll_ref, g_ref = eng.ll_and_branch_gradients(trees, params, bl)
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    pi, prop = prep.kernel_model(eig, props, F64)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl, F64)
    onchip = paired.onchip_tape(dst.numpy(), tip.numpy(), "cpu",
                                post_src=src.numpy(), post_e=e.numpy(),
                                edges=P.shape[1])
    tips, w = eng._kernel_tips, eng._kernel_weights
    ll = emulate_ll(dst, onchip.child, onchip.live_row, e, P, tips, pi, prop,
                    w)
    ll2, g = emulate_grad(dst, onchip.child, src, e, mask, P, dP, tips, pi,
                          prop, w)
    assert max_rel(ll.numpy(), ll_ref.numpy()) < 1e-10
    assert max_rel(ll2.numpy(), ll_ref.numpy()) < 1e-10
    assert max_norm(g.numpy(), g_ref.numpy()) < 1e-10
    for b, tree in enumerate(trees):
        root = tree.topology.root
        below = np.flatnonzero(tree.topology.parents == root)
        assert len(below) == 2 and (g[b, below] != 0).all()
    eng.kernel = "cuda"  # the paired wrappers: plain versions on the CPU
    ll_k, g_k = eng.ll_and_branch_gradients(trees, params, bl)
    assert max_rel(ll_k.numpy(), ll_ref.numpy()) < 1e-10
    assert max_norm(g_k.numpy(), g_ref.numpy()) < 1e-10
    eng.kernel = "auto"


@pytest.mark.parametrize("spec", SPECS[1:])
def test_float32_instance_matches_float64(spec, tmp_path):
    """The instance in float32 (the card's dtype; here the CPU's scan tape
    and plain versions) against float64 within 5e-5, every key, in the
    rooted oracle's regime: shape 0.1 (test_rooted.py's Weibull4) and a
    strict clock of 0.001 on joins 0.5-10 years apart, so substitution
    lengths from 0.0005; its model gradients stay in float32 through the
    autodiff."""
    paths = _inputs(tmp_path, 10, 12, 3)
    _, inst64 = _instances(paths, spec)
    inst64.get_phylo_model_param_block_map()["site_model_parameters"][:] = 0.1
    nwk, fasta, _ = paths
    inst = rooted_instance("rooted", device="cpu", dtype=torch.float32)
    inst.read_newick_file(nwk)
    inst.parse_dates_from_taxon_names(True)
    inst.read_fasta_file(fasta)
    inst.prepare_for_phylo_likelihood(
        PhyloModelSpecification(*spec, clock="strict"))
    inst.phylo_model_params = inst64.phylo_model_params.copy()
    for state in inst.tree_states:
        state.rates[:] = RATE
    assert max_rel(inst.log_likelihoods(), inst64.log_likelihoods()) < 5e-5
    for g, w in zip(inst.phylo_gradients(), inst64.phylo_gradients(),
                    strict=True):
        for key, value in w.gradient.items():
            assert max_norm(g.gradient[key], value) < 5e-5, key
        for key in ("branch_lengths",) + MODEL_KEYS:
            assert g.gradient[key].dtype == np.float32, key
