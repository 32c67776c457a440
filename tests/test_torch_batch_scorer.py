"""The port's batched proposed-NNI scorer (tp/batch_scorer.py) and its
copy of the faithful eval engine (tp/eval_engine.py), on the CPU in
float64.

The eval engine is bito_tpu's code but for one method, pinned by AST with
score_adjacent_nnis as the named exception: the port's runs the batched
scorer whenever use_batched_scorer is True, on the engine's device in
float64, and never falls back to the serial scorer in silence.  The
batched scores are held to the serial numpy scorer (score_proposed_nni)
and to bito_tpu's batched scores within 1e-10 relative, on a fresh search
and after DAG growth, for every candidate whose Brent line searches end
where the serial scorer's do (batch_scorer.scores_with_brent_traces).
Brent's parabolic steps magnify rounding: where the two scorers' searches
end at different points (a step decided by rounding; both are the
objective's maxima to Brent's tolerance, 2^-9 in log branch length), the
candidate is held by the LL it reaches within 1e-7 relative, as
test_torch_gp.py holds rounding-decided Brent argmins.  The masked Brent
repeats the scalar Brent lane by lane, exactly, whenever it reads its
all-done flag."""
import pathlib

import numpy as np
import pytest
import torch

from bito_tpu.core.newick import parse_newick_file as jax_parse_file
from bito_tpu.core.newick import read_fasta as jax_read_fasta
from bito_tpu.core.site_pattern import SitePattern as JaxSitePattern
from bito_tpu.dag.reference_order import (
    build_dag_reference_ordered as jax_build_dag)
from bito_tpu.nni.golden import GoldenNNISearch as JaxSearch
from bito_tpu_torch import _synthetic
from bito_tpu_torch.core.newick import parse_newick_file, read_fasta
from bito_tpu_torch.core.site_pattern import SitePattern
from bito_tpu_torch.dag.reference_order import build_dag_reference_ordered
from bito_tpu_torch.nni.golden import GoldenNNISearch, nni_sort_key
from bito_tpu_torch.tp import batch_scorer
from bito_tpu_torch.tp.eval_engine import brent_minimize_scalar

from torch_port_cases import without_docstrings

ROOT = pathlib.Path(__file__).resolve().parent.parent
BOUND = 1e-10
ROUNDED_BOUND = 1e-7  # a rounding-decided Brent step (test_torch_gp.py's)


def test_eval_engine_code_is_identical_but_score_adjacent_nnis():
    """Apart from docstrings and score_adjacent_nnis, tp/eval_engine.py is
    bito_tpu's code; with that method the modules differ."""
    drop = ("score_adjacent_nnis",)
    port = ROOT / "bito_tpu_torch/tp/eval_engine.py"
    ref = ROOT / "bito_tpu/tp/eval_engine.py"
    assert without_docstrings(port, drop) == without_docstrings(ref, drop)
    assert without_docstrings(port) != without_docstrings(ref)


def _searches(tmp_path, seed=1, taxa=8, sites=300, opt_max=2):
    """bito_tpu's and the port's GoldenNNISearch on the same synthetic NNI
    inputs, after run_init; the port's eval engine on the CPU."""
    paths = _synthetic.write_nni_inputs(tmp_path, seed, taxa, sites)
    out = []
    for parse, read, sp_cls, build, cls in (
            (jax_parse_file, jax_read_fasta, JaxSitePattern, jax_build_dag,
             JaxSearch),
            (parse_newick_file, read_fasta, SitePattern,
             build_dag_reference_ordered, GoldenNNISearch)):
        coll = parse(paths["seed.nwk"])
        sp = sp_cls(read(paths["alignment.fasta"]), coll.taxon_names)
        search = cls(build(coll), sp, coll.trees, opt_max=opt_max)
        search.run_init()
        out.append(search)
    out[1].engine.device = "cpu"
    return out


def _scores(search, nnis):
    """(batched, serial) scores of `nnis` on bito_tpu's search's state."""
    eng = search.engine
    best = eng.build_best_edge_map(nnis)
    batched = np.asarray(eng.score_proposed_nnis_batched(nnis, best))
    serial = np.array([eng.score_proposed_nni(nni, best) for nni in nnis])
    return batched, serial


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("seed,opt_max", [(1, 1), (1, 3), (0, 5)])
def test_batched_matches_bito_tpu_and_serial(tmp_path, seed, opt_max):
    """On the fresh search, and after two accepted NNIs (the grown DAG's
    locally refreshed PVs).  On seed 0 at opt_max 5, one candidate of the
    first set has a Brent step decided by rounding."""
    jax_search, search = _searches(tmp_path, seed=seed, opt_max=opt_max)
    rounded_any = []
    for _ in range(3):
        nnis = sorted(search.adjacent, key=nni_sort_key)
        jnnis = sorted(jax_search.adjacent, key=nni_sort_key)
        assert [(p.to_string(), c.to_string()) for p, c in nnis] == [
            (p.to_string(), c.to_string()) for p, c in jnnis]
        assert len(nnis) >= 4
        eng = search.engine
        batched, serial, rounded = batch_scorer.scores_with_brent_traces(
            eng, nnis, eng.build_best_edge_map(nnis))
        ref_batched, ref_serial = _scores(jax_search, jnnis)
        np.testing.assert_array_equal(serial, ref_serial)
        rel = np.abs(batched - serial) / np.abs(serial)
        assert np.all(rel[~rounded] < BOUND)
        assert np.all(rel[rounded] < ROUNDED_BOUND)
        rel = np.abs(batched - ref_batched) / np.abs(ref_batched)
        assert np.all(rel[~rounded] < BOUND)
        rounded_any.append(bool(rounded.any()))
        for s in (jax_search, search):
            assert s.run_main_loop()
            s.run_post_loop()
    assert rounded_any[0] == (seed == 0)


def test_score_adjacent_nnis_never_falls_back_in_silence(tmp_path,
                                                         monkeypatch):
    """With use_batched_scorer True, score_adjacent_nnis takes the batched
    scorer (no serial call) on the engine's device; asked for a card that
    is not there it raises rather than scoring serially; with
    use_batched_scorer False it scores serially."""
    _, search = _searches(tmp_path, seed=2, taxa=7, sites=200)
    eng = search.engine
    nnis = sorted(search.adjacent, key=nni_sort_key)
    calls = {"serial": 0}
    serial = eng.score_proposed_nni

    def counting(*args, **kwargs):
        calls["serial"] += 1
        return serial(*args, **kwargs)

    monkeypatch.setattr(eng, "score_proposed_nni", counting)
    scores = eng.score_adjacent_nnis(nnis)
    assert calls["serial"] == 0 and len(scores) == len(nnis)
    eng.device = "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eng.score_adjacent_nnis(nnis)
    assert calls["serial"] == 0
    del eng.device  # unset: the product device, the card
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eng.score_adjacent_nnis(nnis)
    eng.use_batched_scorer = False
    serial_scores = eng.score_adjacent_nnis(nnis)
    assert calls["serial"] == len(nnis)
    assert _rel(np.array(scores), np.array(serial_scores)) < ROUNDED_BOUND


def test_masked_brent_repeats_the_scalar_brent():
    """Each lane of the masked Brent ends where the scalar Brent ends on
    the same objective (polynomials, so that both evaluate them with the
    same roundings), whatever the all-done flag's reading interval;
    inactive lanes return their guess and its value."""
    rng = np.random.default_rng(0)
    K = 12
    a = rng.uniform(-10.0, 0.5, K)
    c = rng.uniform(0.1, 5.0, K)
    d = rng.uniform(0.0, 1.0, K)
    guess = rng.uniform(-12.0, 1.0, K)
    lo, hi = batch_scorer.MIN_LOG_BL, batch_scorer.MAX_LOG_BL

    def f_t(y):
        z = y - torch.as_tensor(a)
        return torch.as_tensor(c) * z * z + torch.as_tensor(d) * z * z * z * z

    want = [brent_minimize_scalar(
        lambda y, i=i: c[i] * (y - a[i]) * (y - a[i])
        + d[i] * (y - a[i]) * (y - a[i]) * (y - a[i]) * (y - a[i]),
        guess[i], lo, hi) for i in range(K)]
    active = torch.as_tensor(rng.random(K) < 0.75)
    g = torch.as_tensor(guess)
    for every in (1, 3, 8):
        x, fx = batch_scorer._brent_minimize(
            f_t, g, torch.full_like(g, lo), torch.full_like(g, hi),
            active=active, check_every=every)
        for i in range(K):
            if active[i]:
                assert (x[i].item(), fx[i].item()) == want[i]
            else:
                assert x[i].item() == guess[i]
                assert fx[i].item() == f_t(g)[i].item()
