"""The port's device SBN programs (bito_tpu_torch/sbn/device.py, torch on
the CPU here, float64) against bito_tpu/sbn/device.py (XLA on the CPU,
float64) and against the numpy versions: the EM loop with and without the
alpha regularizer and with the score_epsilon stop, and the topology
gradients, VIMCO and plain, all within 1e-10."""
import numpy as np
import pytest
import torch

from bito_tpu.core.newick import parse_newick_text as jax_parse
from bito_tpu.sbn import device as jax_device
from bito_tpu.sbn.support import build_support as jax_build_support
from bito_tpu_torch import _synthetic
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.sbn import device, gradients, probability
from bito_tpu_torch.sbn.sampler import TopologySampler
from bito_tpu_torch.sbn.support import build_support

from torch_port_cases import topology_counts

TOL = 1e-10
CASES = [(1, 8, 6), (2, 10, 9), (3, 12, 7)]  # (seed, taxa, distinct)


def _supports(seed, taxa, distinct):
    """(bito_tpu's support and representations, the port's, counts) of a
    sample with repeated topologies."""
    text = topology_counts(seed, taxa, distinct)
    out = []
    for parse, build in ((jax_parse, jax_build_support),
                         (parse_newick_text, build_support)):
        coll = parse(text)
        counts, topo = {}, {}
        for t in coll.trees:
            t = t.deroot()
            counts[t.topology.key()] = counts.get(t.topology.key(), 0) + 1
            topo[t.topology.key()] = t.topology
        counter = {topo[k]: c for k, c in counts.items()}
        support = build(counter, coll.taxon_names, rooted=False)
        out.append((support, [support.indexer_representation_of(t)
                              for t in counter]))
    return out[0], out[1], list(counter.values())


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    scale = max(np.abs(want[fin]).max(), 1.0)
    assert np.abs(got[fin] - want[fin]).max() <= tol * scale


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("alpha, score_epsilon, max_iter",
                         [(0.0, 0.0, 15), (0.4, 0.0, 15), (0.0, 1e-3, 50),
                          (0.4, 1e-6, 50)])
def test_em_matches_bito_tpu(case, alpha, score_epsilon, max_iter):
    (js, jreps), (ts, treps), counts = _supports(*case)
    want, want_score = jax_device.expectation_maximization(
        js, jreps, counts, alpha, max_iter, score_epsilon)
    got, score = device.expectation_maximization(
        ts, treps, counts, alpha, max_iter, score_epsilon, device="cpu")
    assert len(score) == len(want_score)
    if score_epsilon > 0:  # the stop fired before max_iter
        assert len(score) < max_iter
    _close(score, want_score)
    _close(got, want)
    # and the numpy loop, iteration for iteration
    ref, ref_score = probability.expectation_maximization(
        ts, treps, counts, alpha, max_iter, score_epsilon)
    assert len(ref_score) == len(score)
    _close(score, ref_score)
    _close(got, ref)


def test_normalize_keeps_an_all_minus_inf_segment_minus_inf():
    params = torch.tensor([0.5, -np.inf, -np.inf, 1.0, 2.0],
                          dtype=torch.float64)
    seg = torch.tensor([0, 1, 1, 2, 2])
    out = device._normalize_in_log(params, seg, 4)  # segment 3 is empty
    assert out[0] == 0.0 and torch.isneginf(out[1:3]).all()
    torch.testing.assert_close(out[3:].exp().sum(),
                               torch.tensor(1.0, dtype=torch.float64))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("use_vimco", [True, False])
def test_topology_gradients_match_bito_tpu(case, use_vimco):
    """On trees sampled from the trained SBN plus trees outside the support
    (whose rootings the gradient skips), with log f from a seed."""
    seed, taxa, distinct = case
    (js, _), (ts, treps), counts = _supports(*case)
    rng = np.random.default_rng(seed)
    params = probability.simple_average(ts, treps, counts)
    params += rng.normal(0.0, 0.3, params.shape)
    probs = np.exp(probability.normalize_in_log(params, ts))
    topos = TopologySampler(ts, rng).sample_many(probs, 8, rooted=False)
    topos += [t.deroot().topology for t in parse_newick_text(
        _synthetic.random_trees_newick(seed + 50, taxa, 2)).trees]
    reps = [ts.indexer_representation_of(t) for t in topos]
    log_f = rng.normal(-100.0, 5.0, len(reps))
    want = jax_device.topology_gradients(js, params, reps, log_f, use_vimco)
    got = device.topology_gradients(ts, params, reps, log_f, use_vimco,
                                    device="cpu")
    _close(got, want)
    # The numpy version, on the sampled trees only: a topology outside the
    # support has q = 0, where it gives NaN and the device versions skip.
    sampled = slice(0, 8)
    _close(device.topology_gradients(ts, params, reps[sampled],
                                     log_f[sampled], use_vimco, device="cpu"),
           gradients.topology_gradients(ts, params, reps[sampled],
                                        log_f[sampled], use_vimco))
