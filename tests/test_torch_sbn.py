"""The port's SBN host modules against bito_tpu's: the copied modules by
their code, sbn/support.py by its output, and the sampler and the numpy
training by their results from one seed.  Both packages take their native
indexer and counters for an unrooted support; the port's pure-Python ones
(sbn/maps.py's counters and representations, which an instance made with
native=False takes) are held to the same output, so the layouts and
representations are compared exactly."""
import pathlib

import numpy as np
import pytest

from bito_tpu.core.newick import parse_newick_text as jax_parse
from bito_tpu.sbn import probability as jax_probability
from bito_tpu.sbn.psp import PSPIndexer as JaxPSPIndexer
from bito_tpu.sbn.sampler import TopologySampler as JaxSampler
from bito_tpu.sbn.support import build_support as jax_build_support
from bito_tpu_torch import _synthetic
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.sbn import maps, probability
from bito_tpu_torch.sbn.psp import PSPIndexer
from bito_tpu_torch.sbn.sampler import TopologySampler
from bito_tpu_torch.sbn.support import build_support, support_of_bits

from torch_port_cases import topology_counts, without_docstrings

ROOT = pathlib.Path(__file__).resolve().parent.parent

COPIED = ["treelike/phylo_flags.py", "sbn/maps.py", "sbn/probability.py",
          "sbn/gradients.py", "sbn/psp.py", "sbn/sampler.py", "vi/priors.py",
          "vi/sbn_model.py", "vi/branch_model.py"]

# (seed, taxa, distinct topologies, rooted)
CASES = [(1, 8, 6, False), (2, 10, 9, False), (3, 12, 7, False),
         (4, 9, 6, True)]


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_code_is_identical(module):
    """Apart from docstrings, the copied modules are bito_tpu's code."""
    assert (without_docstrings(ROOT / "bito_tpu_torch" / module)
            == without_docstrings(ROOT / "bito_tpu" / module))


def _text(seed, taxa, distinct, rooted):
    if rooted:
        return _synthetic.random_trees_newick(seed, taxa, distinct,
                                              rooted=True) * 2
    return topology_counts(seed, taxa, distinct)


def _counter(coll, rooted):
    """{topology: count} as the instances' process_loaded_trees builds it."""
    trees = coll.trees if rooted else [t.deroot() for t in coll.trees]
    counts, topo = {}, {}
    for t in trees:
        counts[t.topology.key()] = counts.get(t.topology.key(), 0) + 1
        topo[t.topology.key()] = t.topology
    return {topo[k]: c for k, c in counts.items()}


def _both(seed, taxa, distinct, rooted, native=True):
    """(bito_tpu's (support, counter), the port's (support, counter)) from
    the same text; the port's unrooted support counted natively or by
    sbn/maps.py."""
    text = _text(seed, taxa, distinct, rooted)

    def python_support(counter, names, rooted):
        return support_of_bits(*maps.unrooted_counters(counter)[2:], names,
                               rooted)

    out = []
    for parse, build in ((jax_parse, jax_build_support),
                         (parse_newick_text,
                          build_support if native or rooted
                          else python_support)):
        coll = parse(text)
        counter = _counter(coll, rooted)
        out.append((build(counter, coll.taxon_names, rooted=rooted), counter))
    return out


@pytest.mark.parametrize("case", CASES)
def test_support_layout_identical(case):
    (js, _), (ts, _) = _both(*case)
    assert [s.to_string() for s in js.rootsplits] == [
        s.to_string() for s in ts.rootsplits]
    assert js.indexer == ts.indexer
    assert list(js.indexer) == list(ts.indexer)
    assert [c.to_string() for c in js.index_to_child] == [
        c.to_string() for c in ts.index_to_child]
    assert js.parent_to_range == ts.parent_to_range
    assert js.pretty_indexer() == ts.pretty_indexer()
    assert js.segments() == ts.segments()
    assert (js.taxon_names, js.rooted) == (ts.taxon_names, ts.rooted)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_representations_identical(case, native):
    """The indexer representations of the support's topologies and of
    topologies outside it (whose PCSPs take the sentinel index), from the
    port's native indexer and from its pure-Python one."""
    seed, taxa, distinct, rooted = case
    (js, jcount), (ts, tcount) = _both(*case, native=native)
    outside = _text(seed + 100, taxa, 4, rooted)
    jtopos = list(jcount) + list(_counter(jax_parse(outside), rooted))
    ttopos = list(tcount) + list(_counter(parse_newick_text(outside), rooted))
    for jt, tt in zip(jtopos, ttopos, strict=True):
        assert jt.key() == tt.key()
        jr = js.indexer_representation_of(jt)
        tr = (ts.indexer_representation_of(tt) if native or rooted
              else maps.unrooted_representation(ts.indexer, tt,
                                                len(ts.indexer)))
        assert np.array(jr).tolist() == np.array(tr).tolist()


@pytest.mark.parametrize("case", [c for c in CASES if not c[3]])
def test_psp_representations_identical(case):
    (js, jcount), (ts, tcount) = _both(*case)
    jp, tp = JaxPSPIndexer(js), PSPIndexer(ts)
    assert jp.details() == tp.details()
    assert jp.to_string_vector() == tp.to_string_vector()
    for jt, tt in zip(jcount, tcount, strict=True):
        assert jp.representation_of(jt) == tp.representation_of(tt)


@pytest.mark.parametrize("case", CASES)
def test_simple_average_identical(case):
    (js, jcount), (ts, tcount) = _both(*case)
    jreps = [js.indexer_representation_of(t) for t in jcount]
    treps = [ts.indexer_representation_of(t) for t in tcount]
    counts = list(tcount.values())
    assert counts == list(jcount.values())
    want = jax_probability.simple_average(js, jreps, counts)
    got = probability.simple_average(ts, treps, counts)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    norm = probability.normalize_in_log(got, ts)
    np.testing.assert_allclose(
        probability.probabilities_of_collection(ts, norm, treps),
        jax_probability.probabilities_of_collection(
            js, jax_probability.normalize_in_log(want, js), jreps),
        rtol=1e-12, atol=0)


@pytest.mark.parametrize("case", [c for c in CASES if not c[3]])
@pytest.mark.parametrize("alpha, score_epsilon", [(0.0, 0.0), (0.5, 0.0),
                                                  (0.0, 1e-4)])
def test_numpy_em_identical(case, alpha, score_epsilon):
    (js, jcount), (ts, tcount) = _both(*case)
    jreps = [js.indexer_representation_of(t) for t in jcount]
    treps = [ts.indexer_representation_of(t) for t in tcount]
    counts = list(tcount.values())
    want, want_score = jax_probability.expectation_maximization(
        js, jreps, counts, alpha, 20, score_epsilon)
    got, score = probability.expectation_maximization(
        ts, treps, counts, alpha, 20, score_epsilon)
    assert len(score) == len(want_score)
    np.testing.assert_allclose(score, want_score, rtol=1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", CASES)
def test_sampled_topologies_identical(case):
    """From the same seed, both samplers draw the same topologies."""
    rooted = case[3]
    (js, jcount), (ts, tcount) = _both(*case)
    counts = list(tcount.values())
    probs = np.exp(probability.normalize_in_log(probability.simple_average(
        ts, [ts.indexer_representation_of(t) for t in tcount], counts), ts))
    jsampler = JaxSampler(js, np.random.default_rng(7))
    tsampler = TopologySampler(ts, np.random.default_rng(7))
    jtopos = jsampler.sample_many(probs, 40, rooted)
    ttopos = tsampler.sample_many(probs, 40, rooted)
    assert [t.key() for t in jtopos] == [t.key() for t in ttopos]
    assert len({t.key() for t in ttopos}) > 1
