"""The rest of dag/ in the port (schedule, sampler, tidy, reference_order):
numpy copies of bito_tpu's, pinned by their code (AST without
docstrings), and the copies' output against bito_tpu's on synthetic
credible sets (bito_tpu_torch._synthetic.credible_set_newick): the GP
schedules, the topology sampler from one seed, the tidy DAG's clean/dirty
vectors and the reference-ordered DAG."""
import pathlib

import numpy as np
import pytest

from bito_tpu.core.newick import parse_newick_text as jax_parse
from bito_tpu.dag import reference_order as jax_reference_order
from bito_tpu.dag import schedule as jax_schedule
from bito_tpu.dag.sampler import DAGTopologySampler as JaxSampler
from bito_tpu.dag.subsplit_dag import build_dag as jax_build_dag
from bito_tpu.dag.tidy import TidySubsplitDAG as JaxTidy
from bito_tpu_torch import _synthetic
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.dag import reference_order, schedule
from bito_tpu_torch.dag.sampler import DAGTopologySampler
from bito_tpu_torch.dag.subsplit_dag import build_dag
from bito_tpu_torch.dag.tidy import TidySubsplitDAG

from torch_port_cases import without_docstrings

ROOT = pathlib.Path(__file__).resolve().parent.parent
COPIES = ["dag/schedule.py", "dag/sampler.py", "dag/tidy.py",
          "dag/reference_order.py"]
# (taxa, trees, NNIs a tree) of the synthetic credible sets
SETS = [(6, 4, 1), (9, 6, 2), (12, 8, 2)]


@pytest.mark.parametrize("module", COPIES)
def test_copied_module_code_is_identical(module):
    """Apart from docstrings, the copied modules are bito_tpu's code."""
    assert (without_docstrings(ROOT / "bito_tpu_torch" / module)
            == without_docstrings(ROOT / "bito_tpu" / module))


def _dags(taxa, trees, nnis, seed=5):
    text = _synthetic.credible_set_newick(seed, taxa, trees, nnis)
    return jax_build_dag(jax_parse(text)), build_dag(parse_newick_text(text))


def _same(a, b):
    """Equal dataclass-like values: arrays by value, lists item by item."""
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif hasattr(a, "__dict__"):
        assert vars(a).keys() == vars(b).keys()
        for key in vars(a):
            _same(getattr(a, key), getattr(b, key))
    else:
        assert a == b


@pytest.mark.parametrize("taxa,trees,nnis", SETS)
def test_schedules_match(taxa, trees, nnis):
    jd, td = _dags(taxa, trees, nnis)
    assert td.edge_count() == jd.edge_count() > 2 * taxa - 2
    _same(jax_schedule.build_schedule(jd), schedule.build_schedule(td))


@pytest.mark.parametrize("taxa,trees,nnis", SETS)
def test_sampler_matches_from_one_seed(taxa, trees, nnis):
    """DAGTopologySampler draws the same topologies as bito_tpu's from one
    seed, from the UCA, a rootsplit and an internal node."""
    jd, td = _dags(taxa, trees, nnis)
    q = jd.build_uniform_on_topological_support_prior()
    inv = jd.inverted_gpcsp_probabilities(
        q, jd.unconditional_node_probabilities(q))
    origins = [jd.root_id, jd.rootsplit_ids()[0], jd.taxon_count + 1]
    js, ts = JaxSampler(seed=11), DAGTopologySampler(seed=11)
    for origin in origins:
        for _ in range(5):
            a = js.sample(jd, q, inv, origin)
            b = ts.sample(td, q, inv, origin)
            np.testing.assert_array_equal(a.parents, b.parents)


@pytest.mark.parametrize("taxa,trees,nnis", SETS[:2])
def test_tidy_vectors_match(taxa, trees, nnis):
    jd, td = _dags(taxa, trees, nnis)
    jt, tt = JaxTidy(jd), TidySubsplitDAG(td)
    node = jd.taxon_count + 2
    jt.set_dirty_strictly_above(node)
    tt.set_dirty_strictly_above(node)
    for side in (0, 1):
        np.testing.assert_array_equal(jt.dirty_vector(side),
                                      tt.dirty_vector(side))
        np.testing.assert_array_equal(jt.above_node(node, side),
                                      tt.above_node(node, side))


@pytest.mark.parametrize("taxa,trees,nnis", SETS)
def test_reference_ordered_dag_matches(taxa, trees, nnis):
    text = _synthetic.credible_set_newick(7, taxa, trees, nnis)
    jd = jax_reference_order.build_dag_reference_ordered(jax_parse(text))
    td = reference_order.build_dag_reference_ordered(parse_newick_text(text))
    assert [s.to_string() for s in jd.nodes] == [s.to_string()
                                                 for s in td.nodes]
    assert jd.pretty_edges() == td.pretty_edges()
