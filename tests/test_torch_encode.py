"""The port's copies of bito_tpu's host modules give identical results:
parsed trees, site patterns, op tapes and paired-slot tapes, compared
exactly."""
import ast
import pathlib

import numpy as np
import pytest

from bito_tpu.treelike.encode import encode_trees as jax_encode
from bito_tpu.treelike.pallas_paired import build_paired_encoding as jax_paired
from bito_tpu_torch.treelike.encode import encode_trees
from bito_tpu_torch.treelike.paired import build_paired_encoding

from torch_port_cases import make_case

ROOT = pathlib.Path(__file__).resolve().parent.parent

CASES = [
    dict(seed=1, num_taxa=8, num_trees=4, rooted=False),
    dict(seed=2, num_taxa=9, num_trees=3, rooted=True),
    dict(seed=3, num_taxa=27, num_trees=5, rooted=False),
]


def _without_docstrings(path: pathlib.Path) -> str:
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["core/bitset.py", "core/tree.py",
                                    "treelike/encode.py"])
def test_copied_module_code_is_identical(module):
    """Apart from docstrings, the copied modules are bito_tpu's code."""
    assert (_without_docstrings(ROOT / "bito_tpu_torch" / module)
            == _without_docstrings(ROOT / "bito_tpu" / module))


@pytest.mark.parametrize("kw", CASES)
def test_parsed_trees_identical(kw):
    case = make_case(**kw)
    for jt, tt in zip(case.jax_trees, case.torch_trees, strict=True):
        assert jt.topology.key() == tt.topology.key()
        assert jt.topology.num_taxa == tt.topology.num_taxa
        np.testing.assert_array_equal(jt.branch_lengths, tt.branch_lengths)


@pytest.mark.parametrize("kw", CASES)
def test_site_patterns_identical(kw):
    case = make_case(**kw)
    j, t = case.jax_pattern, case.torch_pattern
    assert j.taxon_names == t.taxon_names
    np.testing.assert_array_equal(j.patterns, t.patterns)
    np.testing.assert_array_equal(j.weights, t.weights)
    np.testing.assert_array_equal(j.site_to_pattern, t.site_to_pattern)
    np.testing.assert_array_equal(j.tip_partials(), t.tip_partials())


@pytest.mark.parametrize("kw", CASES)
def test_encode_trees_identical(kw):
    case = make_case(**kw)
    je = jax_encode([t.topology for t in case.jax_trees])
    te = encode_trees([t.topology for t in case.torch_trees])
    assert (je.num_taxa, je.num_slots) == (te.num_taxa, te.num_slots)
    for field in ("post_ops", "pre_ops", "root", "edge_mask", "node_counts"):
        np.testing.assert_array_equal(getattr(je, field), getattr(te, field))


@pytest.mark.parametrize("kw", CASES)
def test_paired_encoding_identical(kw):
    case = make_case(**kw)
    jp = jax_paired(jax_encode([t.topology for t in case.jax_trees]))
    tp = build_paired_encoding(encode_trees([t.topology
                                             for t in case.torch_trees]))
    assert ((jp.num_taxa, jp.num_slots, jp.M, jp.n_pair_slots)
            == (tp.num_taxa, tp.num_slots, tp.M, tp.n_pair_slots))
    for field in ("post_dst", "post_e", "post_src", "tip_slot"):
        np.testing.assert_array_equal(getattr(jp, field), getattr(tp, field))


def test_ds1_shape():
    """The synthetic DS1 shape: 27 taxa, 934 patterns padded to 1024,
    52 nodes, 26 ops padded to 28, 59 pair slots."""
    from bito_tpu_torch import _synthetic
    from bito_tpu_torch.core.newick import parse_newick_text
    from bito_tpu_torch.core.site_pattern import SitePattern
    from bito_tpu_torch.treelike.pruning import pad_patterns

    text, aln = _synthetic.ds1_shaped(0, num_trees=3)
    coll = parse_newick_text(text)
    sp = SitePattern(aln, coll.taxon_names)
    assert (sp.num_taxa, sp.site_count) == (27, 1949)
    assert sp.pattern_count == 934 and pad_patterns(sp.pattern_count) == 1024
    enc = encode_trees([t.topology for t in coll.trees])
    pe = build_paired_encoding(enc)
    assert (enc.num_slots, enc.post_ops.shape[1], pe.M, pe.n_pair_slots) == (
        52, 26, 28, 59)
    lengths = np.concatenate([t.branch_lengths[:-1] for t in coll.trees])
    assert lengths.min() >= 0.02 and lengths.max() <= 0.4
