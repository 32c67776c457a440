"""The port's native library (bito_tpu_torch._native) against bito_tpu's and
against the port's own pure-Python code: the source is bito_tpu's byte
for byte; the parser, the unrooted counters and the indexer
representations give the same output; concurrent builds leave one
loadable library; a failed build raises and nothing falls back to
Python on its own."""
import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from bito_tpu.core.bitset import bits_of_string
from bito_tpu.core.newick import parse_newick_file as jax_parse_newick_file
from bito_tpu.core.newick import parse_newick_text as jax_parse
from bito_tpu.core.newick import parse_nexus_file as jax_parse_nexus_file
from bito_tpu.sbn.maps import unrooted_counters as jax_unrooted_counters
from bito_tpu.sbn.support import build_support as jax_build_support
from bito_tpu_torch import _native, _synthetic
from bito_tpu_torch.api.instances import unrooted_instance
from bito_tpu_torch.core.newick import (parse_newick_file, parse_newick_text,
                                        parse_nexus_file, parse_nexus_text)
from bito_tpu_torch.sbn import maps
from bito_tpu_torch.sbn.support import build_support, support_of_bits

from torch_port_cases import topology_counts

ROOT = pathlib.Path(__file__).resolve().parent.parent

# Newick texts: unrooted, rooted, dated rooted (17-digit lengths), and
# labels with quotes and a bracket comment (bito_tpu's test_native.py).
NEWICK = {
    "unrooted": _synthetic.random_trees_newick(1, 12, 5),
    "rooted": _synthetic.random_trees_newick(2, 9, 4, rooted=True),
    "dated": _synthetic.dated_trees_newick(3, 15, 3)[0],
    "quoted": "('tax one':0.1,[&x]'it''s':0.2,c:0.3);\n",
}


def test_source_is_bito_tpus_byte_for_byte():
    assert ((ROOT / "bito_tpu_torch/_native/bitocore.cpp").read_bytes()
            == (ROOT / "bito_tpu/_native/bitocore.cpp").read_bytes())


def test_library_path_names_the_digest_in_the_build_directory():
    path = _native.library_path()
    assert path.parent == ROOT / "bito_tpu_torch" / "_build"
    assert path.name.startswith("libbitocore_") and path.suffix == ".so"
    assert _native.library_path(cxx="clang++") != path


def _same_collection(a, b):
    assert a.taxon_names == b.taxon_names
    assert len(a.trees) == len(b.trees)
    for x, y in zip(a.trees, b.trees):
        np.testing.assert_array_equal(x.topology.parents, y.topology.parents)
        np.testing.assert_array_equal(x.branch_lengths, y.branch_lengths)


@pytest.mark.parametrize("name", sorted(NEWICK))
def test_newick_parser_matches_python_and_bito_tpu(name, tmp_path):
    path = tmp_path / "trees.nwk"
    path.write_text(NEWICK[name])
    native = parse_newick_file(str(path))
    _same_collection(native, parse_newick_text(NEWICK[name]))
    _same_collection(native, jax_parse_newick_file(str(path)))
    _same_collection(native, jax_parse(NEWICK[name]))
    if name == "quoted":
        assert native.taxon_names == ["tax one", "it's", "c"]


@pytest.mark.parametrize("seed,num_taxa", [(4, 6), (5, 27)])
def test_nexus_parser_with_translate_table(seed, num_taxa, tmp_path):
    path = tmp_path / "mcmc.t"
    text = _synthetic.mcmc_nexus(seed, num_taxa, 7)
    path.write_text(text)
    native = parse_nexus_file(str(path))
    assert native.taxon_names == _synthetic.taxon_names(num_taxa)
    _same_collection(native, parse_nexus_text(text))
    _same_collection(native, jax_parse_nexus_file(str(path)))


def test_parse_error_raises():
    with pytest.raises(ValueError):
        _native.parse_trees("((a:0.1,b:0.2);", False)


def _counter(coll):
    counts, topo = {}, {}
    for t in (t.deroot() for t in coll.trees):
        counts[t.topology.key()] = counts.get(t.topology.key(), 0) + 1
        topo[t.topology.key()] = t.topology
    return {topo[k]: c for k, c in counts.items()}


@pytest.mark.parametrize("seed,num_taxa,distinct", [(1, 8, 6), (2, 12, 9),
                                                    (3, 70, 5)])
def test_counters_match_python_and_bito_tpu(seed, num_taxa, distinct):
    """Integer-bitset counters (70 taxa: two 64-bit blocks a clade) against
    sbn/maps.py's string counters, the port's and bito_tpu's."""
    text = topology_counts(seed, num_taxa, distinct)
    counter = _counter(parse_newick_text(text))
    n = num_taxa
    rs, pcsp = _native.unrooted_counters(
        [t.parents for t in counter], list(counter.values()), n)
    for count in (maps.unrooted_counters(counter),
                  jax_unrooted_counters(_counter(jax_parse(text)))):
        rs_py, pcsp_py = count[0], count[1]
        assert rs == {(bits_of_string(k[:n]), bits_of_string(k[n:])): v
                      for k, v in rs_py.items()}
        assert pcsp == {(bits_of_string(k[:n]), bits_of_string(k[n:2 * n]),
                         bits_of_string(k[2 * n:])): v
                        for k, v in pcsp_py.items()}


@pytest.mark.parametrize("seed,num_taxa,distinct", [(6, 9, 6), (7, 27, 8),
                                                    (8, 70, 4)])
def test_support_from_native_counters_is_the_python_one(seed, num_taxa,
                                                        distinct):
    text = topology_counts(seed, num_taxa, distinct)
    counter = _counter(parse_newick_text(text))
    names = parse_newick_text(text).taxon_names
    got = build_support(counter, names, rooted=False)
    want = support_of_bits(*maps.unrooted_counters(counter)[2:], names,
                           rooted=False)
    jax = jax_build_support(_counter(jax_parse(text)), names, rooted=False)
    for other in (want, jax):
        assert list(got.indexer.items()) == list(other.indexer.items())
        assert got.parent_to_range == other.parent_to_range
        assert got.pretty_indexer() == other.pretty_indexer()


@pytest.mark.parametrize("seed,num_taxa,distinct", [(9, 8, 6), (10, 27, 8),
                                                    (11, 70, 4)])
def test_representations_match_python_and_bito_tpu(seed, num_taxa,
                                                   distinct):
    """Every tree's representations, one native call for the whole set,
    against sbn/maps.py and bito_tpu's support, on the support's own
    topologies and on topologies outside it (the sentinel index)."""
    text = topology_counts(seed, num_taxa, distinct)
    outside = _synthetic.random_trees_newick(seed + 100, num_taxa, 4)
    coll = parse_newick_text(text)
    counter = _counter(coll)
    support = build_support(counter, coll.taxon_names, rooted=False)
    jax_support = jax_build_support(_counter(jax_parse(text)),
                                    coll.taxon_names, rooted=False)
    sentinel = support.size()
    topos = list(counter) + [t.deroot().topology
                             for t in parse_newick_text(outside).trees]
    jax_topos = list(_counter(jax_parse(text))) + [
        t.deroot().topology for t in jax_parse(outside).trees]
    got = support.native_indexer().unrooted_representations(
        [np.asarray(t.parents, dtype=np.int32) for t in topos], sentinel)
    assert any(sentinel in row for rep in got for row in rep)
    for rep, topo, jax_topo in zip(got, topos, jax_topos, strict=True):
        assert rep == maps.unrooted_representation(support.indexer, topo,
                                                   sentinel)
        assert rep == support.indexer_representation_of(topo)
        assert rep == np.asarray(
            jax_support.indexer_representation_of(jax_topo)).tolist()


def test_instance_takes_one_native_call_for_the_tree_set(tmp_path,
                                                        monkeypatch):
    """make_indexer_representations: one native call, the pure-Python
    representations never; native=False the other way round; both equal."""
    path = tmp_path / "trees.nwk"
    path.write_text(topology_counts(12, 10, 7))
    calls = {"native": 0, "python": 0}
    native_fn = _native.PCSPIndexer.unrooted_representations
    python_fn = maps.unrooted_representation

    def counted(kind, fn):
        def call(*args, **kwargs):
            calls[kind] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(_native.PCSPIndexer, "unrooted_representations",
                        counted("native", native_fn))
    monkeypatch.setattr(maps, "unrooted_representation",
                        counted("python", python_fn))
    reps = {}
    for native in (True, False):
        inst = unrooted_instance("x", device="cpu", native=native)
        inst.read_newick_file(str(path))
        inst.process_loaded_trees()
        inst.sample_trees(12)
        before = dict(calls)
        reps[native] = inst.make_indexer_representations()
        made = {k: calls[k] - before[k] for k in calls}
        assert made == ({"native": 1, "python": 0} if native
                        else {"native": 0, "python": 12})
    assert reps[True] == [np.asarray(r).tolist() for r in reps[False]]


_BUILD = """
import ctypes, sys
from bito_tpu_torch import _native
so = _native.build(build_dir=sys.argv[1])
ctypes.CDLL(str(so)).bc_parse
print(so)
"""


def test_concurrent_builds_leave_one_loadable_library(tmp_path):
    """Two processes that build at once into one directory: the same
    library, complete, and nothing else but the lock file."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    paths = {out.strip() for out, _ in outs}
    assert paths == {str(_native.library_path(tmp_path))}
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["libbitocore.lock", _native.library_path(tmp_path).name])
    lib = ctypes.CDLL(paths.pop())
    assert lib.bc_unrooted_representations


def test_failed_build_raises_with_the_compilers_message(tmp_path):
    with pytest.raises(RuntimeError, match="not found"):
        _native.build(build_dir=tmp_path, cxx=str(tmp_path / "no-such-g++"))
    bad = tmp_path / "cc"
    bad.write_text("#!/bin/sh\necho 'cc: refused' >&2\nexit 1\n")
    bad.chmod(0o755)
    with pytest.raises(RuntimeError, match="cc: refused"):
        _native.build(build_dir=tmp_path, cxx=str(bad))
    assert not any(p.suffix == ".so" or p.name.endswith(".tmp")
                   for p in tmp_path.iterdir())


def test_a_failed_build_reaches_the_callers(tmp_path, monkeypatch):
    """With a compiler that cannot build, the parser, the support and the
    instance raise; only an instance made with native=False takes the
    Python code."""
    path = tmp_path / "trees.nwk"
    path.write_text(topology_counts(13, 8, 5))
    monkeypatch.setattr(_native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_native, "CXX", str(tmp_path / "no-such-g++"))
    _native.get_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="not found"):
            parse_newick_file(str(path))
        coll = parse_newick_text(path.read_text())
        with pytest.raises(RuntimeError, match="not found"):
            build_support(_counter(coll), coll.taxon_names, rooted=False)
        inst = unrooted_instance("x", device="cpu")
        with pytest.raises(RuntimeError, match="not found"):
            inst.read_newick_file(str(path))
        inst = unrooted_instance("x", device="cpu", native=False)
        inst.read_newick_file(str(path))
        inst.process_loaded_trees()
        assert len(inst.make_indexer_representations()) == len(coll.trees)
    finally:
        _native.get_lib.cache_clear()
