"""SBN support: the indexed set of allowed rootsplits + PCSPs.

Port of bito_tpu.sbn.support with its native branches: an unrooted
support counts its rootsplits and PCSPs, and builds its indexer
representations, in the port's native library (bito_tpu_torch._native),
as bito_tpu's does in its own.  Unlike bito_tpu, the port never falls back
to the pure-Python code of sbn/maps.py on its own: a native library that
fails to build raises.  The Python code runs where the caller calls it:
support_of_bits over sbn.maps.unrooted_counters' bitsets, and
sbn.maps.unrooted_representation (an instance made with native=False
does).  Both give the same output (tests/test_torch_native.py and
tests/test_torch_sbn.py pin them).  A rooted support takes the Python
code, as in bito_tpu.

Rebuild of the reference SBNSupport / BuildIndexerBundle
(reference: src/sbn_support.hpp:4-60, src/sbn_maps.cpp:88-118).  Layout
invariants preserved:
  - indices 0..R-1 are the rootsplits (as UCA->rootsplit PCSPs),
  - PCSPs grouped by parent key (sister, focal) with contiguous child ranges,
  - parent_to_range additionally maps the rotated UCA subsplit to the
    rootsplit range.

Where the reference relies on unordered_map iteration order, we sort by the
bitset string order so the layout is deterministic and reproducible.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import _native
from ..core.bitset import PCSP, Subsplit
from ..core.tree import Topology
from . import maps


@dataclass
class SBNSupport:
    rootsplits: List[Subsplit]
    # PCSP string -> index (rootsplits entered as UCA->rootsplit PCSPs)
    indexer: Dict[str, int]
    # index -> child subsplit
    index_to_child: List[Subsplit]
    # parent key "sister|focal" string -> (start, end)
    parent_to_range: Dict[str, Tuple[int, int]]
    # pretty string per index (sister|focal|child)
    pretty: List[str]
    taxon_names: List[str]
    rooted: bool

    @property
    def rootsplit_count(self) -> int:
        return len(self.rootsplits)

    @property
    def gpcsp_count(self) -> int:
        return len(self.indexer)

    def size(self) -> int:
        return len(self.indexer)

    @property
    def num_taxa(self) -> int:
        return len(self.taxon_names)

    def segments(self) -> List[Tuple[int, int]]:
        """All normalization segments: the rootsplit range then each parent
        range (the reference's ProbabilityNormalizeParams loop,
        src/sbn_probability.cpp:117-127)."""
        segs = [(0, self.rootsplit_count)]
        for key, rng in self.parent_to_range.items():
            if rng != (0, self.rootsplit_count):
                segs.append(rng)
        return segs

    def parent_key(self, subsplit: Subsplit) -> str:
        """Key under which `subsplit`'s children are ranged: the subsplit
        arranged as sister|focal where focal is the clade being split, which
        is the second clade -- i.e. the key equals the subsplit's string."""
        return subsplit.to_string()

    def indexer_representation_of(self, topo: Topology):
        sentinel = len(self.indexer)
        if self.rooted:
            return maps.rooted_representation(self.indexer, topo, sentinel)
        return self.native_indexer().unrooted_representations(
            [np.asarray(topo.parents, dtype=np.int32)], sentinel)[0]

    def native_indexer(self):
        """The native indexer of this support, made at first use (the VBPI
        step builds every sampled tree's representations with it)."""
        cached = getattr(self, "_native_indexer", None)
        if cached is None:
            cached = _native.PCSPIndexer(self.indexer, self.num_taxa)
            self._native_indexer = cached
        return cached

    def pretty_indexer(self) -> List[str]:
        return list(self.pretty)


def build_support(topology_counter: Dict[Topology, int],
                  taxon_names: Sequence[str], rooted: bool) -> SBNSupport:
    """The support of `topology_counter`: an unrooted one counted in the
    native library, a rooted one in sbn/maps.py."""
    n_taxa = len(taxon_names)
    if rooted:
        _, _, rs_bits, pcsp_bits = maps.rooted_counters(topology_counter)
        return support_of_bits(rs_bits, pcsp_bits, taxon_names, rooted)
    rs_ints, pcsp_ints = _native.unrooted_counters(
        [t.parents for t in topology_counter],
        list(topology_counter.values()), n_taxa,
    )
    rs_bits = {}
    for c0, c1 in rs_ints:
        ss = Subsplit(c0, c1, n_taxa)
        rs_bits[ss.to_string()] = ss
    pcsp_bits = {}
    for sister, focal, child in pcsp_ints:
        p = PCSP(sister, focal, child, n_taxa)
        pcsp_bits[p.to_string()] = p
    return support_of_bits(rs_bits, pcsp_bits, taxon_names, rooted)


def support_of_bits(rs_bits: Dict[str, Subsplit], pcsp_bits: Dict[str, PCSP],
                    taxon_names: Sequence[str], rooted: bool) -> SBNSupport:
    """The indexed support of the rootsplits and PCSPs that a counter found
    (the bitset maps of sbn.maps.unrooted_counters and rooted_counters,
    keyed by their strings)."""
    n = len(taxon_names)
    indexer: Dict[str, int] = {}
    index_to_child: List[Subsplit] = []
    parent_to_range: Dict[str, Tuple[int, int]] = {}
    pretty: List[str] = []
    # Rootsplits first, sorted by subsplit string order.
    rootsplits = sorted(rs_bits.values(), key=lambda s: s.sort_key())
    uca = Subsplit.uca(n)
    parent_to_range[uca.rotate().to_string()] = (0, len(rootsplits))
    for rs in rootsplits:
        pcsp = maps.pcsp_from_uca_to_rootsplit(rs)
        indexer[pcsp.to_string()] = len(indexer)
        index_to_child.append(rs)
        pretty.append(pcsp.pretty())
    # PCSPs grouped by parent (sister, focal) key.
    by_parent: Dict[str, List[PCSP]] = {}
    for pcsp in pcsp_bits.values():
        key = maps.Subsplit(pcsp.sister, pcsp.focal, n).to_string()
        by_parent.setdefault(key, []).append(pcsp)
    for key in sorted(by_parent.keys()):
        children = sorted(by_parent[key], key=lambda p: p.sort_key())
        start = len(indexer)
        for pcsp in children:
            indexer[pcsp.to_string()] = len(indexer)
            index_to_child.append(pcsp.child)
            pretty.append(pcsp.pretty())
        parent_to_range[key] = (start, len(indexer))
    return SBNSupport(
        rootsplits=rootsplits,
        indexer=indexer,
        index_to_child=index_to_child,
        parent_to_range=parent_to_range,
        pretty=pretty,
        taxon_names=list(taxon_names),
        rooted=rooted,
    )
