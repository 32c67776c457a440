"""SBN support: the indexed set of allowed rootsplits + PCSPs.

Copy of bito_tpu.sbn.support without its `_native` branches: the port
has no ctypes indexer, so representations and counters always come from
the pure-Python code of sbn/maps.py, which gives the same output
(tests/test_torch_sbn.py pins the two by output).

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
        return maps.unrooted_representation(self.indexer, topo, sentinel)

    def pretty_indexer(self) -> List[str]:
        return list(self.pretty)


def build_support(topology_counter: Dict[Topology, int],
                  taxon_names: Sequence[str], rooted: bool) -> SBNSupport:
    if rooted:
        rs_counter, pcsp_counter, rs_bits, pcsp_bits = maps.rooted_counters(
            topology_counter
        )
    else:
        rs_counter, pcsp_counter, rs_bits, pcsp_bits = maps.unrooted_counters(
            topology_counter
        )
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
