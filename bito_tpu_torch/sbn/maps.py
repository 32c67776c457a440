"""SBN maps: rootsplit/PCSP counters and indexer representations.

Host-side copy of bito_tpu.sbn.maps (numpy only), pinned equal to it by
tests/test_torch_sbn.py.

Rebuild of the reference SBNMaps (reference:
src/sbn_maps.cpp:13-320, src/sbn_maps.hpp:74-82).  The reference walks
shared-pointer node graphs with the intricate UnrootedPCSPPreorder traversal
(src/node.cpp:306-352); here every virtual rooting is handled by O(1) clade
arithmetic on the per-node below-clade bitmasks:

  For an unrooted topology rooted on the edge above node u, the directed
  clade of old node w is  B[w]  if orientation is preserved and  ~B[v]
  when the old parent becomes a child; the new parent of v is the old child
  containing u when v is a strict ancestor of u, else the old parent.

This gives O(n) work per rooting, O(n^2) per tree, with no tree surgery.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.bitset import PCSP, Subsplit, full_clade
from ..core.tree import Topology

# A rooted indexer representation: [rootsplit_idx, pcsp_idx...]
RootedRep = List[int]
# An unrooted representation: one RootedRep per virtual rooting (edge).
UnrootedRep = List[RootedRep]


def rootsplit_of_clade(clade: int, n: int) -> Subsplit:
    """Reference Bitset::RootsplitSubsplitOfClade."""
    return Subsplit.of_pair(clade, full_clade(n) & ~clade, n)


def pcsp_from_uca_to_rootsplit(rootsplit: Subsplit) -> PCSP:
    """Reference Bitset::PCSPFromUCAToRootsplit."""
    return PCSP.of_parent_child(Subsplit.uca(rootsplit.n), rootsplit)


# ---------------------------------------------------------------------------
# Rooted trees
# ---------------------------------------------------------------------------
def rooted_rootsplit(topo: Topology) -> Subsplit:
    ch = topo.children()[topo.root]
    assert len(ch) == 2, "Rootsplit expects a bifurcating tree"
    return rootsplit_of_clade(topo.clades()[ch[0]], topo.num_taxa)


def rooted_pcsps(topo: Topology, allow_leaves: bool = False
                 ) -> List[Tuple[Subsplit, Subsplit]]:
    """(parent_subsplit, child_subsplit) for every internal non-root node
    (reference Node::RootedPCSPPreorder, src/node.cpp:354-368)."""
    cl = topo.clades()
    ch = topo.children()
    n = topo.num_taxa
    out = []
    for v in range(topo.num_nodes):
        if v == topo.root or (v < n and not allow_leaves):
            continue
        if v < n:
            continue
        p = int(topo.parents[v])
        sibs = [w for w in ch[p] if w != v]
        assert len(sibs) == 1, "RootedPCSP expects bifurcating trees"
        parent_ss = Subsplit.of_pair(cl[sibs[0]], cl[v], n)
        kids = ch[v]
        child_ss = Subsplit.of_pair(cl[kids[0]], cl[kids[1]], n)
        out.append((parent_ss, child_ss))
    return out


def rooted_representation(indexer: Dict[str, int], topo: Topology,
                          default_index: int) -> RootedRep:
    """Reference RootedSBNMaps::IndexerRepresentationOf: rootsplit index
    first, then the PCSP indices (sorted after the first element, as the
    reference's RootedIndexerRepresentationOf does via std::sort)."""
    n = topo.num_taxa
    rep = [indexer.get(pcsp_from_uca_to_rootsplit(rooted_rootsplit(topo)).to_string(),
                       default_index)]
    pcsps = [
        indexer.get(PCSP.of_parent_child(p, c).to_string(), default_index)
        for p, c in rooted_pcsps(topo)
    ]
    rep.extend(sorted(pcsps))
    return rep


# ---------------------------------------------------------------------------
# Unrooted trees: virtual rootings
# ---------------------------------------------------------------------------
def _virtual_rooting_structures(topo: Topology):
    """Precompute below-clades and ancestor masks for rooting arithmetic."""
    cl = topo.clades()
    ch = topo.children()
    return cl, ch


def virtual_rooted_subsplits(topo: Topology, edge: int
                             ) -> Tuple[Subsplit, List[Tuple[Subsplit, Subsplit]]]:
    """Rootsplit + (parent, child) subsplit pairs of the tree obtained by
    rooting the unrooted `topo` on the edge above node `edge`.

    For each old internal node v, the new orientation is pure clade
    arithmetic: if v is a strict ancestor of `edge`, the path to the new root
    descends into the old child whose clade contains B[edge] (that child, or
    the new root itself when the child is `edge`); otherwise orientation is
    unchanged.  When the old parent of v becomes a child, its directed clade
    is the complement ~B[v]."""
    n = topo.num_taxa
    full = full_clade(n)
    cl, ch = _virtual_rooting_structures(topo)
    Bu = cl[edge]
    rootsplit = rootsplit_of_clade(Bu, n)
    NEW_ROOT = -1

    subsplit_of: Dict[int, Subsplit] = {}
    parent_of: Dict[int, int] = {}
    for v in range(n, topo.num_nodes):
        old_parent = int(topo.parents[v]) if v != topo.root else None
        if v == edge:
            new_parent = NEW_ROOT
            new_children = list(ch[v])
        elif (cl[v] & Bu) == Bu:  # strict ancestor of the rooting edge
            toward = next(c for c in ch[v] if (cl[c] & Bu) == Bu)
            new_parent = NEW_ROOT if toward == edge else toward
            new_children = [c for c in ch[v] if c != toward]
            if old_parent is not None:
                new_children.append(old_parent)
        else:
            new_parent = old_parent
            new_children = list(ch[v])
        clades = [
            (full & ~cl[v]) if w == old_parent else cl[w] for w in new_children
        ]
        assert len(clades) == 2, (v, new_children)
        subsplit_of[v] = Subsplit.of_pair(clades[0], clades[1], n)
        parent_of[v] = new_parent

    pcsps: List[Tuple[Subsplit, Subsplit]] = []
    for v in range(n, topo.num_nodes):
        q = parent_of[v]
        parent_ss = rootsplit if q == NEW_ROOT else subsplit_of[q]
        pcsps.append((parent_ss, subsplit_of[v]))
    return rootsplit, pcsps


def unrooted_representation(indexer: Dict[str, int], topo: Topology,
                            default_index: int) -> UnrootedRep:
    """Reference UnrootedSBNMaps::IndexerRepresentationOf
    (src/sbn_maps.cpp:200-262): one rooted representation per virtual rooting
    (indexed by the child node of the rooting edge)."""
    reps: UnrootedRep = []
    for edge in range(topo.num_nodes - 1):
        rootsplit, pcsps = virtual_rooted_subsplits(topo, edge)
        rep = [indexer.get(pcsp_from_uca_to_rootsplit(rootsplit).to_string(),
                           default_index)]
        rep.extend(sorted(
            indexer.get(PCSP.of_parent_child(p, c).to_string(), default_index)
            for p, c in pcsps
        ))
        reps.append(rep)
    return reps


# ---------------------------------------------------------------------------
# Counters (reference {Rooted,Unrooted}SBNMaps::{Rootsplit,PCSP}CounterOf)
# ---------------------------------------------------------------------------
def unrooted_counters(topology_counter: Dict[Topology, int]):
    """Rootsplit and PCSP counters over all virtual rootings; each distinct
    rootsplit/PCSP is counted once per topology occurrence
    (reference src/sbn_maps.cpp:120-192)."""
    rootsplit_counter: Dict[str, int] = {}
    pcsp_counter: Dict[str, int] = {}
    rootsplit_bitsets: Dict[str, Subsplit] = {}
    pcsp_bitsets: Dict[str, PCSP] = {}
    for topo, count in topology_counter.items():
        n = topo.num_taxa
        cl = topo.clades()
        seen_pcsps = set()
        for v in range(topo.num_nodes - 1):
            rs = rootsplit_of_clade(cl[v], n)
            key = rs.to_string()
            rootsplit_counter[key] = rootsplit_counter.get(key, 0) + count
            rootsplit_bitsets[key] = rs
            _, pcsps = virtual_rooted_subsplits(topo, v)
            for p, c in pcsps:
                pcsp = PCSP.of_parent_child(p, c)
                seen_pcsps.add(pcsp)
        for pcsp in seen_pcsps:
            key = pcsp.to_string()
            pcsp_counter[key] = pcsp_counter.get(key, 0) + count
            pcsp_bitsets[key] = pcsp
    return rootsplit_counter, pcsp_counter, rootsplit_bitsets, pcsp_bitsets


def rooted_counters(topology_counter: Dict[Topology, int]):
    """Reference RootedSBNMaps counters (src/sbn_maps.cpp:283-320)."""
    rootsplit_counter: Dict[str, int] = {}
    pcsp_counter: Dict[str, int] = {}
    rootsplit_bitsets: Dict[str, Subsplit] = {}
    pcsp_bitsets: Dict[str, PCSP] = {}
    for topo, count in topology_counter.items():
        rs = rooted_rootsplit(topo)
        key = rs.to_string()
        rootsplit_counter[key] = rootsplit_counter.get(key, 0) + count
        rootsplit_bitsets[key] = rs
        for p, c in rooted_pcsps(topo):
            pcsp = PCSP.of_parent_child(p, c)
            k = pcsp.to_string()
            pcsp_counter[k] = pcsp_counter.get(k, 0) + count
            pcsp_bitsets[k] = pcsp
    return rootsplit_counter, pcsp_counter, rootsplit_bitsets, pcsp_bitsets
