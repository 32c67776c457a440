"""Primary Subsplit Pair (PSP) branch-length parameterization indexer.

Host-side copy of bito_tpu.sbn.psp (numpy only), pinned equal to it by
tests/test_torch_sbn.py.

Rebuild of the reference PSPIndexer
(reference: src/psp_indexer.cpp:10-105, src/psp_indexer.hpp:25-60).
Per branch, the representation is the triple
  (rootsplit index, subsplit-down index, subsplit-up index)
with `first_empty_index` as the "not present" sentinel (pendant branches
have no down component).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core.bitset import Subsplit, full_clade
from ..core.tree import Topology
from .maps import rootsplit_of_clade
from .support import SBNSupport


class PSPIndexer:
    def __init__(self, support: SBNSupport):
        n = support.num_taxa
        self.num_taxa = n
        self.indexer: Dict[str, int] = {}
        # First the rootsplits (as subsplits), same order as the support.
        for rs in support.rootsplits:
            self.indexer[rs.to_string()] = len(self.indexer)
        self.after_rootsplits_index = len(self.indexer)
        # Then the child subsplits of rootsplit-parented PCSPs ("primary"
        # subsplit pairs), in support index order.
        for idx in range(support.rootsplit_count, support.size()):
            pretty = support.pretty[idx]
            sister, focal, _ = pretty.split("|")
            sister_bits = sum(1 << i for i, c in enumerate(sister) if c == "1")
            focal_bits = sum(1 << i for i, c in enumerate(focal) if c == "1")
            if sister_bits | focal_bits == full_clade(n):
                # Parent is a rootsplit: include the child subsplit.
                child = support.index_to_child[idx]
                key = child.to_string()
                if key not in self.indexer:
                    self.indexer[key] = len(self.indexer)
        self.first_empty_index = len(self.indexer)

    def details(self) -> Dict[str, int]:
        return {
            "after_rootsplits_index": self.after_rootsplits_index,
            "first_empty_index": self.first_empty_index,
            "rootsplit_position": 0,
            "subsplit_down_position": 1,
            "subsplit_up_position": 2,
        }

    def to_string_vector(self) -> List[str]:
        out = [""] * (len(self.indexer) + 1)
        for key, idx in self.indexer.items():
            half = len(key) // 2
            out[idx] = key[:half] + "|" + key[half:]
        return out

    def representation_of(self, topo: Topology) -> List[List[int]]:
        """[rootsplit_result, psp_down, psp_up], each indexed by edge (node)
        id (reference PSPIndexer::RepresentationOf)."""
        n = self.num_taxa
        full = full_clade(n)
        cl = topo.clades()
        ch = topo.children()
        sentinel = self.first_empty_index
        E = topo.num_nodes - 1
        rootsplit_result = [sentinel] * E
        psp_down = [sentinel] * E
        psp_up = [sentinel] * E

        def sub_idx(a: int, b: int) -> int:
            return self.indexer[Subsplit.of_pair(a, b, n).to_string()]

        for v in range(E):
            rootsplit_result[v] = self.indexer[
                rootsplit_of_clade(cl[v], n).to_string()
            ]
            p = int(topo.parents[v])
            sibs = [w for w in ch[p] if w != v]
            if p == topo.root and len(sibs) == 2:
                # Edge meeting the trifurcation: up subsplit is the other two.
                psp_up[v] = sub_idx(cl[sibs[0]], cl[sibs[1]])
            else:
                assert len(sibs) == 1
                up_clade = full & ~cl[p]
                psp_up[v] = sub_idx(up_clade, cl[sibs[0]])
            if v >= n:
                kids = ch[v]
                psp_down[v] = sub_idx(cl[kids[0]], cl[kids[1]])
        return [rootsplit_result, psp_down, psp_up]
