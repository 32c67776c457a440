"""Topology sampling from an SBN (rootsplit, then recursive subsplits).

Host-side copy of bito_tpu.sbn.sampler (numpy only), pinned equal to it by
tests/test_torch_sbn.py.

Rebuild of reference GenericSBNInstance::SampleTopology
(reference: src/generic_sbn_instance.hpp:393-432).  Sampling is host-side
(the trees are handed to the device engines as index tapes), driven by a
numpy Generator for reproducibility.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.bitset import Subsplit, bit_indices, popcount
from ..core.tree import Topology, _renumber
from .support import SBNSupport


class TopologySampler:
    def __init__(self, support: SBNSupport, rng: Optional[np.random.Generator] = None):
        self.support = support
        self.rng = rng or np.random.default_rng()

    def _sample_index(self, probs: np.ndarray, start: int, end: int) -> int:
        # Inverse-CDF draw; rng.choice(p=...) costs ~20us per call and this
        # runs once per tree node in the VBPI sampling loop.
        cum = np.cumsum(probs[start:end])
        total = cum[-1]
        assert total > 0, "SampleIndex given segment with zero weight"
        k = int(np.searchsorted(cum, self.rng.random() * total, side="right"))
        return start + min(k, end - start - 1)

    def _sample_index_cum(self, cum: np.ndarray, start: int, end: int) -> int:
        """Like _sample_index but over a whole-vector cumulative sum,
        computed once per sampling batch."""
        base = cum[start - 1] if start > 0 else 0.0
        total = cum[end - 1] - base
        assert total > 0, "SampleIndex given segment with zero weight"
        k = int(np.searchsorted(cum[start:end],
                                base + self.rng.random() * total,
                                side="right"))
        return start + min(k, end - start - 1)

    def sample(self, sbn_probabilities: np.ndarray, rooted: bool,
               _cum: Optional[np.ndarray] = None) -> Topology:
        """sbn_probabilities: probability-normalized (not log) parameters."""
        sup = self.support
        n = sup.num_taxa
        cum = np.cumsum(sbn_probabilities) if _cum is None else _cum
        ridx = self._sample_index_cum(cum, 0, sup.rootsplit_count)
        rootsplit = sup.rootsplits[ridx]
        children: List[List[int]] = [[] for _ in range(n)]

        def grow(parent: Subsplit) -> int:
            """Sample the subtree below `parent`, return its node id."""
            kids = []
            for ss in (parent, parent.rotate()):
                clade = ss.clade1  # the focal clade is the second clade
                if popcount(clade) == 1:
                    kids.append(bit_indices(clade)[0])
                else:
                    rng_ = sup.parent_to_range[ss.to_string()]
                    cidx = self._sample_index_cum(cum, *rng_)
                    child_ss = sup.index_to_child[cidx]
                    kids.append(grow(child_ss))
            node = len(children)
            children.append(kids)
            return node

        root = grow(rootsplit)
        topo = _renumber(children, n, root)
        if not rooted:
            topo = deroot_to_trifurcation(topo)
        return topo

    def sample_many(self, sbn_probabilities: np.ndarray, count: int,
                    rooted: bool) -> List[Topology]:
        cum = np.cumsum(sbn_probabilities)
        return [self.sample(sbn_probabilities, rooted, _cum=cum)
                for _ in range(count)]


def deroot_to_trifurcation(topo: Topology) -> Topology:
    """Reference Node::Deroot: remove a bifurcating root, fusing its two
    edges, giving a trifurcation at the surviving internal node."""
    ch = topo.children()
    a, b = ch[topo.root]
    keep = b if b >= topo.num_taxa else a
    move = a if keep == b else b
    assert keep >= topo.num_taxa, "Cannot deroot a cherry-only tree"
    new_children = [list(c) for c in ch[: topo.root]]
    new_children[keep] = new_children[keep] + [move]
    return _renumber(new_children, topo.num_taxa, keep)
