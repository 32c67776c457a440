"""GraftDAG: a host DAG extended with proposed NNI node pairs.

Copy of bito_tpu.dag.graft (numpy only; tests/test_torch_rooted.py pins
the code by AST), the lazy import of subsplit_dag's node-pair methods: a
rebuild of the reference GraftDAG (reference: src/graft_dag.hpp:3-60).
Proposed parent/child subsplit pairs are layered onto a host DAG so NNI
candidates can be scored before committing; all candidates are grafted
into one rebuilt DAG with contiguous indices, where the reference grafts
in place and scores candidates one at a time.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Set, Tuple

import numpy as np

from ..core.bitset import PCSP, Subsplit, popcount
from .subsplit_dag import SubsplitDAG, _assemble


def graft_node_pairs(
    host: SubsplitDAG,
    node_pairs: Sequence[Tuple[Subsplit, Subsplit]],
) -> Tuple[SubsplitDAG, List[int]]:
    """Build a DAG containing the host plus every proposed (parent, child)
    subsplit pair, each connected to all valid neighbors (the connection
    search of reference SubsplitDAG::AddNodePair,
    src/subsplit_dag.hpp:525-565).  Returns (grafted_dag, central_edge_ids)
    aligned with node_pairs."""
    n = host.taxon_count
    uca = Subsplit.uca(n)
    # Existing structure as subsplit sets.
    internal: Set[Subsplit] = set(
        host.nodes[i] for i in range(n, host.root_id)
    )
    edges: Set[Tuple[Subsplit, Subsplit]] = set()
    for e in range(host.edge_count()):
        p = host.nodes[int(host.edge_parent[e])]
        if int(host.edge_parent[e]) == host.root_id:
            p = uca
        c = host.nodes[int(host.edge_child[e])]
        edges.add((p, c))

    def subsplit_of(node_id: int) -> Subsplit:
        return uca if node_id == host.root_id else host.nodes[node_id]

    # union -> existing nodes with that union (children candidates)
    by_union: Dict[int, List[Subsplit]] = {}
    for i in range(n, host.root_id):
        by_union.setdefault(host.nodes[i].union, []).append(host.nodes[i])
    # clade -> existing nodes having that clade (parent candidates)
    by_clade: Dict[int, List[Subsplit]] = {}
    for i in range(n, host.node_count()):
        ss = subsplit_of(i)
        for clade in (ss.clade0, ss.clade1):
            by_clade.setdefault(clade, []).append(ss)

    def children_for_clade(clade: int, extra: Dict[int, List[Subsplit]]
                           ) -> List[Subsplit]:
        if popcount(clade) == 1:
            from ..core.bitset import bit_indices

            return [Subsplit.leaf(bit_indices(clade)[0], n)]
        out = list(by_union.get(clade, []))
        out.extend(extra.get(clade, []))
        return out

    # Proposed nodes connect to host nodes only (as in the reference
    # GraftDAG), so each candidate's score is independent of the others.
    extra_by_union: Dict[int, List[Subsplit]] = {}

    new_internal = set(internal)
    new_edges = set(edges)
    for parent, child in node_pairs:
        for ss in (parent, child):
            # The UCA is always present as the DAG root; adding it to the
            # internal set would duplicate it (rootsplit pairs arrive with
            # parent == UCA).
            if not ss.is_leaf() and not ss.is_uca():
                new_internal.add(ss)
        new_edges.add((parent, child))
        # Connect all valid children on every clade of both proposed nodes
        # (reference AddNodePair connects every compatible neighbor).
        for ss in (parent, child):
            for clade in (ss.clade0, ss.clade1):
                if clade == 0:
                    continue
                for c in children_for_clade(clade, extra_by_union):
                    if c != ss:
                        new_edges.add((ss, c))
        # Parents of the proposed parent.
        if parent.union == (1 << n) - 1 and not parent.is_uca():
            new_edges.add((uca, parent))
        else:
            for candidate in by_clade.get(parent.union, []):
                if candidate != parent:
                    new_edges.add((candidate, parent))

    grafted = _assemble(new_internal, new_edges, host.taxon_names)
    central = []
    for parent, child in node_pairs:
        p_id = grafted.subsplit_to_id[parent.to_string()]
        c_id = grafted.subsplit_to_id[child.to_string()]
        central.append(grafted.edge_to_id[(p_id, c_id)])
    return grafted, central
