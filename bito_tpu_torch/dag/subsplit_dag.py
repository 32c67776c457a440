"""The subsplit DAG (host-side structure).

Copy of bito_tpu.dag.subsplit_dag (numpy only; tests/test_torch_rooted.py
pins the code by AST): a rebuild of the reference SubsplitDAG (reference:
src/subsplit_dag.cpp:15-1060, src/subsplit_dag.hpp:512-565,
src/subsplit_dag_storage.hpp).  Nodes are subsplits (leaf subsplits with
ids 0..n-1, internal subsplits topologically ordered so children precede
parents, rootsplits just before the UCA root, which has the highest id);
edges are PCSPs with the children of each (node, clade) contiguous in
edge-id space.

Where the reference assigns ids by depth-first creation order, internal
nodes are sorted by (clade-union size, subsplit string) -- a deterministic
topological order satisfying the same invariants -- so DAG builds are
reproducible across runs.

The port's rooted instance uses it for unconditional subsplit
probabilities, and the GP engine (gp/engine.py) for its wavefront
schedules (dag/schedule.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.bitset import PCSP, Subsplit, full_clade, popcount
from ..core.tree import Topology, Tree, TreeCollection
from ..sbn import maps as sbn_maps

LEFT = True    # clade0 (the string-lex-larger clade)
RIGHT = False  # clade1


@dataclass
class SubsplitDAG:
    taxon_names: List[str]
    nodes: List[Subsplit]                       # id -> subsplit
    subsplit_to_id: Dict[str, int]
    # edge arrays, id-aligned
    edge_parent: np.ndarray
    edge_child: np.ndarray
    edge_side: np.ndarray                       # True == left clade of parent
    edge_to_id: Dict[Tuple[int, int], int]
    # (node_id, side) -> (start, end) edge-id range
    parent_to_child_range: Dict[Tuple[int, bool], Tuple[int, int]]
    # node_id -> {side -> [(child_id, edge_id)]}
    leafward: List[Dict[bool, List[Tuple[int, int]]]]
    # node_id -> {side-of-parent -> [(parent_id, edge_id)]}
    rootward: List[Dict[bool, List[Tuple[int, int]]]]

    @property
    def taxon_count(self) -> int:
        return len(self.taxon_names)

    def node_count(self) -> int:
        """Including the DAG root (UCA)."""
        return len(self.nodes)

    def node_count_without_dag_root(self) -> int:
        return len(self.nodes) - 1

    def edge_count(self) -> int:
        return len(self.edge_parent)

    @property
    def root_id(self) -> int:
        return len(self.nodes) - 1

    def rootsplit_ids(self) -> List[int]:
        return [c for c, _ in self.leafward[self.root_id][LEFT]]

    def is_leaf(self, node_id: int) -> bool:
        return node_id < self.taxon_count

    # -- traversal helpers ------------------------------------------------
    def rootward_node_trace(self, include_root: bool = True) -> List[int]:
        """Topological order, leaves first (valid because ids are sorted)."""
        end = self.node_count() if include_root else self.root_id
        return list(range(end))

    def leafward_node_trace(self, include_root: bool = False) -> List[int]:
        start = self.root_id - (0 if include_root else 1)
        return list(range(start, -1, -1))

    def topological_edge_traversal(self):
        """(parent, side, child, edge) with parents before children
        (reference SubsplitDAG::TopologicalEdgeTraversal)."""
        for parent in range(self.node_count() - 1, self.taxon_count - 1, -1):
            for side in (RIGHT, LEFT):
                for child, edge in self.leafward[parent][side]:
                    yield parent, side, child, edge

    # -- counts and priors ------------------------------------------------
    def topology_count_below(self) -> np.ndarray:
        """Reference SubsplitDAG::CountTopologies."""
        counts = np.ones(self.node_count())
        for node_id in self.rootward_node_trace(True):
            for side in (RIGHT, LEFT):
                kids = self.leafward[node_id][side]
                if kids:
                    counts[node_id] *= sum(counts[c] for c, _ in kids)
        return counts

    def topology_count(self) -> float:
        return float(self.topology_count_below()[self.root_id])

    def build_uniform_on_topological_support_prior(self) -> np.ndarray:
        """Reference BuildUniformOnTopologicalSupportPrior
        (src/subsplit_dag.cpp:644-663)."""
        below = self.topology_count_below()
        q = np.ones(self.edge_count())
        for node_id in self.rootward_node_trace(True):
            for side in (RIGHT, LEFT):
                kids = self.leafward[node_id][side]
                if kids:
                    total = sum(below[c] for c, _ in kids)
                    for c, e in kids:
                        q[e] = below[c] / total
        return q

    def unconditional_node_probabilities(
        self, normalized_sbn_parameters: np.ndarray
    ) -> np.ndarray:
        """Reference UnconditionalNodeProbabilities
        (src/subsplit_dag.cpp:987-1008)."""
        p = np.zeros(self.node_count())
        p[self.root_id] = 1.0
        for parent, side, child, edge in self.topological_edge_traversal():
            q = normalized_sbn_parameters[edge]
            assert 0.0 <= q <= 1.0 + 1e-12, "non-normalized SBN parameters"
            p[child] += p[parent] * q
        return p

    def inverted_gpcsp_probabilities(
        self, normalized_sbn_parameters: np.ndarray,
        node_probabilities: np.ndarray,
    ) -> np.ndarray:
        """Reference InvertedGPCSPProbabilities (src/subsplit_dag.cpp:1025)."""
        inv = np.ones(self.edge_count())
        for parent, side, child, edge in self.topological_edge_traversal():
            if parent != self.root_id:
                inv[edge] = (
                    node_probabilities[parent]
                    * normalized_sbn_parameters[edge]
                    / node_probabilities[child]
                )
        return inv

    # -- pretty printing ---------------------------------------------------
    def edge_pcsp(self, edge_id: int) -> PCSP:
        parent = self.nodes[self.edge_parent[edge_id]]
        child = self.nodes[self.edge_child[edge_id]]
        if self.edge_parent[edge_id] == self.root_id:
            parent = Subsplit.uca(self.taxon_count)
        return PCSP.of_parent_child(parent, child)

    def pretty_edge(self, edge_id: int) -> str:
        return self.edge_pcsp(edge_id).pretty()

    def pretty_edges(self) -> List[str]:
        return [self.pretty_edge(e) for e in range(self.edge_count())]

    def build_edge_indexer(self) -> Dict[str, int]:
        """PCSP string -> edge id (reference BuildEdgeIndexer)."""
        return {
            self.edge_pcsp(e).to_string(): e for e in range(self.edge_count())
        }

    # -- tree containment and representations -----------------------------
    def indexer_representation_of_topology(self, topo: Topology,
                                           default_index: Optional[int] = None
                                           ) -> List[int]:
        """Edge ids of a rooted topology's PCSPs, rootsplit first
        (reference SubsplitDAG::IndexerRepresentationOf)."""
        sentinel = self.edge_count() if default_index is None else default_index
        indexer = self.build_edge_indexer()
        rep = [indexer.get(
            sbn_maps.pcsp_from_uca_to_rootsplit(
                sbn_maps.rooted_rootsplit(topo)
            ).to_string(), sentinel)]
        pairs = sbn_maps.rooted_pcsps(topo)
        # Leaf-subsplit edges are also DAG edges; include them.
        n = self.taxon_count
        cl = topo.clades()
        ch = topo.children()
        for v in range(topo.num_nodes):
            if v >= n and v != topo.root:
                pass
        for p, c in pairs:
            rep.append(indexer.get(PCSP.of_parent_child(p, c).to_string(),
                                   sentinel))
        # Edges from internal subsplits to leaf children.
        for v in range(n, topo.num_nodes):
            kids = ch[v]
            ss = Subsplit.of_pair(cl[kids[0]], cl[kids[1]], n)
            for k in kids:
                if k < n:
                    leaf = Subsplit.leaf(k, n)
                    rep.append(indexer.get(
                        PCSP.of_parent_child(ss, leaf).to_string(), sentinel))
        return rep

    def contains_topology(self, topo: Topology) -> bool:
        sentinel = self.edge_count()
        return all(
            i < sentinel
            for i in self.indexer_representation_of_topology(topo)
        )

    # -- topology generation ----------------------------------------------
    def generate_all_topologies(self) -> List[Topology]:
        """Reference GenerateAllTopologies (src/subsplit_dag.cpp:666-720):
        every rooted topology embedded in the DAG."""
        n = self.taxon_count
        below: List[List] = [None] * self.node_count()

        def topologies_below(node_id: int):
            if below[node_id] is not None:
                return below[node_id]
            if self.is_leaf(node_id):
                below[node_id] = [("leaf", node_id)]
                return below[node_id]
            left_opts = []
            right_opts = []
            for side, store in ((LEFT, left_opts), (RIGHT, right_opts)):
                for child, _ in self.leafward[node_id][side]:
                    store.extend(topologies_below(child))
            out = []
            for lt in left_opts:
                for rt in right_opts:
                    out.append(("join", lt, rt))
            below[node_id] = out
            return out

        results = []
        for rs in self.rootsplit_ids():
            results.extend(topologies_below(rs))

        def build(spec, children, counter):
            if spec[0] == "leaf":
                return spec[1]
            left = build(spec[1], children, counter)
            right = build(spec[2], children, counter)
            nid = counter[0]
            counter[0] += 1
            children[nid] = [left, right]
            return nid

        out = []
        for spec in results:
            children = {i: [] for i in range(n)}
            counter = [n]
            # Upper bound on node count
            for extra in range(n, 2 * n):
                children.setdefault(extra, [])
            root = build(spec, children, counter)
            maxid = max(children.keys())
            ch_list = [children.get(i, []) for i in range(maxid + 1)]
            from ..core.tree import _renumber

            out.append(_renumber(ch_list, n, root))
        return out

    # -- DOT export --------------------------------------------------------
    def to_dot(self, edge_labels: bool = False) -> str:
        lines = ["digraph SubsplitDAG {"]
        for i, ss in enumerate(self.nodes):
            label = ss.pretty()
            if i < self.taxon_count:
                label = self.taxon_names[i]
            lines.append(f'  n{i} [label="{label}"];')
        for e in range(self.edge_count()):
            attr = f' [label="{e}"]' if edge_labels else ""
            lines.append(
                f"  n{self.edge_parent[e]} -> n{self.edge_child[e]}{attr};"
            )
        lines.append("}")
        return "\n".join(lines)


def build_dag(tree_collection: TreeCollection) -> SubsplitDAG:
    """Build the DAG from a (rooted) tree collection's topology counter
    (reference SubsplitDAG ctor, src/subsplit_dag.cpp:15-39).  Unrooted
    collections should be rooted first (the reference GPDAG takes a
    RootedTreeCollection)."""
    n = tree_collection.num_taxa
    topology_counter = {}
    for t in tree_collection.trees:
        k = t.topology
        topology_counter[k.key()] = k
    return build_dag_from_topologies(
        list(topology_counter.values()), tree_collection.taxon_names
    )


def build_dag_from_topologies(topologies: Sequence[Topology],
                              taxon_names: Sequence[str]) -> SubsplitDAG:
    n = len(taxon_names)
    uca = Subsplit.uca(n)
    internal: Set[Subsplit] = set()
    edges: Set[Tuple[Subsplit, Subsplit]] = set()
    for topo in topologies:
        cl = topo.clades()
        ch = topo.children()
        node_ss: Dict[int, Subsplit] = {}
        for v in range(n):
            node_ss[v] = Subsplit.leaf(v, n)
        for v in range(n, topo.num_nodes):
            kids = ch[v]
            assert len(kids) == 2, "DAG build requires bifurcating rooted trees"
            node_ss[v] = Subsplit.of_pair(cl[kids[0]], cl[kids[1]], n)
            if v != topo.root:
                pass
        for v in range(n, topo.num_nodes):
            internal.add(node_ss[v])
            for k in ch[v]:
                edges.add((node_ss[v], node_ss[k]))
        edges.add((uca, node_ss[topo.root]))
    return _assemble(internal, edges, taxon_names)


def _assemble(internal: Set[Subsplit],
              edges: Set[Tuple[Subsplit, Subsplit]],
              taxon_names: Sequence[str]) -> SubsplitDAG:
    n = len(taxon_names)
    uca = Subsplit.uca(n)
    # Node ordering: leaves, then internal by (union size, string), UCA last.
    nodes: List[Subsplit] = [Subsplit.leaf(i, n) for i in range(n)]
    internal_sorted = sorted(
        internal, key=lambda s: (popcount(s.union), s.sort_key())
    )
    nodes.extend(internal_sorted)
    nodes.append(uca)
    subsplit_to_id = {s.to_string(): i for i, s in enumerate(nodes)}

    leafward: List[Dict[bool, List[Tuple[int, int]]]] = [
        {LEFT: [], RIGHT: []} for _ in nodes
    ]
    rootward: List[Dict[bool, List[Tuple[int, int]]]] = [
        {LEFT: [], RIGHT: []} for _ in nodes
    ]
    # Assign edge ids: per parent (ascending), per side (RIGHT then LEFT),
    # children ascending by id -- children of a (node, clade) contiguous.
    by_parent: Dict[Tuple[int, bool], List[int]] = {}
    for p_ss, c_ss in edges:
        p = subsplit_to_id[p_ss.to_string()]
        c = subsplit_to_id[c_ss.to_string()]
        side = LEFT if c_ss.union == p_ss.clade0 else RIGHT
        assert c_ss.union in (p_ss.clade0, p_ss.clade1), "invalid DAG edge"
        by_parent.setdefault((p, side), []).append(c)

    edge_parent: List[int] = []
    edge_child: List[int] = []
    edge_side: List[bool] = []
    edge_to_id: Dict[Tuple[int, int], int] = {}
    parent_to_child_range: Dict[Tuple[int, bool], Tuple[int, int]] = {}
    for p in range(len(nodes)):
        for side in (RIGHT, LEFT):
            kids = sorted(by_parent.get((p, side), []))
            if not kids:
                continue
            start = len(edge_parent)
            for c in kids:
                eid = len(edge_parent)
                edge_parent.append(p)
                edge_child.append(c)
                edge_side.append(side)
                edge_to_id[(p, c)] = eid
                leafward[p][side].append((c, eid))
                rootward[c][side].append((p, eid))
            parent_to_child_range[(p, side)] = (start, len(edge_parent))

    return SubsplitDAG(
        taxon_names=list(taxon_names),
        nodes=nodes,
        subsplit_to_id=subsplit_to_id,
        edge_parent=np.asarray(edge_parent, dtype=np.int32),
        edge_child=np.asarray(edge_child, dtype=np.int32),
        edge_side=np.asarray(edge_side, dtype=bool),
        edge_to_id=edge_to_id,
        parent_to_child_range=parent_to_child_range,
        leafward=leafward,
        rootward=rootward,
    )


def _double_factorial_topology_count(leaf_count: int) -> float:
    """Number of rooted bifurcating topologies on `leaf_count` leaves:
    (2n-3)!! (reference src/combinatorics.cpp TopologyCount)."""
    if leaf_count <= 2:
        return 1.0
    out = 1.0
    k = 2 * leaf_count - 3
    while k > 1:
        out *= k
        k -= 2
    return out


def _uniform_all_prior(self: SubsplitDAG) -> np.ndarray:
    """Reference SubsplitDAG::BuildUniformOnAllTopologiesPrior: probability
    of each PCSP under the uniform distribution over ALL rooted topologies:
    q(child (Y,Z)) = T(|Y|) T(|Z|) / T(|Y|+|Z|), with rootsplits over T(n)."""
    q = np.zeros(self.edge_count())
    for e in range(self.edge_count()):
        child = self.nodes[self.edge_child[e]]
        y = popcount(child.clade0)
        z = popcount(child.clade1)
        if z == 0:  # leaf subsplit
            q[e] = 1.0
            continue
        q[e] = (
            _double_factorial_topology_count(y)
            * _double_factorial_topology_count(z)
            / _double_factorial_topology_count(y + z)
        )
    return q


SubsplitDAG.build_uniform_on_all_topologies_prior = _uniform_all_prior


# ---------------------------------------------------------------------------
# API-compat accessors (reference src/pybito.cpp dag class bindings)
# ---------------------------------------------------------------------------
def _contains_node(self: SubsplitDAG, subsplit: Subsplit) -> bool:
    return subsplit.to_string() in self.subsplit_to_id


def _contains_edge(self: SubsplitDAG, parent: Subsplit, child: Subsplit
                   ) -> bool:
    p = self.subsplit_to_id.get(parent.to_string())
    c = self.subsplit_to_id.get(child.to_string())
    return p is not None and c is not None and (p, c) in self.edge_to_id


def _contains_tree(self: SubsplitDAG, tree) -> bool:
    return self.contains_topology(tree.topology)


def _contains_nni(self: SubsplitDAG, nni) -> bool:
    return _contains_edge(self, nni.parent, nni.child)


def _get_node_id(self: SubsplitDAG, subsplit: Subsplit) -> int:
    return self.subsplit_to_id[subsplit.to_string()]


def _get_edge_id(self: SubsplitDAG, parent: Subsplit, child: Subsplit) -> int:
    return self.edge_to_id[(
        self.subsplit_to_id[parent.to_string()],
        self.subsplit_to_id[child.to_string()],
    )]


def _get_parent(self: SubsplitDAG, edge_id: int) -> Subsplit:
    return self.nodes[int(self.edge_parent[edge_id])]


def _get_child(self: SubsplitDAG, edge_id: int) -> Subsplit:
    return self.nodes[int(self.edge_child[edge_id])]


def _build_set_of_node_bitsets(self: SubsplitDAG):
    return {s.to_string() for s in self.nodes}


def _build_set_of_edge_bitsets(self: SubsplitDAG):
    return {self.edge_pcsp(e).to_string() for e in range(self.edge_count())}


def _compare_to_dag(self: SubsplitDAG, other: "SubsplitDAG") -> int:
    """0 when node and edge sets agree (reference CompareToDAG)."""
    a = (_build_set_of_node_bitsets(self), _build_set_of_edge_bitsets(self))
    b = (_build_set_of_node_bitsets(other), _build_set_of_edge_bitsets(other))
    return 0 if a == b else (-1 if a < b else 1)


def _is_valid(self: SubsplitDAG) -> bool:
    """Reference invariant check (src/subsplit_dag.hpp:512-521)."""
    n = self.taxon_count
    for e in range(self.edge_count()):
        if not (self.edge_child[e] < self.edge_parent[e]):
            return False
    for u in range(n, self.root_id):
        for side in (False, True):
            if not self.leafward[u][side]:
                return False
    return True


def _is_valid_add_node_pair(self: SubsplitDAG, parent: Subsplit,
                            child: Subsplit) -> bool:
    """Reference IsValidAddNodePair: child must split a parent clade, and
    every clade of both nodes must have at least one possible child or be a
    leaf."""
    if child.union not in (parent.clade0, parent.clade1):
        return False
    by_union = {}
    for i in range(self.taxon_count, self.root_id):
        by_union.setdefault(self.nodes[i].union, True)
    full = full_clade(self.taxon_count)
    # parent must be attachable rootward
    if parent.union != full:
        found = any(
            parent.union in (self.nodes[i].clade0, self.nodes[i].clade1)
            for i in range(self.taxon_count, self.node_count())
        )
        if not found:
            return False
    for ss in (parent, child):
        for clade in (ss.clade0, ss.clade1):
            if clade == 0 or popcount(clade) == 1:
                continue
            if ss is parent and clade == child.union:
                continue
            if clade not in by_union:
                return False
    return True


def _generate_covering_topologies(self: SubsplitDAG):
    """Reference GenerateCoveringTopologies: a small set of topologies
    covering every DAG edge (greedy: keep adding the topology covering the
    most uncovered edges, via per-edge containment)."""
    topologies = self.generate_all_topologies()
    uncovered = set(range(self.edge_count()))
    reps = [
        set(self.indexer_representation_of_topology(t)) for t in topologies
    ]
    chosen = []
    while uncovered:
        best = max(range(len(topologies)),
                   key=lambda i: len(reps[i] & uncovered))
        if not reps[best] & uncovered:
            break
        chosen.append(topologies[best])
        uncovered -= reps[best]
    return chosen


def _to_newick_of_all_topologies(self: SubsplitDAG) -> str:
    return "\n".join(
        t.newick(self.taxon_names) for t in self.generate_all_topologies()
    ) + "\n"


def _to_newick_of_covering_topologies(self: SubsplitDAG) -> str:
    return "\n".join(
        t.newick(self.taxon_names)
        for t in _generate_covering_topologies(self)
    ) + "\n"


for _name, _fn in [
    ("contains_node", _contains_node), ("contains_edge", _contains_edge),
    ("contains_tree", _contains_tree), ("contains_nni", _contains_nni),
    ("get_node_id", _get_node_id), ("get_edge_id", _get_edge_id),
    ("get_parent", _get_parent), ("get_child", _get_child),
    ("build_set_of_node_bitsets", _build_set_of_node_bitsets),
    ("build_set_of_edge_bitsets", _build_set_of_edge_bitsets),
    ("compare_to_dag", _compare_to_dag), ("is_valid", _is_valid),
    ("is_valid_add_node_pair", _is_valid_add_node_pair),
    ("generate_covering_topologies", _generate_covering_topologies),
    ("to_newick_of_all_topologies", _to_newick_of_all_topologies),
    ("to_newick_of_covering_topologies", _to_newick_of_covering_topologies),
]:
    setattr(SubsplitDAG, _name, _fn)


def _add_nodes(self: SubsplitDAG, subsplits) -> "ModificationResult":
    """Reference SubsplitDAG::AddNodes: add the given subsplits (keeping
    existing edges), in place."""
    internal = set(self.nodes[self.taxon_count:self.root_id]) | {
        s for s in subsplits if not s.is_leaf()
    }
    edges = set()
    for e in range(self.edge_count()):
        p = (Subsplit.uca(self.taxon_count)
             if int(self.edge_parent[e]) == self.root_id
             else self.nodes[int(self.edge_parent[e])])
        edges.add((p, self.nodes[int(self.edge_child[e])]))
    return _modify_in_place(self, _assemble(internal, edges,
                                            self.taxon_names))


def _add_edges(self: SubsplitDAG, pairs) -> "ModificationResult":
    """Reference SubsplitDAG::AddEdges: add the given (parent, child)
    subsplit pairs and their valid neighbor connections, in place."""
    return _add_node_pairs_in_place(self, pairs)


@dataclass
class ModificationResult:
    """Outcome of an in-place DAG modification (reference
    SubsplitDAG::ModificationResult, src/subsplit_dag.hpp:525-565): the ids
    added by the modification plus old-id -> new-id reindexers for node- and
    edge-aligned data (the reference Reindexer, src/reindexer.hpp:3-14)."""
    added_node_ids: List[int]
    added_edge_ids: List[int]
    node_reindexer: np.ndarray   # [old_node_count] old id -> new id
    edge_reindexer: np.ndarray   # [old_edge_count] old id -> new id

    def reindex_node_data(self, data: np.ndarray, new_count: int,
                          fill=0.0) -> np.ndarray:
        """Remap old-node-id-aligned data to the new ids (reference
        Reindexer::ReindexVector)."""
        out = np.full((new_count,) + data.shape[1:], fill, dtype=data.dtype)
        out[self.node_reindexer] = data
        return out

    def reindex_edge_data(self, data: np.ndarray, new_count: int,
                          fill=0.0) -> np.ndarray:
        out = np.full((new_count,) + data.shape[1:], fill, dtype=data.dtype)
        out[self.edge_reindexer] = data
        return out


def _edge_string_index(dag: SubsplitDAG) -> Dict[Tuple[str, str], int]:
    return {
        (dag.nodes[int(dag.edge_parent[e])].to_string(),
         dag.nodes[int(dag.edge_child[e])].to_string()): e
        for e in range(dag.edge_count())
    }


def _modify_in_place(self: SubsplitDAG, new: SubsplitDAG
                     ) -> ModificationResult:
    """Replace self's contents with `new` and report the id mapping.  The
    reference mutates storage and reindexes in place
    (src/subsplit_dag.hpp:525-565); here the rebuilt DAG is swapped in and
    the reindexers are derived from subsplit/PCSP identity, which preserves
    the same caller contract (same object, new contiguous ids)."""
    node_reindexer = np.asarray(
        [new.subsplit_to_id[s.to_string()] for s in self.nodes],
        dtype=np.int32,
    )
    new_edges = _edge_string_index(new)
    edge_reindexer = np.asarray(
        [new_edges[(self.nodes[int(self.edge_parent[e])].to_string(),
                    self.nodes[int(self.edge_child[e])].to_string())]
         for e in range(self.edge_count())],
        dtype=np.int32,
    )
    node_image = set(node_reindexer.tolist())
    edge_image = set(edge_reindexer.tolist())
    added_nodes = [i for i in range(new.node_count())
                   if i not in node_image]
    added_edges = [e for e in range(new.edge_count())
                   if e not in edge_image]
    self.__dict__.update(new.__dict__)
    return ModificationResult(added_nodes, added_edges, node_reindexer,
                              edge_reindexer)


def _add_node_pair(self: SubsplitDAG, parent: Subsplit, child: Subsplit
                   ) -> ModificationResult:
    """Reference SubsplitDAG::AddNodePair (src/subsplit_dag.hpp:525-565):
    add the parent/child subsplit pair and every valid connecting edge,
    in place, returning added ids + reindexers."""
    from .graft import graft_node_pairs

    assert self.is_valid_add_node_pair(parent, child), (
        "invalid node pair", parent.to_string(), child.to_string())
    new, _ = graft_node_pairs(self, [(parent, child)])
    return _modify_in_place(self, new)


def _add_node_pairs_in_place(self: SubsplitDAG, pairs) -> ModificationResult:
    """Reference AddEdges/AddNodes bulk form.  Pairs are inserted
    sequentially (as repeated AddNodePair) so later pairs connect to earlier
    additions; a single batch graft would leave new-node <-> new-node edges
    out (graft_node_pairs deliberately connects candidates to host nodes
    only, for independent NNI scoring)."""
    from .graft import graft_node_pairs

    new = self
    for pair in pairs:
        new, _ = graft_node_pairs(new, [pair])
    return _modify_in_place(self, new)


def _fully_connect(self: SubsplitDAG) -> ModificationResult:
    """Reference SubsplitDAG::FullyConnect: add every valid edge between
    nodes already present."""
    n = self.taxon_count
    uca = Subsplit.uca(n)
    internal = set(self.nodes[n:self.root_id])
    by_union: Dict[int, List[Subsplit]] = {}
    for ss in internal:
        by_union.setdefault(ss.union, []).append(ss)
    edges: Set[Tuple[Subsplit, Subsplit]] = set()
    from ..core.bitset import bit_indices

    for ss in list(internal) + [uca]:
        for clade in (ss.clade0, ss.clade1):
            if clade == 0:
                continue
            if popcount(clade) == 1:
                edges.add((ss, Subsplit.leaf(bit_indices(clade)[0], n)))
                continue
            for c in by_union.get(clade, []):
                edges.add((ss, c))
    return _modify_in_place(self, _assemble(internal, edges,
                                            self.taxon_names))


def _topology_to_newick_topology(self: SubsplitDAG, topology) -> str:
    return topology.newick(self.taxon_names)


def _tree_to_newick_tree(self: SubsplitDAG, tree) -> str:
    return tree.newick(self.taxon_names)


def _get_taxon_map(self: SubsplitDAG):
    return {i: name for i, name in enumerate(self.taxon_names)}


def _compare_by_topology(self: SubsplitDAG, a, b) -> int:
    ka = frozenset(a.clades()[a.num_taxa:])
    kb = frozenset(b.clades()[b.num_taxa:])
    return 0 if ka == kb else (-1 if sorted(ka) < sorted(kb) else 1)


for _name, _fn in [
    ("add_nodes", _add_nodes), ("add_edges", _add_edges),
    ("add_node_pair", _add_node_pair), ("fully_connect", _fully_connect),
    ("topology_to_newick_topology", _topology_to_newick_topology),
    ("tree_to_newick_tree", _tree_to_newick_tree),
    ("get_taxon_map", _get_taxon_map),
    ("compare_by_topology", _compare_by_topology),
]:
    setattr(SubsplitDAG, _name, _fn)
