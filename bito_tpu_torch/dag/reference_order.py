"""Reference-identical node/edge id assignment for the subsplit DAG.

Copy of bito_tpu.dag.reference_order (numpy only; tests/test_torch_dag.py
pins the code by AST).

The DS1 NNI golden run (reference data/ds1/test/run.811b735.csv) depends on
the reference's *internal id ordering*: tree-source priorities are assigned
to incidental new edges in edge-id order, the post-acceptance optimization
visits extra edges in edge-id order, and choice-map priority ties break by
neighbor node id.  This module reproduces the reference's id layout exactly:

- Initial build (reference SubsplitDAG::BuildNodes/BuildEdges,
  src/subsplit_dag.cpp:1228-1283): leaves 0..n-1, internal nodes by
  depth-first postorder from each rootsplit visiting the right (sorted,
  rotated=false) clade before the left, UCA root last; edges per parent node
  ascending, left clade then right, then the rootsplit edges.
- AddNodePair (reference AddNodePairInternals + BuildNodeReindexer +
  BuildEdgeReindexer, src/subsplit_dag.cpp:1938-2320): edges created in the
  Connect* order, new edges from existing parents inserted at the end of
  the parent's (node, clade) child range (Reindexer::ReassignAndShift), and
  node ids re-canonicalized by a postorder DFS from the root (right clade
  first, children by ascending pre-mutation id).

The standard builder (`dag.subsplit_dag.build_dag`) keeps its deterministic
sorted layout; these functions are the drop-ins for trajectory-faithful
work (nni/golden.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.bitset import Subsplit, popcount
from ..core.tree import TreeCollection
from .subsplit_dag import (LEFT, RIGHT, ModificationResult, SubsplitDAG,
                           build_dag)


def _assemble_in_order(taxon_names: Sequence[str],
                       nodes: List[Subsplit],
                       edge_triples: List[Tuple[int, int, bool]]
                       ) -> SubsplitDAG:
    """Build a SubsplitDAG with the GIVEN node order and edge order
    (edge_triples are (parent_id, child_id, side) over that node order)."""
    leafward = [{LEFT: [], RIGHT: []} for _ in nodes]
    rootward = [{LEFT: [], RIGHT: []} for _ in nodes]
    edge_parent, edge_child, edge_side = [], [], []
    edge_to_id: Dict[Tuple[int, int], int] = {}
    parent_to_child_range: Dict[Tuple[int, bool], Tuple[int, int]] = {}
    for eid, (p, c, side) in enumerate(edge_triples):
        edge_parent.append(p)
        edge_child.append(c)
        edge_side.append(side)
        edge_to_id[(p, c)] = eid
        leafward[p][side].append((c, eid))
        rootward[c][side].append((p, eid))
        # Reference AddNodePair leaves the central edge OUTSIDE its (new)
        # parent's stored child range (the range map is stateful, see
        # ConnectParentToAllChildrenExcept), so edges of a (node, clade) are
        # not necessarily contiguous here; this derived map keeps the
        # bounding span (only the GP schedule consumes it, on DAGs built by
        # the standard contiguous builder).
        key = (p, side)
        if key in parent_to_child_range:
            start, end = parent_to_child_range[key]
            parent_to_child_range[key] = (min(start, eid), max(end, eid + 1))
        else:
            parent_to_child_range[key] = (eid, eid + 1)
    # Reference adjacency containers are sorted maps keyed by node id.
    for adj in (leafward, rootward):
        for entry in adj:
            for side in (LEFT, RIGHT):
                entry[side].sort(key=lambda t: t[0])
    return SubsplitDAG(
        taxon_names=list(taxon_names),
        nodes=nodes,
        subsplit_to_id={s.to_string(): i for i, s in enumerate(nodes)},
        edge_parent=np.asarray(edge_parent, dtype=np.int32),
        edge_child=np.asarray(edge_child, dtype=np.int32),
        edge_side=np.asarray(edge_side, dtype=bool),
        edge_to_id=edge_to_id,
        parent_to_child_range=parent_to_child_range,
        leafward=leafward,
        rootward=rootward,
    )


def build_dag_reference_ordered(collection: TreeCollection) -> SubsplitDAG:
    """build_dag with the reference's initial id layout."""
    base = build_dag(collection)
    n = base.taxon_count
    uca = Subsplit.uca(n)

    # Children of each (subsplit, clade), sorted by child-subsplit bitset
    # order (the reference's index_to_child sets).
    def children_of(ss: Subsplit, side: bool,
                    include_leaves: bool) -> List[Subsplit]:
        nid = (base.root_id if ss.is_uca()
               else base.subsplit_to_id[ss.to_string()])
        kids = [base.nodes[c] for c, _ in base.leafward[nid][side]]
        if not include_leaves:
            kids = [k for k in kids if not k.is_leaf()]
        return sorted(kids, key=lambda s: s.sort_key())

    # Rootsplits in first-appearance order over the collection's trees
    # (reference ProcessTopologyCounter rootsplit collection).
    rootsplits: List[Subsplit] = []
    seen: Set[str] = set()
    for tree in collection.trees:
        topo = tree.topology
        cl = topo.clades()
        ch = topo.children()
        kids = ch[topo.root]
        rs = Subsplit.of_pair(cl[kids[0]], cl[kids[1]], n)
        if rs.to_string() not in seen:
            seen.add(rs.to_string())
            rootsplits.append(rs)

    # BuildNodesDepthFirst: rotated=false (right clade) before rotated=true.
    nodes: List[Subsplit] = [Subsplit.leaf(i, n) for i in range(n)]
    visited: Set[str] = set()

    def dfs(ss: Subsplit):
        visited.add(ss.to_string())
        for side in (RIGHT, LEFT):
            for child in children_of(ss, side, include_leaves=False):
                if child.to_string() not in visited:
                    dfs(child)
        nodes.append(ss)

    for rs in rootsplits:
        if rs.to_string() not in visited:
            dfs(rs)
    nodes.append(uca)
    new_id = {s.to_string(): i for i, s in enumerate(nodes)}

    # BuildEdges: per node ascending, left clade (rotated=true) then right;
    # the DAG root last.
    triples: List[Tuple[int, int, bool]] = []
    ref_ranges: Dict[Tuple[str, bool], Tuple[int, int]] = {}
    for nid in range(n, len(nodes)):
        ss = nodes[nid]
        sides = (LEFT,) if ss.is_uca() else (LEFT, RIGHT)
        for side in sides:
            start = len(triples)
            for child in children_of(ss, side, include_leaves=True):
                triples.append((nid, new_id[child.to_string()], side))
            ref_ranges[(ss.to_string(), side)] = (start, len(triples))
    out = _assemble_in_order(collection.taxon_names, nodes, triples)
    # The reference's stateful parent_to_child_range_ (keyed by oriented
    # subsplit, so it survives node reindexing); AddNodePair insertion
    # points come from THIS map, not from edge adjacency.
    out._ref_ranges = ref_ranges
    return out


def add_node_pair_reference_ordered(dag: SubsplitDAG, parent_ss: Subsplit,
                                    child_ss: Subsplit) -> ModificationResult:
    """In-place AddNodePair with the reference's final id assignment
    (reference AddNodePairInternals, src/subsplit_dag.cpp:1965-2085)."""
    n = dag.taxon_count
    prv_node_count = dag.node_count()
    prv_edge_count = dag.edge_count()
    old_root = dag.root_id

    # Working copies with old ids; new nodes appended.
    nodes: List[Subsplit] = list(dag.nodes)
    triples: List[Tuple[int, int, bool]] = [
        (int(dag.edge_parent[e]), int(dag.edge_child[e]),
         bool(dag.edge_side[e]))
        for e in range(prv_edge_count)
    ]

    def node_id_of(ss: Subsplit) -> Optional[int]:
        if ss.is_uca():
            return old_root
        got = dag.subsplit_to_id.get(ss.to_string())
        if got is not None:
            return got
        for i in range(prv_node_count, len(nodes)):
            if nodes[i].to_string() == ss.to_string():
                return i
        return None

    def find_children(ss: Subsplit, clade: int) -> List[int]:
        """Nodes (ascending id) whose clade union equals `clade`
        (reference FindChildNodeIdsViaMap)."""
        out = []
        for i, other in enumerate(nodes):
            if i == old_root:
                continue
            if other.union == clade:
                out.append(i)
        return out

    def find_parents(ss: Subsplit) -> Tuple[List[int], List[int]]:
        """(left, right) parent node ids: nodes with a clade equal to this
        subsplit's union (reference FindParentNodeIdsViaMap); the UCA root
        parents rootsplits on its left."""
        left, right = [], []
        u = ss.union
        for i, other in enumerate(nodes):
            if i == old_root:
                if ss.is_rootsplit():
                    left.append(i)
                continue
            if other.clade0 == u:
                left.append(i)
            if other.clade1 == u:
                right.append(i)
        return left, right

    parent_is_new = node_id_of(parent_ss) is None
    child_is_new = node_id_of(child_ss) is None
    added_node_ids_old: List[int] = []
    added_edge_ids_old: List[int] = []
    if not hasattr(dag, "_ref_ranges"):
        # DAG from the standard contiguous builder: seed the stateful range
        # map from its (node, clade) ranges.
        dag._ref_ranges = {
            (dag.nodes[p].to_string(), side): rng
            for (p, side), rng in dag.parent_to_child_range.items()
        }
    ref_ranges: Dict[Tuple[str, bool], Tuple[int, int]] = dict(
        getattr(dag, "_ref_ranges"))
    fresh_ranges: Dict[Tuple[str, bool], Tuple[int, int]] = {}

    # -- creation phase (old ids) ---------------------------------------
    if child_is_new:
        cid = len(nodes)
        nodes.append(child_ss)
        added_node_ids_old.append(cid)
        # ConnectChildToAllChildren: left clade then right; a fresh child
        # range is recorded for each clade (reference SafeInsert).
        for side, clade in ((LEFT, child_ss.clade0), (RIGHT, child_ss.clade1)):
            start = len(triples)
            for k in find_children(child_ss, clade):
                added_edge_ids_old.append(len(triples))
                triples.append((cid, k, side))
            fresh_ranges[(child_ss.to_string(), side)] = (start, len(triples))
    if parent_is_new:
        pid = len(nodes)
        nodes.append(parent_ss)
        added_node_ids_old.append(pid)
        cid_now = node_id_of(child_ss)
        for side, clade in ((LEFT, parent_ss.clade0),
                            (RIGHT, parent_ss.clade1)):
            start = len(triples)
            for k in find_children(parent_ss, clade):
                if k == cid_now:
                    continue
                added_edge_ids_old.append(len(triples))
                triples.append((pid, k, side))
            fresh_ranges[(parent_ss.to_string(), side)] = (start,
                                                           len(triples))

    reindex_start = len(triples)
    pid = node_id_of(parent_ss)
    cid = node_id_of(child_ss)
    central_side = LEFT if child_ss.union == parent_ss.clade0 else RIGHT
    added_edge_ids_old.append(len(triples))
    triples.append((pid, cid, central_side))
    if parent_is_new:
        reindex_start = len(triples)
    if child_is_new:
        # ConnectChildToAllParentsExcept: left parents then right.
        lp, rp = find_parents(child_ss)
        for side, plist in ((LEFT, lp), (RIGHT, rp)):
            for g in plist:
                if g == pid:
                    continue
                added_edge_ids_old.append(len(triples))
                triples.append((g, cid, side))
    if parent_is_new:
        lp, rp = find_parents(parent_ss)
        for side, plist in ((LEFT, lp), (RIGHT, rp)):
            for g in plist:
                added_edge_ids_old.append(len(triples))
                triples.append((g, pid, side))

    E_total = len(triples)

    # -- edge reindexer (reference BuildEdgeReindexer +
    #    Reindexer::ReassignAndShift, reindexer.cpp:88-113) ---------------
    edge_reindexer_full = np.arange(E_total, dtype=np.int64)

    def reassign_and_shift(old_id: int, new_id: int):
        if old_id == new_id:
            return
        pos = int(np.where(edge_reindexer_full == old_id)[0][0])
        if old_id > new_id:
            mask = (edge_reindexer_full < old_id) & (edge_reindexer_full
                                                     >= new_id)
            edge_reindexer_full[mask] += 1
        else:
            mask = (edge_reindexer_full > old_id) & (edge_reindexer_full
                                                     <= new_id)
            edge_reindexer_full[mask] -= 1
        edge_reindexer_full[pos] = new_id

    for e in range(reindex_start, E_total):
        p, c, side = triples[e]
        # Old (pre-mutation) child-edge range of this parent clade, from the
        # stateful range map (reference GetChildEdgeRange).
        rng = ref_ranges.get((nodes[p].to_string(), side))
        assert rng is not None, "reindexed edge must join an existing range"
        assert rng[1] < E_total, "range end must be a live edge index"
        new_idx = int(edge_reindexer_full[rng[1]])
        reassign_and_shift(e, new_idx)

    # -- node reindexer (reference BuildNodeReindexer: postorder DFS from
    #    the root, right clade first, children ascending old id) ----------
    leafward_tmp: List[Dict[bool, List[int]]] = [
        {LEFT: [], RIGHT: []} for _ in nodes
    ]
    for (p, c, side) in triples:
        leafward_tmp[p][side].append(c)
    node_reindexer_full = np.arange(len(nodes), dtype=np.int64)
    counter = [n]
    visited: Set[int] = set()

    def visit(u: int):
        for side in (RIGHT, LEFT):
            for c in sorted(leafward_tmp[u][side]):
                if c in visited:
                    continue
                visited.add(c)
                if c >= n:
                    visit(c)
        node_reindexer_full[u] = counter[0]
        counter[0] += 1

    visit(old_root)
    assert counter[0] == len(nodes), "node DFS must reach every node"

    # -- apply both permutations and swap into the live DAG ---------------
    new_nodes: List[Subsplit] = [None] * len(nodes)
    for old, new in enumerate(node_reindexer_full):
        new_nodes[int(new)] = nodes[old]
    new_triples: List[Tuple[int, int, bool]] = [None] * E_total
    for old, new in enumerate(edge_reindexer_full):
        p, c, side = triples[old]
        new_triples[int(new)] = (int(node_reindexer_full[p]),
                                 int(node_reindexer_full[c]), side)
    rebuilt = _assemble_in_order(dag.taxon_names, new_nodes, new_triples)
    dag.__dict__.update(rebuilt.__dict__)
    # Remap the stateful range map (reference RemapEdgeIdxs): endpoints map
    # through the edge reindexer independently; fresh ranges join in.
    new_ref_ranges: Dict[Tuple[str, bool], Tuple[int, int]] = {}
    for key, (s0, e0) in list(ref_ranges.items()) + list(
            fresh_ranges.items()):
        assert e0 < E_total, "range end must be a live edge index"
        new_ref_ranges[key] = (int(edge_reindexer_full[s0]),
                               int(edge_reindexer_full[e0]))
    dag._ref_ranges = new_ref_ranges

    return ModificationResult(
        added_node_ids=[int(node_reindexer_full[i])
                        for i in added_node_ids_old],
        added_edge_ids=[int(edge_reindexer_full[i])
                        for i in added_edge_ids_old],
        node_reindexer=np.asarray(node_reindexer_full[:prv_node_count],
                                  dtype=np.int32),
        edge_reindexer=np.asarray(edge_reindexer_full[:prv_edge_count],
                                  dtype=np.int32),
    )
