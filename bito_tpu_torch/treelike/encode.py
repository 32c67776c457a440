"""Tree-batch encoding: topologies -> static integer op tapes.

Host-side copy of bito_tpu.treelike.encode (numpy only), pinned equal to
it by tests/test_torch_encode.py.

This replaces the reference's per-tree BeagleOperation lists
(reference: src/fat_beagle.cpp:49-69, 113-169) with padded integer tensors
that a single jitted XLA program consumes for a whole batch of trees at once
(the TPU-native successor of FatBeagleParallelize's thread pool,
src/fat_beagle.hpp:151-184).

Encoding (per tree, padded across the batch):
  - Buffer slots 0..N-1 hold per-node partials; slot N is a constant
    all-ones "dummy" row; transition-matrix index N is the identity.
  - Postorder tape: each op is (dest, src1, edge1, src2, edge2) meaning
      partials[dest] = (P[edge1] @ partials[src1]) * (P[edge2] @ partials[src2])
    A node with k children lowers to k-1 ops (accumulating via dest as src1
    with the identity edge), so trifurcating roots and multifurcations work.
  - Preorder tape: each op is (dest, parent, sib1, edge1, sib2, edge2):
      outside[dest] = upper[parent] * (P[edge1] @ partials[sib1])
                                    * (P[edge2] @ partials[sib2])
      upper[dest]   = P[dest_edge]^T @ outside[dest]
    which yields linear-time branch gradients (the TPU equivalent of
    beagleUpdatePrePartials + beagleCalculateEdgeDerivatives,
    reference src/fat_beagle.cpp:113-169).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..core.tree import Topology


@dataclass
class TreeBatchEncoding:
    """Static encoding of a batch of B topologies over the same taxa."""

    num_taxa: int
    num_slots: int            # padded node count N (dummy slot index == N)
    # Postorder tape [B, M, 5]: dest, src1, edge1, src2, edge2
    post_ops: np.ndarray
    # Preorder tape [B, Mp, 6]: dest, parent, sib1, edge1, sib2, edge2
    pre_ops: np.ndarray
    root: np.ndarray          # [B]
    # edge_mask[b, n] == 1 iff node n has a real branch above it in tree b
    edge_mask: np.ndarray     # [B, N]
    node_counts: np.ndarray   # [B]

    @property
    def batch_size(self) -> int:
        return self.post_ops.shape[0]

    @property
    def dummy(self) -> int:
        return self.num_slots

    @property
    def identity_edge(self) -> int:
        return self.num_slots


def encode_trees(topologies: Sequence[Topology], num_slots: int | None = None
                 ) -> TreeBatchEncoding:
    num_taxa = topologies[0].num_taxa
    for t in topologies:
        assert t.num_taxa == num_taxa, "All trees must share a taxon set"
    N = num_slots or max(t.num_nodes for t in topologies)
    DUMMY = N
    IDENT = N

    post_all: List[List[List[int]]] = []
    pre_all: List[List[List[int]]] = []
    roots: List[int] = []
    masks = np.zeros((len(topologies), N), dtype=np.int32)
    counts = []

    for b, topo in enumerate(topologies):
        ch = topo.children()
        post: List[List[int]] = []
        for u in range(num_taxa, topo.num_nodes):
            kids = ch[u]
            assert len(kids) >= 2, f"Internal node {u} with <2 children"
            post.append([u, kids[0], kids[0], kids[1], kids[1]])
            for extra in kids[2:]:
                post.append([u, u, IDENT, extra, extra])
        # Preorder: root's upper is pi (seeded in the kernel); visit
        # internal nodes in descending id order so parents precede children.
        pre: List[List[int]] = []
        for v in range(topo.num_nodes - 1, num_taxa - 1, -1):
            kids = ch[v]
            for c in kids:
                sibs = [w for w in kids if w != c]
                assert len(sibs) <= 2, (
                    "Nodes of arity > 3 are not supported (the reference "
                    "requires bifurcating trees with at most a trifurcating root)"
                )
                s1 = sibs[0] if len(sibs) >= 1 else DUMMY
                e1 = sibs[0] if len(sibs) >= 1 else IDENT
                s2 = sibs[1] if len(sibs) >= 2 else DUMMY
                e2 = sibs[1] if len(sibs) >= 2 else IDENT
                pre.append([c, v, s1, e1, s2, e2])
        post_all.append(post)
        pre_all.append(pre)
        roots.append(topo.root)
        masks[b, : topo.num_nodes - 1] = 1  # every non-root node has an edge
        counts.append(topo.num_nodes)

    M = max(len(p) for p in post_all)
    Mp = max(len(p) for p in pre_all)
    post_arr = np.full((len(topologies), M, 5), 0, dtype=np.int32)
    post_arr[..., 0] = DUMMY
    post_arr[..., 1] = DUMMY
    post_arr[..., 2] = IDENT
    post_arr[..., 3] = DUMMY
    post_arr[..., 4] = IDENT
    for b, ops in enumerate(post_all):
        if ops:
            post_arr[b, : len(ops)] = np.asarray(ops, dtype=np.int32)
    pre_arr = np.zeros((len(topologies), Mp, 6), dtype=np.int32)
    pre_arr[..., 0] = DUMMY
    pre_arr[..., 1] = DUMMY
    pre_arr[..., 2] = DUMMY
    pre_arr[..., 3] = IDENT
    pre_arr[..., 4] = DUMMY
    pre_arr[..., 5] = IDENT
    for b, ops in enumerate(pre_all):
        if ops:
            pre_arr[b, : len(ops)] = np.asarray(ops, dtype=np.int32)

    return TreeBatchEncoding(
        num_taxa=num_taxa,
        num_slots=N,
        post_ops=post_arr,
        pre_ops=pre_arr,
        root=np.asarray(roots, dtype=np.int32),
        edge_mask=masks,
        node_counts=np.asarray(counts, dtype=np.int32),
    )


@dataclass
class LeveledEncoding:
    """Levelized variant of TreeBatchEncoding: ops grouped into wavefront
    levels so the device executes ~tree-depth big steps instead of
    ~node-count small ones (the copy/step-count economics of SURVEY P4
    applied to the classical engine)."""

    num_taxa: int
    num_slots: int
    post_levels: np.ndarray   # [L, B, W, 5]
    pre_levels: np.ndarray    # [Lp, B, Wp, 6]
    root: np.ndarray          # [B]
    edge_mask: np.ndarray     # [B, N]


def encode_trees_leveled(topologies: Sequence[Topology],
                         num_slots: int | None = None) -> LeveledEncoding:
    num_taxa = topologies[0].num_taxa
    N = num_slots or max(t.num_nodes for t in topologies)
    DUMMY = N
    IDENT = N
    B = len(topologies)

    post_by_level: List[List[List[List[int]]]] = []  # [B][level][ops]
    pre_by_level: List[List[List[List[int]]]] = []
    roots, masks = [], np.zeros((B, N), dtype=np.int32)
    for b, topo in enumerate(topologies):
        ch = topo.children()
        level = [0] * (topo.num_nodes + 1)
        tree_post: List[List[List[int]]] = []
        for u in range(num_taxa, topo.num_nodes):
            kids = ch[u]
            ops = [[u, kids[0], kids[0], kids[1], kids[1]]]
            for extra in kids[2:]:
                ops.append([u, u, IDENT, extra, extra])
            lvl = max(level[k] for k in kids)
            for op in ops:
                lvl += 1
                while len(tree_post) < lvl:
                    tree_post.append([])
                tree_post[lvl - 1].append(op)
            level[u] = lvl
        # Preorder levels: depth of the child node's op.
        depth = [0] * topo.num_nodes
        tree_pre: List[List[List[int]]] = []
        for v in range(topo.num_nodes - 1, num_taxa - 1, -1):
            kids = ch[v]
            d = depth[v] + 1
            for c in kids:
                depth[c] = d
                sibs = [w for w in kids if w != c]
                s1 = sibs[0] if len(sibs) >= 1 else DUMMY
                e1 = sibs[0] if len(sibs) >= 1 else IDENT
                s2 = sibs[1] if len(sibs) >= 2 else DUMMY
                e2 = sibs[1] if len(sibs) >= 2 else IDENT
                while len(tree_pre) < d:
                    tree_pre.append([])
                tree_pre[d - 1].append([c, v, s1, e1, s2, e2])
        post_by_level.append(tree_post)
        pre_by_level.append(tree_pre)
        roots.append(topo.root)
        masks[b, : topo.num_nodes - 1] = 1

    L = max(len(t) for t in post_by_level)
    W = max((len(lvl) for t in post_by_level for lvl in t), default=1)
    post = np.zeros((L, B, W, 5), dtype=np.int32)
    post[..., 0] = DUMMY
    post[..., 1] = DUMMY
    post[..., 2] = IDENT
    post[..., 3] = DUMMY
    post[..., 4] = IDENT
    for b, t in enumerate(post_by_level):
        for l, lvl in enumerate(t):
            if lvl:
                post[l, b, : len(lvl)] = np.asarray(lvl, dtype=np.int32)
    Lp = max(len(t) for t in pre_by_level)
    Wp = max((len(lvl) for t in pre_by_level for lvl in t), default=1)
    pre = np.zeros((Lp, B, Wp, 6), dtype=np.int32)
    pre[..., 0] = DUMMY
    pre[..., 1] = DUMMY
    pre[..., 2] = DUMMY
    pre[..., 3] = IDENT
    pre[..., 4] = DUMMY
    pre[..., 5] = IDENT
    for b, t in enumerate(pre_by_level):
        for l, lvl in enumerate(t):
            if lvl:
                pre[l, b, : len(lvl)] = np.asarray(lvl, dtype=np.int32)
    return LeveledEncoding(
        num_taxa=num_taxa, num_slots=N, post_levels=post, pre_levels=pre,
        root=np.asarray(roots, dtype=np.int32), edge_mask=masks,
    )
