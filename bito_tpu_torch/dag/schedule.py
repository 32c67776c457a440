"""Levelized wavefront schedules: SubsplitDAG -> static index tensors.

Copy of bito_tpu.dag.schedule (numpy only; tests/test_torch_dag.py
pins the code by AST).

This replaces the reference's serial GPOperation tapes (reference:
src/gp_dag.cpp:78-304, src/gp_operation.hpp:24-170) with per-level batched
index arrays: one fused gather -> 4x4-matvec -> scatter-add per DAG level
(SURVEY P4).  Each schedule is compiled once per DAG epoch and closed over by
the jitted wavefront programs in bito_tpu/gp/engine.py.

Level structure:
  - rootward level of a node = 1 + max(level of children); leaves are 0.
    All phat contributions of a node land in its own level's batch.
  - leafward level = 1 + max(level of parents); rootsplits are 0.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .subsplit_dag import LEFT, RIGHT, SubsplitDAG

# PLV type slots (mirroring reference PLVTypeEnum, src/pv_handler.hpp:26-33)
P, PHAT_RIGHT, PHAT_LEFT, RHAT, RRIGHT, RLEFT = range(6)


@dataclass
class LevelEntries:
    """One rootward or leafward level's gather/scatter arrays."""

    edge: np.ndarray        # [K] edge ids
    dest: np.ndarray        # [K] destination node ids
    dest_side: np.ndarray   # [K] True == left
    src: np.ndarray         # [K] source node ids
    src_plv: np.ndarray     # [K] source PLV type (P for rootward; R* leafward)
    nodes: np.ndarray       # [M] node ids finalized at this level


@dataclass
class GPSchedule:
    node_count: int          # without the DAG root
    edge_count: int
    taxon_count: int
    rootward: List[LevelEntries]
    leafward: List[LevelEntries]
    rootsplit_nodes: np.ndarray
    rootsplit_edges: np.ndarray
    # per-edge arrays for the all-edges Likelihood op
    like_parent: np.ndarray      # [E] parent node (for non-root edges)
    like_r_plv: np.ndarray       # [E] which R PLV of the parent
    like_child: np.ndarray       # [E] child node
    like_mask: np.ndarray        # [E] False for edges from the DAG root
    # SBN normalization segments (start, end), children-of-parent contiguous
    sbn_segments: List[Tuple[int, int]]


def build_schedule(dag: SubsplitDAG) -> GPSchedule:
    n_nodes = dag.node_count_without_dag_root()
    n = dag.taxon_count
    root = dag.root_id

    # -- rootward levels --------------------------------------------------
    level = np.zeros(dag.node_count(), dtype=np.int64)
    for u in dag.rootward_node_trace(True):
        if u < n:
            continue
        kids = [c for side in (RIGHT, LEFT) for c, _ in dag.leafward[u][side]]
        level[u] = 1 + max(level[c] for c in kids)
    rootward: List[LevelEntries] = []
    max_level = int(level[:root].max()) if n_nodes > n else 0
    for l in range(1, max_level + 1):
        nodes = [u for u in range(n, root) if level[u] == l]
        edge, dest, dside, src = [], [], [], []
        for u in nodes:
            for side in (RIGHT, LEFT):
                for c, e in dag.leafward[u][side]:
                    edge.append(e)
                    dest.append(u)
                    dside.append(side)
                    src.append(c)
        rootward.append(LevelEntries(
            edge=np.asarray(edge, dtype=np.int32),
            dest=np.asarray(dest, dtype=np.int32),
            dest_side=np.asarray(dside, dtype=bool),
            src=np.asarray(src, dtype=np.int32),
            src_plv=np.full(len(edge), P, dtype=np.int32),
            nodes=np.asarray(nodes, dtype=np.int32),
        ))

    # -- leafward levels --------------------------------------------------
    # Rootsplits are sources (their RHat is set to q * stationary).
    ldepth = np.full(dag.node_count(), -1, dtype=np.int64)
    rootsplits = dag.rootsplit_ids()
    for r in rootsplits:
        ldepth[r] = 0
    order = sorted(range(n_nodes), key=lambda u: -u)  # parents have higher ids
    for u in order:
        if ldepth[u] == 0:
            continue
        parents = [
            p for side in (RIGHT, LEFT) for p, _ in dag.rootward[u][side]
            if p != root
        ]
        if parents:
            ldepth[u] = 1 + max(ldepth[p] for p in parents)
    leafward: List[LevelEntries] = []
    max_ldepth = int(ldepth[:root].max())
    for l in range(1, max_ldepth + 1):
        nodes = [u for u in range(n_nodes) if ldepth[u] == l]
        edge, dest, src, src_plv = [], [], [], []
        for u in nodes:
            for side in (RIGHT, LEFT):
                for p, e in dag.rootward[u][side]:
                    if p == root:
                        continue
                    edge.append(e)
                    dest.append(u)
                    src.append(p)
                    src_plv.append(RLEFT if side == LEFT else RRIGHT)
        leafward.append(LevelEntries(
            edge=np.asarray(edge, dtype=np.int32),
            dest=np.asarray(dest, dtype=np.int32),
            dest_side=np.zeros(len(edge), dtype=bool),
            src=np.asarray(src, dtype=np.int32),
            src_plv=np.asarray(src_plv, dtype=np.int32),
            nodes=np.asarray(nodes, dtype=np.int32),
        ))
    # Level 0: the rootsplits themselves (RHat seeded; RLeft/RRight built).
    leafward.insert(0, LevelEntries(
        edge=np.zeros(0, dtype=np.int32),
        dest=np.zeros(0, dtype=np.int32),
        dest_side=np.zeros(0, dtype=bool),
        src=np.zeros(0, dtype=np.int32),
        src_plv=np.zeros(0, dtype=np.int32),
        nodes=np.asarray(sorted(rootsplits), dtype=np.int32),
    ))

    # -- per-edge likelihood arrays ---------------------------------------
    E = dag.edge_count()
    like_parent = np.zeros(E, dtype=np.int32)
    like_r_plv = np.zeros(E, dtype=np.int32)
    like_child = np.asarray(dag.edge_child, dtype=np.int32)
    like_mask = np.ones(E, dtype=bool)
    for e in range(E):
        p = int(dag.edge_parent[e])
        if p == root:
            like_mask[e] = False
            like_parent[e] = 0
            continue
        like_parent[e] = p
        like_r_plv[e] = RLEFT if dag.edge_side[e] else RRIGHT

    segments = [
        rng for (p, side), rng in sorted(dag.parent_to_child_range.items())
    ]
    return GPSchedule(
        node_count=n_nodes,
        edge_count=E,
        taxon_count=n,
        rootward=rootward,
        leafward=leafward,
        rootsplit_nodes=np.asarray(sorted(rootsplits), dtype=np.int32),
        rootsplit_edges=np.asarray(
            [dag.edge_to_id[(root, r)] for r in sorted(rootsplits)],
            dtype=np.int32,
        ),
        like_parent=like_parent,
        like_r_plv=like_r_plv,
        like_child=like_child,
        like_mask=like_mask,
        sbn_segments=segments,
    )
