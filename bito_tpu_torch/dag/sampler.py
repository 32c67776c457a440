"""Sampling a single topology from a subsplit DAG.

Copy of bito_tpu.dag.sampler (numpy only; tests/test_torch_dag.py
pins the code by AST).

TPU-native rebuild of the reference TopologySampler
(reference: src/topology_sampler.{hpp,cpp}): starting from any DAG node,
walk rootward choosing parents with probabilities proportional to the
inverted (Bayes-rule rootward) edge probabilities, and leafward choosing
children proportional to the normalized SBN parameters; every newly reached
node continues the walk in the directions it has not yet covered.  The
result is one rooted topology embedded in the DAG that contains the origin
node.

Design shift: the reference assembles a SubsplitDAGStorage subgraph and
wraps the UCA in a unary root node (src/topology_sampler.cpp:102-127); here
the chosen child of each visited (node, clade) is recorded directly and the
returned Topology is rooted at the sampled rootsplit.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..core.tree import Topology, _renumber
from .subsplit_dag import LEFT, RIGHT, SubsplitDAG


class DAGTopologySampler:
    """Reference TopologySampler (src/topology_sampler.hpp:17-58)."""

    def __init__(self, seed: Optional[int] = None):
        self.rng = np.random.default_rng(seed)

    def set_seed(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def sample(
        self,
        dag: SubsplitDAG,
        normalized_sbn_parameters: np.ndarray,
        inverted_probabilities: np.ndarray,
        origin_node_id: int,
    ) -> Topology:
        params = np.asarray(normalized_sbn_parameters, dtype=np.float64)
        inverted = np.asarray(inverted_probabilities, dtype=np.float64)
        root_id = dag.root_id
        # (node, side) -> chosen child id, for every node in the sampled tree.
        chosen: Dict[Tuple[int, bool], int] = {}

        # Explicit work stacks (not recursion): deep caterpillar-ish DAGs
        # would otherwise exceed CPython's recursion limit, where the
        # reference sampler iterates.
        def sample_leafward(start_node: int, start_side: bool):
            stack = [(start_node, start_side)]
            while stack:
                node, side = stack.pop()
                neighbors = dag.leafward[node][side]
                if not neighbors:
                    continue  # reached a leaf (or the UCA's empty clade)
                weights = np.array([params[e] for _, e in neighbors])
                total = weights.sum()
                assert total > 0.0, "no probability mass among leafward edges"
                child, _ = neighbors[self.rng.choice(len(neighbors),
                                                     p=weights / total)]
                chosen[(node, side)] = child
                # VisitNode(child, Rootward, clade): continue leafward both
                # ways, LEFT subtree fully before RIGHT (recursive order).
                stack.append((child, RIGHT))
                stack.append((child, LEFT))

        def sample_rootward(node: int):
            # The rootward walk is a single chain up to the UCA; on the way
            # back down, each visited parent descends its other clade (the
            # recursive version's unwind order, preserved for seeded
            # reproducibility).
            pending = []
            while True:
                neighbors = (dag.rootward[node][LEFT]
                             + dag.rootward[node][RIGHT])
                if not neighbors:
                    break  # reached the UCA root
                sides = ([LEFT] * len(dag.rootward[node][LEFT])
                         + [RIGHT] * len(dag.rootward[node][RIGHT]))
                weights = np.array([inverted[e] for _, e in neighbors])
                total = weights.sum()
                assert total > 0.0, "no probability mass among rootward edges"
                k = self.rng.choice(len(neighbors), p=weights / total)
                parent, _ = neighbors[k]
                side = sides[k]
                chosen[(parent, side)] = node
                pending.append((parent, not side))
                node = parent
            for parent, side in reversed(pending):
                sample_leafward(parent, side)

        sample_rootward(origin_node_id)
        sample_leafward(origin_node_id, LEFT)
        sample_leafward(origin_node_id, RIGHT)

        # The rootward walk always reaches the UCA; its chosen child is the
        # sampled rootsplit (the reference's unary-root child).
        rootsplit = chosen.get((root_id, LEFT), chosen.get((root_id, RIGHT)))
        assert rootsplit is not None, "sampling never reached the DAG root"

        n = dag.taxon_count
        children: Dict[int, list] = {i: [] for i in range(n)}
        counter = [n]

        def build(start: int) -> int:
            # Iterative postorder (explicit stack; see the walk note above).
            result: Dict[int, int] = {}
            stack = [(start, False)]
            while stack:
                node, expanded = stack.pop()
                if dag.is_leaf(node):
                    result[node] = node
                    continue
                if not expanded:
                    stack.append((node, True))
                    stack.append((chosen[(node, RIGHT)], False))
                    stack.append((chosen[(node, LEFT)], False))
                else:
                    nid = counter[0]
                    counter[0] += 1
                    children[nid] = [result[chosen[(node, LEFT)]],
                                     result[chosen[(node, RIGHT)]]]
                    result[node] = nid
            return result[start]

        root = build(rootsplit)
        maxid = max(children.keys())
        ch_list = [children.get(i, []) for i in range(maxid + 1)]
        return _renumber(ch_list, n, root)
