"""TidySubsplitDAG: clean/dirty PLV-invalidation tracking.

Copy of bito_tpu.dag.tidy (numpy only; tests/test_torch_dag.py
pins the code by AST).

Faithful rebuild of the reference TidySubsplitDAG
(reference: src/tidy_subsplit_dag.hpp:4-241, src/tidy_subsplit_dag.cpp):
a node-clade is dirty iff a calculation below it has invalidated the
p-hat PLV coming up into it; the tidy depth-first traversal interleaves
`update_edge` repairs of dirty sister clades with `modify_edge` work so
branch-length optimization only recomputes invalidated PLVs.

Status in this framework: the wavefront GP engine recomputes whole
levels per sweep — measured faster on TPU than fine-grained invalidation
(IMPLEMENTATION_NOTES L5, a round-2 measured decision that rounds 3-4
re-affirmed) — so this structure is NOT on the product hot path.  It is
provided as the complete, tested equivalent of the reference component
(the last row of the SURVEY §2 inventory): host-side analysis, traversal
scheduling experiments, and parity against the reference's slicing
doctest (src/tidy_subsplit_dag.hpp:204-241) all run against it.

Representation: numpy bool matrices.  `above[s][i, j]` == True iff
node-clade (i, side s) is above node j (a node is above/below itself,
matching the reference's convention); `dirty[s][i]` == True iff
something below node-clade (i, side s) has been modified.
"""
from __future__ import annotations

from typing import List, Optional, Set, Tuple

import numpy as np

from .subsplit_dag import LEFT, RIGHT, SubsplitDAG


class TidyTraversalAction:
    """The reference TidySubsplitDAGTraversalAction bundle
    (before_node / after_node / before_node_clade / modify_edge /
    update_edge); defaults are no-ops so tests can override a subset."""

    def __init__(self, before_node=None, after_node=None,
                 before_node_clade=None, modify_edge=None,
                 update_edge=None):
        noop = lambda *a: None
        self.before_node = before_node or noop
        self.after_node = after_node or noop
        self.before_node_clade = before_node_clade or noop
        self.modify_edge = modify_edge or noop
        self.update_edge = update_edge or noop


class TidySubsplitDAG:
    def __init__(self, dag: SubsplitDAG):
        self.dag = dag
        self.reinitialize_tidy_vectors()

    # -- construction (reference ReinitializeTidyVectors) ----------------
    def reinitialize_tidy_vectors(self):
        n = self.dag.node_count()
        self.above = {
            LEFT: np.eye(n, dtype=bool),
            RIGHT: np.eye(n, dtype=bool),
        }
        self.dirty = {
            LEFT: np.zeros(n, dtype=bool),
            RIGHT: np.zeros(n, dtype=bool),
        }
        self._updating_below: Optional[Tuple[int, int]] = None
        # Depth-first from the DAG root, recording each edge's side
        # (reference SetBelow via DepthFirstWithAction VisitEdge).
        for parent, child, side in self._postorder_edges():
            self._set_below(parent, side, child)

    def _children(self, node_id: int, side: int) -> List[int]:
        return [int(c) for c, _e in self.dag.leafward[node_id][side]]

    def _postorder_edges(self):
        """Every (parent, child, side) via depth-first from the root, with
        children fully processed before the edge into them is recorded."""
        out = []
        visited: Set[int] = set()

        def visit(u: int):
            if u in visited or self.dag.is_leaf(u):
                return
            visited.add(u)
            for side in (LEFT, RIGHT):
                for c in self._children(u, side):
                    visit(c)
                    out.append((u, c, side))

        visit(self.dag.root_id)
        return out

    def _set_below(self, dst: int, side: int, src: int):
        """BelowNode(side, dst) |= BelowNode(src) (reference SetBelow)."""
        self.above[side][:, dst] |= self.below_node(src)

    # -- slicing (reference BelowNode/AboveNode) -------------------------
    def below_node(self, node_id: int, side: Optional[int] = None
                   ) -> np.ndarray:
        if side is None:
            return (self.above[LEFT][:, node_id]
                    | self.above[RIGHT][:, node_id])
        return self.above[side][:, node_id].copy()

    def above_node(self, node_id: int, side: Optional[int] = None
                   ) -> np.ndarray:
        if side is None:
            return (self.above[LEFT][node_id] | self.above[RIGHT][node_id])
        return self.above[side][node_id].copy()

    # -- dirt tracking ----------------------------------------------------
    def dirty_vector(self, side: int) -> np.ndarray:
        return self.dirty[side]

    def is_dirty_below(self, node_id: int, side: int) -> bool:
        """Any dirty node-clade below (node_id, side) (reference
        IsDirtyBelow: elementwise min == and, then max == any)."""
        return bool((self.above[side][:, node_id]
                     & self.dirty[side]).any())

    def set_dirty_strictly_above(self, node_id: int):
        for side in (LEFT, RIGHT):
            to_dirty = self.above[side][node_id].copy()
            to_dirty[node_id] = False
            self.dirty[side] |= to_dirty

    def set_clean(self):
        self._updating_below = None
        self.dirty[LEFT][:] = False
        self.dirty[RIGHT][:] = False

    # -- tidy traversal (reference DepthFirstWithTidyAction) --------------
    def depth_first_with_tidy_action(self, starting_nodes,
                                     action: TidyTraversalAction):
        visited: Set[int] = set()
        for node_id in starting_nodes:
            self._for_node(action, int(node_id), visited)

    def _for_node(self, action, node_id, visited):
        action.before_node(node_id)
        # Left then right, matching the reference (#288/#321 comment).
        self._for_node_clade(action, node_id, LEFT, visited)
        self._for_node_clade(action, node_id, RIGHT, visited)
        action.after_node(node_id)

    def _for_node_clade(self, action, node_id, side, visited):
        if self._updating_below is not None:
            self._update_for_node_clade(action, node_id, side, visited)
        else:
            self._modify_for_node_clade(action, node_id, side, visited)

    def _update_for_node_clade(self, action, node_id, side, visited):
        """Recursively repair dirty PLVs under (node_id, side) with
        update_edge (reference UpdateWithTidyActionForNodeClade)."""
        if self.is_dirty_below(node_id, side):
            for child in self._children(node_id, side):
                if not self.dag.is_leaf(child):
                    self._for_node_clade(action, child, LEFT, visited)
                    self._for_node_clade(action, child, RIGHT, visited)
                    action.after_node(child)
                action.update_edge(node_id, child, side)
                self.dirty[side][node_id] = False
        if self._updating_below == (node_id, side):
            self._updating_below = None

    def _modify_for_node_clade(self, action, node_id, side, visited):
        """Perform edge modification under (node_id, side), cleaning the
        sister clade first if it is dirty (reference
        ModifyWithTidyActionForNodeClade)."""
        other = RIGHT if side == LEFT else LEFT
        if self.is_dirty_below(node_id, other):
            self._updating_below = (node_id, other)
            self._update_for_node_clade(action, node_id, other, visited)
        action.before_node_clade(node_id, side)
        for child in self._children(node_id, side):
            if child not in visited:
                visited.add(child)
                if not self.dag.is_leaf(child):
                    self._for_node(action, child, visited)
            action.modify_edge(node_id, child, side)
            self.set_dirty_strictly_above(node_id)
            # modify_edge leaves (node_id, side) itself clean.
            self.dirty[side][node_id] = False

    # -- diagnostics -------------------------------------------------------
    def above_matrices_as_string(self) -> str:
        def fmt(m):
            return "\n".join(
                " ".join("1" if x else "0" for x in row) for row in m)

        return (f"[\n{fmt(self.above[LEFT])}, \n"
                f"{fmt(self.above[RIGHT])}\n]")

    def record_traversal(self) -> str:
        """Reference RecordTraversal: the modify/update schedule as text
        (pinned by tests for regression visibility)."""
        lines: List[str] = []
        self.depth_first_with_tidy_action(
            [self.dag.root_id],
            TidyTraversalAction(
                before_node_clade=lambda n, s: lines.append(
                    f"descending along {n}, {bool(s == LEFT)}"),
                modify_edge=lambda n, c, s: lines.append(
                    f"modifying: {n}, {c}, {bool(s == LEFT)}"),
                update_edge=lambda n, c, s: lines.append(
                    f"updating:  {n}, {c}, {bool(s == LEFT)}"),
            ),
        )
        return "\n".join(lines)
