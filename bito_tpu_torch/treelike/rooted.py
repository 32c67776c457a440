"""Rooted time-tree state and height/ratio gradient transforms.

Copy of bito_tpu.treelike.rooted (numpy only; tests/test_torch_rooted.py
pins the code by AST): a rebuild of the reference RootedTree height
machinery and RootedGradientTransforms (reference: src/rooted_tree.cpp:36-130,
src/rooted_gradient_transforms.cpp:19-256; BEAST-derived math by Xiang Ji
and Marc Suchard).  Host-side numpy, O(n) per tree: these
reparameterization chains are tiny next to the likelihood work on the
card.

Convention (matching the reference): `branch_gradient` throughout is
d logL / d(substitution-length b_i) where b_i = rate_i * time_i; the
transforms apply the rate chain-rule factors themselves.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.tree import Topology, Tree

BRANCH_LENGTH_TOLERANCE = 1e-6


@dataclass
class RootedTreeState:
    """node_heights/bounds/height_ratios for one rooted tree (reference
    RootedTree fields, src/rooted_tree.hpp:3-27)."""

    tree: Tree
    node_heights: np.ndarray
    node_bounds: np.ndarray
    height_ratios: np.ndarray  # [leaf_count - 1]; root slot holds root height
    rates: np.ndarray

    @property
    def leaf_count(self):
        return self.tree.topology.num_taxa

    @property
    def root_id(self):
        return self.tree.topology.root


def set_tip_dates(tree: Tree, dates: Sequence[float]) -> RootedTreeState:
    """Reference RootedTree::SetTipDates + SetNodeBoundsUsingDates."""
    topo = tree.topology
    n = topo.num_taxa
    N = topo.num_nodes
    heights = np.zeros(N)
    bounds = np.zeros(N)
    heights[:n] = dates
    bounds[:n] = dates
    ch = topo.children()
    for v in range(n, N):
        bounds[v] = max(bounds[c] for c in ch[v])
    return RootedTreeState(
        tree=tree,
        node_heights=heights,
        node_bounds=bounds,
        height_ratios=np.zeros(n - 1),
        rates=np.ones(N - 1),
    )


def initialize_time_tree_using_branch_lengths(state: RootedTreeState):
    """Reference InitializeTimeTreeUsingBranchLengths: heights from branch
    lengths (requires a time-calibrated tree), then ratios."""
    topo = state.tree.topology
    n = topo.num_taxa
    ch = topo.children()
    bl = state.tree.branch_lengths
    for v in range(n, topo.num_nodes):
        c0, c1 = ch[v]
        state.node_heights[v] = state.node_heights[c0] + bl[c0]
        diff = abs(state.node_heights[c1] + bl[c1] - state.node_heights[v])
        if diff > BRANCH_LENGTH_TOLERANCE:
            raise ValueError(
                f"Tree isn't time-calibrated; height difference {diff}"
            )
    root = topo.root
    state.height_ratios[root - n] = state.node_heights[root]
    for v in range(n, topo.num_nodes):
        if v == root:
            continue
        p = int(topo.parents[v])
        state.height_ratios[v - n] = (
            (state.node_heights[v] - state.node_bounds[v])
            / (state.node_heights[p] - state.node_bounds[v])
        )


def initialize_time_tree_using_height_ratios(state: RootedTreeState,
                                             height_ratios: np.ndarray):
    """Reference InitializeTimeTreeUsingHeightRatios: heights (and branch
    lengths) from the ratio parameterization, preorder."""
    topo = state.tree.topology
    n = topo.num_taxa
    root = topo.root
    state.height_ratios[:] = height_ratios
    state.node_heights[root] = height_ratios[root - n]
    # Preorder: descending ids visits parents before children.
    for v in range(topo.num_nodes - 2, -1, -1):
        p = int(topo.parents[v])
        if v >= n:
            state.node_heights[v] = (
                state.node_bounds[v]
                + height_ratios[v - n]
                * (state.node_heights[p] - state.node_bounds[v])
            )
        state.tree.branch_lengths[v] = (
            state.node_heights[p] - state.node_heights[v]
        )


# ---------------------------------------------------------------------------
# Gradient transforms
# ---------------------------------------------------------------------------
def height_gradient(state: RootedTreeState,
                    branch_gradient: np.ndarray) -> np.ndarray:
    """dL/dt_k for internal-node heights (reference HeightGradient,
    src/rooted_gradient_transforms.cpp:19-39)."""
    topo = state.tree.topology
    n = topo.num_taxa
    root = topo.root
    ch = topo.children()
    rates = state.rates
    out = np.zeros(n - 1)
    for v in range(n, topo.num_nodes):
        if v != root:
            out[v - n] = -branch_gradient[v] * rates[v]
        for c in ch[v]:
            out[v - n] += branch_gradient[c] * rates[c]
    return out


def _node_partial(state, v):
    n = state.leaf_count
    return ((state.node_heights[v] - state.node_bounds[v])
            / state.height_ratios[v - n])


def _update_gradient_unweighted(state: RootedTreeState,
                                gradient_height: np.ndarray) -> np.ndarray:
    """Reference UpdateGradientUnWeightedLogDensity
    (src/rooted_gradient_transforms.cpp:82-105): postorder epoch-aware
    accumulation of d t_j / d r_k."""
    topo = state.tree.topology
    n = topo.num_taxa
    root = topo.root
    ch = topo.children()
    out = np.zeros(n - 1)
    heights, ratios, bounds = (state.node_heights, state.height_ratios,
                               state.node_bounds)
    for v in range(n, topo.num_nodes):  # ascending ids == postorder-safe
        if v == root:
            continue
        out[v - n] += _node_partial(state, v) * gradient_height[v - n]
        for c in ch[v]:
            if c < n:
                continue
            if bounds[v] == bounds[c]:
                out[v - n] += out[c - n] * ratios[c - n] / ratios[v - n]
            else:
                out[v - n] += (
                    out[c - n] * ratios[c - n] / (heights[v] - bounds[c])
                    * _node_partial(state, v)
                )
    return out


def _root_height_gradient(state: RootedTreeState,
                          gradient: np.ndarray) -> float:
    """Reference UpdateHeightParameterGradientUnweightedLogDensity."""
    topo = state.tree.topology
    n = topo.num_taxa
    root = topo.root
    ch = topo.children()
    mult = np.zeros(n - 1)
    mult[root - n] = 1.0
    for v in range(topo.num_nodes - 1, n - 1, -1):  # preorder
        for c in ch[v]:
            if c >= n:
                mult[c - n] = state.height_ratios[c - n] * mult[v - n]
    return float(np.dot(gradient, mult))


def _log_time_array(state: RootedTreeState) -> np.ndarray:
    n = state.leaf_count
    out = np.zeros(n - 1)
    for i in range(n - 2):
        out[i] = 1.0 / (state.node_heights[n + i] - state.node_bounds[n + i])
    return out


def gradient_log_det_jacobian(state: RootedTreeState) -> np.ndarray:
    """Reference GradientLogDeterminantJacobian
    (src/rooted_gradient_transforms.cpp:137-152)."""
    n = state.leaf_count
    root = state.root_id
    log_time = _log_time_array(state)
    out = _update_gradient_unweighted(state, log_time)
    out[root - n] = _root_height_gradient(state, log_time)
    out[:-1] -= 1.0 / state.height_ratios[:-1]
    return out


def ratio_gradient_of_height_gradient(state: RootedTreeState,
                                      height_grad: np.ndarray) -> np.ndarray:
    out = _update_gradient_unweighted(state, height_grad)
    out[state.root_id - state.leaf_count] = _root_height_gradient(
        state, height_grad
    )
    return out


def ratio_gradient_of_branch_gradient(
    state: RootedTreeState, branch_gradient: np.ndarray,
    include_log_det_jacobian: bool = True,
) -> np.ndarray:
    """Reference RatioGradientOfBranchGradient
    (src/rooted_gradient_transforms.cpp:170-223)."""
    hg = height_gradient(state, branch_gradient)
    out = ratio_gradient_of_height_gradient(state, hg)
    if include_log_det_jacobian:
        out += gradient_log_det_jacobian(state)
    return out


def log_det_jacobian_height_transform(state: RootedTreeState) -> float:
    """Reference LogDetJacobianHeightTransform
    (src/rooted_gradient_transforms.cpp:242-256)."""
    topo = state.tree.topology
    n = topo.num_taxa
    total = 0.0
    for v in range(n, topo.num_nodes):
        if v == topo.root:
            continue
        p = int(topo.parents[v])
        total += np.log(state.node_heights[p] - state.node_bounds[v])
    return float(total)
