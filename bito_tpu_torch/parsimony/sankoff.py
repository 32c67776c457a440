"""Sankoff (weighted) parsimony, batched over trees and site patterns
(torch).

Port of bito_tpu.parsimony.sankoff (reference: src/sankoff_handler.hpp:
25-130, src/sankoff_matrix.hpp:4-6): one min-plus DP over the padded op
tape of likelihood pruning (treelike/encode.py),

    q_u[s] = min_s'(C[s,s'] + q_c1[s']) + min_s'(C[s,s'] + q_c2[s'])

with the identity (zero-cost diagonal) min-plus for accumulator ops.
bito_tpu's `lax.scan` over the tape's steps with a `vmap` over trees is
one Python loop over the steps here, each gathering one row a tree.  No
part of it is a hand-written kernel: bito_tpu's program is XLA, not Pallas.
Default cost matrix: unit off-diagonal (reference SankoffMatrix default).

The dtype is the handler's (bito_tpu takes its default float dtype, float64
under x64 and float32 otherwise).  BIG, the reference's INT_MAX, is not
exact in float32, where it rounds to 2^31, and every op clamps to it as
bito_tpu's does.  Scores are sums of small integers (below 2^24 at DS1's
width), so they are exact in either dtype.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.site_pattern import SitePattern
from ..core.tree import Tree
from ..device import PRODUCT_DEVICE, PRODUCT_DTYPE, resolve
from ..treelike.encode import encode_trees

BIG = float(2 ** 31 - 1)  # reference big_double_ == INT_MAX


def default_cost_matrix() -> np.ndarray:
    c = np.ones((4, 4))
    np.fill_diagonal(c, 0.0)
    return c


def leaf_partials(site_pattern: SitePattern, dtype=np.float64) -> np.ndarray:
    """[T, 4, S]: 0 for observed state(s), BIG otherwise; gaps all-zero
    (reference GenerateLeafPartials)."""
    states = site_pattern.tip_states()  # [T, S]
    T, S = states.shape
    out = np.full((T, 4, S), BIG, dtype=dtype)
    for a in range(4):
        out[:, a, :] = np.where(states == a, 0.0, out[:, a, :])
    out = np.where((states == 4)[:, None, :], 0.0, out)
    return out


def _minplus(C: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Batched min-plus 'matvec': out[b, s, x] = min_t (C[b, s, t] +
    q[b, t, x])."""
    return (C[:, :, :, None] + q[:, None, :, :]).amin(dim=2)


def sankoff_scores_impl(post_ops, root, tips, weights, cost, *,
                        num_slots: int):
    """Per-tree parsimony scores [B] and per-(tree, pattern) scores [B, S].
    post_ops [B, M, 5] and root [B] are int64 on the tensors' device; tips
    [T, A, S], weights [S] and cost [A, A] in the handler's dtype."""
    B = post_ops.shape[0]
    T, A, S = tips.shape
    buf = tips.new_zeros((B, num_slots + 1, A, S))
    buf[:, :T] = tips
    identity = torch.full((A, A), BIG, dtype=tips.dtype, device=tips.device)
    identity.fill_diagonal_(0.0)
    b = torch.arange(B, device=post_ops.device)
    for m in range(post_ops.shape[1]):
        dest, s1, e1, s2, e2 = post_ops[:, m].unbind(-1)
        c1 = torch.where((e1 == num_slots)[:, None, None], identity, cost)
        c2 = torch.where((e2 == num_slots)[:, None, None], identity, cost)
        val = _minplus(c1, buf[b, s1]) + _minplus(c2, buf[b, s2])
        # Clamp so BIG doesn't overflow into inf-like territory.
        buf[b, dest] = val.clamp(max=BIG)
    per_pattern = buf[b, root].amin(dim=1)  # [B, S]
    return per_pattern @ weights, per_pattern


class SankoffHandler:
    """Facade mirroring the reference SankoffHandler API, on `device` in
    `dtype` (the card in float32 unless the caller asks for another)."""

    def __init__(self, site_pattern: SitePattern,
                 cost_matrix: Optional[np.ndarray] = None, *,
                 device=PRODUCT_DEVICE, dtype=PRODUCT_DTYPE):
        self.device, self.dtype = resolve(device, dtype)
        self.site_pattern = site_pattern
        kw = dict(device=self.device, dtype=self.dtype)
        self.cost = torch.as_tensor(
            cost_matrix if cost_matrix is not None else default_cost_matrix(),
            **kw)
        self.tips = torch.as_tensor(leaf_partials(site_pattern), **kw)
        self.weights = torch.as_tensor(site_pattern.weights, **kw)
        self._per_pattern = None

    def run_sankoff(self, trees: Sequence[Tree]) -> np.ndarray:
        """Scores for a batch of trees; returns total weighted scores [B]
        as a host array, as bito_tpu's."""
        enc = encode_trees([t.topology for t in trees])
        totals, per_pattern = sankoff_scores_impl(
            torch.as_tensor(enc.post_ops, dtype=torch.long,
                            device=self.device),
            torch.as_tensor(enc.root, dtype=torch.long, device=self.device),
            self.tips, self.weights, self.cost, num_slots=enc.num_slots,
        )
        self._per_pattern = per_pattern.cpu().numpy()
        return totals.cpu().numpy()

    def parsimony_score(self, pattern_idx: Optional[int] = None):
        """Per-pattern score of the last run's first tree (reference
        ParsimonyScore(site)) or the full per-pattern matrix."""
        assert self._per_pattern is not None, "Call run_sankoff first"
        if pattern_idx is None:
            return self._per_pattern
        return float(self._per_pattern[0, pattern_idx])
