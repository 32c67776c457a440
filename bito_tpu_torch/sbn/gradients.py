"""SBN topology gradients: GradientOfLogQ, ELBO and VIMCO multiplicative
factors.

Host-side copy of bito_tpu.sbn.gradients (numpy only), pinned equal to it by
tests/test_torch_sbn.py.

Rebuild of the reference gradient machinery
(reference: src/unrooted_sbn_instance.cpp:170-240 GradientOfLogQ +
TopologyGradients; src/generic_sbn_instance.hpp:464-497 multiplicative /
VIMCO factors).  The lazily-filled normalized-parameter cache becomes an
explicit memo over parent ranges; the per-PCSP accumulation is vectorized
over each range.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .probability import _logsumexp
from .support import SBNSupport

NEG_INF = -np.inf


def multiplicative_factors(log_f: np.ndarray) -> np.ndarray:
    """Reference CalculateMultiplicativeFactors
    (src/generic_sbn_instance.hpp:464-472): hat_L - tilde_w."""
    log_f = np.asarray(log_f, dtype=np.float64)
    tree_count = log_f.size
    log_F = _logsumexp(log_f)
    hat_L = log_F - np.log(tree_count)
    tilde_w = np.exp(log_f - log_F)
    return hat_L - tilde_w


def vimco_multiplicative_factors(log_f: np.ndarray) -> np.ndarray:
    """Reference CalculateVIMCOMultiplicativeFactors
    (src/generic_sbn_instance.hpp:474-497): geometric-mean perturbation
    per-sample learning signal."""
    log_f = np.asarray(log_f, dtype=np.float64)
    tree_count = log_f.size
    log_tree_count = np.log(tree_count)
    sum_log_f = log_f.sum()
    log_geo_mean = (sum_log_f - log_f) / (tree_count - 1)
    per_sample_signal = np.empty(tree_count)
    for j in range(tree_count):
        perturbed = log_f.copy()
        perturbed[j] = log_geo_mean[j]
        per_sample_signal[j] = _logsumexp(perturbed) - log_tree_count
    return multiplicative_factors(log_f) - per_sample_signal


def _subsplit_ranges(support: SBNSupport, rooted_rep: Sequence[int]
                     ) -> List[Tuple[int, int]]:
    """Reference GetSubsplitRanges (src/generic_sbn_instance.hpp:449-462):
    the rootsplit range plus both orientations of every subsplit in the
    rooted tree."""
    ranges = [(0, support.rootsplit_count)]
    root = support.rootsplits[rooted_rep[0]]
    for ss in (root, root.rotate()):
        rng = support.parent_to_range.get(ss.to_string())
        if rng is not None:
            ranges.append(rng)
    for idx in rooted_rep[1:]:
        child = support.index_to_child[idx]
        for ss in (child, child.rotate()):
            rng = support.parent_to_range.get(ss.to_string())
            if rng is not None:
                ranges.append(rng)
    return ranges


class NormalizedParamCache:
    """Lazy per-range normalization memo (the reference's NaN-sentinel
    normalized_sbn_parameters_in_log vector)."""

    def __init__(self, sbn_parameters: np.ndarray):
        self.raw = np.asarray(sbn_parameters, dtype=np.float64)
        self.norm = np.full(self.raw.shape, np.nan)

    def ensure(self, rng: Tuple[int, int]):
        start, end = rng
        if np.isnan(self.norm[start]):
            seg = self.raw[start:end]
            log_sum = _logsumexp(seg)
            assert np.isfinite(log_sum), (
                "GradientOfLogQ encountered non-finite normalization"
            )
            self.norm[start:end] = seg - log_sum


def gradient_of_log_q(
    support: SBNSupport,
    cache: NormalizedParamCache,
    unrooted_rep,
) -> np.ndarray:
    """d log q(tau) / d phi (reference GradientOfLogQ,
    src/unrooted_sbn_instance.cpp:170-213): sum over in-support rootings of
    P(rooted) * (indicator - softmax) over each touched parent range,
    normalized by q(tau)."""
    size = support.size()
    grad = np.zeros(size)
    log_q = NEG_INF
    for rooted in unrooted_rep:
        if any(i >= size for i in rooted):
            continue
        ranges = _subsplit_ranges(support, rooted)
        for rng in ranges:
            cache.ensure(rng)
        log_p_rooted = float(cache.norm[list(rooted)].sum())
        p_rooted = np.exp(log_p_rooted)
        in_tree = set(rooted)
        for start, end in ranges:
            idx = np.arange(start, end)
            indicator = np.fromiter(
                (i in in_tree for i in idx), dtype=np.float64, count=end - start
            )
            grad[start:end] += p_rooted * (
                indicator - np.exp(cache.norm[start:end])
            )
        log_q = np.logaddexp(log_q, log_p_rooted)
    grad *= np.exp(-log_q)
    return grad


def topology_gradients(
    support: SBNSupport,
    sbn_parameters: np.ndarray,
    unrooted_reps,
    log_f: np.ndarray,
    use_vimco: bool = True,
) -> np.ndarray:
    """Reference UnrootedSBNInstance::TopologyGradients
    (src/unrooted_sbn_instance.cpp:216-240)."""
    factors = (vimco_multiplicative_factors(log_f) if use_vimco
               else multiplicative_factors(log_f))
    cache = NormalizedParamCache(sbn_parameters)
    grad = np.zeros(support.size())
    for rep, factor in zip(unrooted_reps, factors):
        grad += factor * gradient_of_log_q(support, cache, rep)
    return grad
