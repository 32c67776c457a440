"""SBN probability: SimpleAverage and ExpectationMaximization training,
topology probabilities, and segment-normalization utilities.

Host-side copy of bito_tpu.sbn.probability (numpy only), pinned equal to it by
tests/test_torch_sbn.py.

Rebuild of the reference SBNProbability
(reference: src/sbn_probability.cpp:140-392, src/sbn_probability.hpp:15-66).
Representations are packed into padded index matrices so the EM loop is
vectorized numpy (log-space scatter-adds) instead of the reference's nested
per-topology loops; semantics (alpha regularization, score trace, in-log
normalization over parent ranges) are preserved.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .support import SBNSupport

NEG_INF = -np.inf


def _logaddexp_at(vec: np.ndarray, idx: np.ndarray, vals: np.ndarray):
    """vec[idx] = logaddexp(vec[idx], vals) with duplicate-index support."""
    order = np.argsort(idx, kind="stable")
    idx_s = idx[order]
    vals_s = vals[order]
    uniq, starts = np.unique(idx_s, return_index=True)
    for u, s, e in zip(uniq, starts, list(starts[1:]) + [len(idx_s)]):
        vec[u] = np.logaddexp(vec[u], _logsumexp(vals_s[s:e]))


def _logsumexp(x: np.ndarray, axis=None):
    m = np.max(x, axis=axis, keepdims=True)
    m_safe = np.where(np.isfinite(m), m, 0.0)
    out = np.log(np.sum(np.exp(x - m_safe), axis=axis, keepdims=True)) + m_safe
    out = np.where(np.isfinite(m), out, m)
    if axis is not None:
        out = np.squeeze(out, axis=axis)
    else:
        out = out.reshape(())
    return out


def normalize_in_log(sbn_parameters: np.ndarray, support: SBNSupport) -> np.ndarray:
    """Normalize each segment so it holds log probabilities (reference
    ProbabilityNormalizeParamsInLog, src/sbn_probability.cpp:135-144).
    Segment ranges partition the support contiguously, so the whole pass is
    two reduceat sweeps instead of a per-segment Python loop."""
    x = np.asarray(sbn_parameters, dtype=np.float64)
    starts = np.asarray(sorted(s for s, _ in support.segments()),
                        dtype=np.int64)
    rank = np.searchsorted(starts, np.arange(x.size), side="right") - 1
    m = np.maximum.reduceat(x, starts)
    finite = np.isfinite(m)
    m_safe = np.where(finite, m, 0.0)
    sums = np.add.reduceat(np.exp(x - m_safe[rank]), starts)
    lse = np.where(finite, np.log(sums) + m_safe, m)
    lse_i = lse[rank]
    return np.where(np.isfinite(lse_i), x - lse_i, NEG_INF)


def set_log_counts(support: SBNSupport, representations, counts) -> np.ndarray:
    """log of weighted counts over representations (reference SetLogCounts,
    src/sbn_probability.cpp:167-201).  For unrooted representations every
    rooting contributes."""
    vec = np.full(support.size(), NEG_INF)
    for rep, count in zip(representations, counts):
        logc = np.log(float(count))
        rows = rep if isinstance(rep[0], (list, tuple)) else [rep]
        for rooted in rows:
            for idx in rooted:
                vec[idx] = np.logaddexp(vec[idx], logc)
    return vec


def simple_average(support: SBNSupport, representations, counts) -> np.ndarray:
    """SBN-SA (reference SBNProbability::SimpleAverage): sbn_parameters =
    log counts; downstream consumers normalize per segment."""
    return set_log_counts(support, representations, counts)


def _pack_unrooted(representations) -> Tuple[np.ndarray, np.ndarray]:
    """Pack unrooted representations into [n_topologies, n_rootings, L]
    index array padded with -1 (all trees over one taxon set share shapes)."""
    n_topo = len(representations)
    n_root = max(len(r) for r in representations)
    L = max(len(rr) for r in representations for rr in r)
    arr = np.full((n_topo, n_root, L), -1, dtype=np.int64)
    for i, rep in enumerate(representations):
        for j, rooted in enumerate(rep):
            arr[i, j, : len(rooted)] = rooted
    return arr


def expectation_maximization(
    support: SBNSupport,
    representations,          # list of unrooted representations
    counts: Sequence[int],
    alpha: float,
    max_iter: int,
    score_epsilon: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """SBN-EM (reference SBNProbability::ExpectationMaximization,
    src/sbn_probability.cpp:214-331).  Returns (sbn_parameters, score_history).

    Vectorized: log_P(rooting) = sum of parameters over each rooted
    representation -> [n_topo, n_rootings]; the E-step softmaxes over
    rootings; the M-step scatter-adds q-weighted counts in log space."""
    counts = np.asarray(list(counts), dtype=np.float64)
    reps = _pack_unrooted(representations)
    n_topo, n_root, L = reps.shape
    size = support.size()
    valid = reps >= 0
    safe = np.where(valid, reps, 0)

    log_m_tilde = set_log_counts(support, representations, counts)
    log_m_tilde = log_m_tilde - np.log(reps.shape[1])
    sbn = normalize_in_log(log_m_tilde.copy(), support)

    if alpha > 0.0:
        log_m_tilde = log_m_tilde + np.log(alpha)
        m_tilde_exp = np.exp(log_m_tilde)

    flat = safe.reshape(n_topo * n_root, L)
    flat_valid = valid.reshape(n_topo * n_root, L)
    log_counts = np.log(counts)

    score_history = []
    for em_idx in range(max_iter):
        padded = np.concatenate([sbn, [0.0]])
        entry = np.where(flat_valid, padded[flat], 0.0)
        log_p_rooted = entry.sum(axis=1).reshape(n_topo, n_root)  # [T, R]
        log_p_unrooted = _logsumexp(log_p_rooted, axis=1)         # [T]
        score = float(np.dot(counts, log_p_unrooted))
        # E-step: q weights; M-step: scatter-add in log space.
        log_q = (log_p_rooted - log_p_unrooted[:, None]
                 + log_counts[:, None])                            # [T, R]
        contrib = np.where(flat_valid, log_q.reshape(-1)[:, None], NEG_INF)
        log_m_bar = np.full(size, NEG_INF)
        _logaddexp_at(log_m_bar, flat[flat_valid], contrib[flat_valid])
        sbn = (np.logaddexp(log_m_bar, log_m_tilde) if alpha > 0.0
               else log_m_bar)
        sbn = normalize_in_log(sbn, support)
        if alpha > 0.0:
            score += float(m_tilde_exp @ sbn)
        score_history.append(score)
        if em_idx > 0:
            imp = (score_history[-1] - score_history[-2]) / abs(
                score_history[-2]
            )
            assert imp > -1e-10, "EM score decreased"
            if abs(imp) < score_epsilon:
                break
    return sbn, np.asarray(score_history)


def probability_of(support_size: int, sbn_parameters: np.ndarray, rep) -> float:
    """Probability of a rooted or unrooted representation (reference
    ProbabilityOfSingle, src/sbn_probability.cpp:349-372): out-of-support
    (sentinel index == len(params)) gives 0."""
    rows = rep if isinstance(rep[0], (list, tuple)) else [rep]
    total = NEG_INF
    for rooted in rows:
        if any(i >= support_size for i in rooted):
            continue
        total = np.logaddexp(total, float(sbn_parameters[list(rooted)].sum()))
    return float(np.exp(total))


def probabilities_of_collection(support: SBNSupport, sbn_parameters, reps
                                ) -> np.ndarray:
    norm = sbn_parameters  # caller supplies normalized-in-log parameters
    if not reps:
        return np.zeros(0)
    if not isinstance(reps[0][0], (list, tuple, np.ndarray)):
        # rooted: one flat representation per tree
        return np.asarray(
            [probability_of(support.size(), norm, rep) for rep in reps]
        )
    size = support.size()
    packed = _pack_unrooted(reps)                       # [T, R, L], pad -1
    present = packed >= 0
    in_support = present & (packed < size)
    row_ok = present.any(-1) & ~(present & ~in_support).any(-1)
    padded = np.concatenate([np.asarray(norm, np.float64), [0.0]])
    entry = np.where(in_support, padded[np.where(in_support, packed, 0)], 0.0)
    log_p_rooted = np.where(row_ok, entry.sum(-1), NEG_INF)   # [T, R]
    return np.exp(_logsumexp(log_p_rooted, axis=1))
