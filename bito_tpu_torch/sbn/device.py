"""Device-side SBN training and topology gradients (torch).

Port of bito_tpu.sbn.device (reference: SBNProbability::
ExpectationMaximization, src/sbn_probability.cpp:214-331, and
GradientOfLogQ / TopologyGradients, src/unrooted_sbn_instance.cpp:
170-240).  Where the numpy versions in probability.py / gradients.py walk
python dicts per topology, these pack everything into static index
tensors once per support and run the math as segment reductions on the
device:

  - per-parent-range normalization  -> scatter_reduce("amax") / index_add_
    over seg_id
  - EM E-step softmax over rootings -> one [T, R] logsumexp
  - EM M-step log-space scatter-add -> exp-shift + index_add_ over indices
  - GradientOfLogQ touched ranges   -> static child_seg/childrot_seg gathers
    (the ranges of a rooted tree are exactly {rootsplit range} plus both
    orientations of index_to_child[idx] for every idx in the
    representation, src/generic_sbn_instance.hpp:449-462)

These are tensor programs, not kernels: plain torch on the device the
caller names, always in float64 (the EM score's monotonicity check and
its parity with the numpy version assume float64 noise).  The EM loop is
a Python loop over device work, with bito_tpu's control flow: the score
is recorded every iteration, and the loop stops when the relative
improvement falls under score_epsilon after the first iteration (the
only host read of an iteration, and only where score_epsilon > 0).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import PRODUCT_DEVICE
from .support import SBNSupport

NEG_INF = -math.inf
DTYPE = torch.float64


# ---------------------------------------------------------------------------
# Static per-support index tensors


class SupportArrays:
    """Index tensors derived from an SBNSupport, built once and cached on the
    support object (numpy; moved to a device per call)."""

    def __init__(self, support: SBNSupport):
        size = support.size()
        segs = support.segments()
        seg_id = np.full(size, -1, dtype=np.int64)
        range_to_seg = {}
        for g, (s, e) in enumerate(segs):
            seg_id[s:e] = g
            range_to_seg[(s, e)] = g
        assert (seg_id >= 0).all(), "segments must partition the support"
        child_seg = np.full(size, -1, dtype=np.int64)
        childrot_seg = np.full(size, -1, dtype=np.int64)
        for i, child in enumerate(support.index_to_child):
            rng = support.parent_to_range.get(child.to_string())
            if rng is not None:
                child_seg[i] = range_to_seg[rng]
            rng = support.parent_to_range.get(child.rotate().to_string())
            if rng is not None:
                childrot_seg[i] = range_to_seg[rng]
        self.size = size
        self.num_segments = len(segs)
        self.seg_id = seg_id
        self.child_seg = child_seg
        self.childrot_seg = childrot_seg


def support_arrays(support: SBNSupport) -> SupportArrays:
    arrays = getattr(support, "_device_arrays", None)
    if arrays is None or arrays.size != support.size():
        arrays = SupportArrays(support)
        support._device_arrays = arrays
    return arrays


def pack_unrooted(representations, size: int) -> np.ndarray:
    """[n_topologies, n_rootings, L] int64 index tensor padded with -1.
    Out-of-support entries (reference sentinel == size) are kept as `size`
    so callers can invalidate whole rootings."""
    n_topo = len(representations)
    n_root = max(len(r) for r in representations)
    L = max(len(rr) for r in representations for rr in r)
    arr = np.full((n_topo, n_root, L), -1, dtype=np.int64)
    for i, rep in enumerate(representations):
        for j, rooted in enumerate(rep):
            arr[i, j, : len(rooted)] = rooted
    return arr


def _segment_sum(values, ids, num_segments):
    out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
    return out.index_add_(0, ids, values)


def _logsumexp_rows(x):
    """log sum exp over the last axis, -inf for a row of -inf (as
    bito_tpu's max-shifted form)."""
    row_max = x.max(dim=-1).values
    safe = torch.where(torch.isfinite(row_max), row_max,
                       torch.zeros_like(row_max))
    return torch.log(torch.exp(x - safe[..., None]).sum(dim=-1)) + safe


# ---------------------------------------------------------------------------
# Normalization


def _normalize_in_log(params, seg_id, num_segments):
    """Per-segment log normalization (reference
    ProbabilityNormalizeParamsInLog, src/sbn_probability.cpp:135-144).
    Segments that are entirely -inf stay -inf; so does an empty segment's
    max, as jax.ops.segment_max leaves it."""
    m = torch.full((num_segments,), NEG_INF, dtype=params.dtype,
                   device=params.device).scatter_reduce(
                       0, seg_id, params, "amax", include_self=False)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    z = _segment_sum(torch.exp(params - m_safe[seg_id]), seg_id, num_segments)
    lse = torch.where(finite, torch.log(z) + m_safe, m)
    lse_i = lse[seg_id]
    return torch.where(torch.isfinite(lse_i), params - lse_i,
                       torch.full_like(params, NEG_INF))


# ---------------------------------------------------------------------------
# Expectation maximization


def _em_loop(reps, counts, log_m_tilde, seg_id, alpha: float,
             score_epsilon: float, max_iter: int, num_segments: int):
    """(sbn, score history [max_iter] NaN-padded, iterations run)."""
    size = seg_id.shape[0]
    n_topo, n_root, L = reps.shape
    dtype, dev = log_m_tilde.dtype, log_m_tilde.device

    valid = reps >= 0
    safe = torch.where(valid, reps, torch.zeros_like(reps))
    row_valid = valid.any(dim=-1)
    flat_idx = torch.where(valid, reps, torch.full_like(reps, size)).reshape(-1)
    log_counts = torch.log(counts)
    neg_inf = torch.tensor(NEG_INF, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    # Starting point: normalized mean-over-rootings counts
    # (src/sbn_probability.cpp:242-247); the alpha>0 regularizer keeps the
    # unnormalized log m_tilde + log alpha.
    log_m_tilde0 = log_m_tilde - math.log(n_root)
    sbn = _normalize_in_log(log_m_tilde0, seg_id, num_segments)
    if alpha > 0.0:
        log_m_tilde_a = log_m_tilde0 + math.log(alpha)
        m_tilde_exp = torch.exp(log_m_tilde_a)
    else:
        log_m_tilde_a = torch.full_like(log_m_tilde0, NEG_INF)
        m_tilde_exp = torch.zeros_like(log_m_tilde0)

    history = torch.full((max_iter,), math.nan, dtype=dtype, device=dev)
    prev_score = zero
    i = 0
    while i < max_iter:
        padded = torch.cat([sbn, torch.zeros(1, dtype=dtype, device=dev)])
        entry = torch.where(valid, padded[safe], zero)
        log_p_rooted = torch.where(row_valid, entry.sum(dim=-1), neg_inf)
        log_p_unrooted = _logsumexp_rows(log_p_rooted)
        score = (counts * log_p_unrooted).sum()
        # E-step weights, M-step scatter-add (log space via a global shift:
        # log_q <= max log_counts so exp never overflows).  A PCSP whose
        # mass is under exp(-745) of the largest underflows to 0 here and
        # its parameter becomes -inf, where the numpy loop's logaddexp
        # keeps a log value far below that: the same probability, 0.
        log_q = log_p_rooted - log_p_unrooted[:, None] + log_counts[:, None]
        finite = torch.isfinite(log_q)
        shift = torch.where(finite, log_q, neg_inf).max()
        w = torch.where(finite, torch.exp(log_q - shift), zero)
        contrib = w[:, :, None].expand(n_topo, n_root, L).reshape(-1)
        m_lin = _segment_sum(contrib, flat_idx, size + 1)[:size]
        log_m_bar = torch.where(m_lin > 0.0, torch.log(m_lin) + shift, neg_inf)
        sbn = _normalize_in_log(torch.logaddexp(log_m_bar, log_m_tilde_a),
                                seg_id, num_segments)
        reg = torch.where(m_tilde_exp > 0.0, m_tilde_exp * sbn, zero).sum()
        score = score + reg
        history[i] = score
        i += 1
        if score_epsilon > 0.0 and i > 1:
            imp = (score - prev_score) / prev_score.abs()
            if bool(imp.abs() < score_epsilon):
                break
        prev_score = score
    return sbn, history, i


def expectation_maximization(
    support: SBNSupport,
    representations,
    counts: Sequence[int],
    alpha: float,
    max_iter: int,
    score_epsilon: float = 0.0,
    *,
    device=PRODUCT_DEVICE,
) -> Tuple[np.ndarray, np.ndarray]:
    """Device-side SBN-EM in float64 on `device`; same contract as
    probability.expectation_maximization."""
    from . import probability

    dev = torch.device(device)
    arrays = support_arrays(support)
    reps = pack_unrooted(representations, support.size())
    counts = np.asarray(list(counts), dtype=np.float64)
    log_m_tilde = probability.set_log_counts(support, representations, counts)
    kw = dict(dtype=DTYPE, device=dev)
    sbn, history, n = _em_loop(
        torch.as_tensor(reps, device=dev), torch.as_tensor(counts, **kw),
        torch.as_tensor(log_m_tilde, **kw),
        torch.as_tensor(arrays.seg_id, device=dev), float(alpha),
        float(score_epsilon), int(max_iter), arrays.num_segments)
    history = history[:n].cpu().numpy()
    if n > 1:
        imp = np.diff(history) / np.abs(history[:-1])
        assert (imp > -1e-10).all(), "EM score decreased"
    return sbn.cpu().numpy(), history


# ---------------------------------------------------------------------------
# Topology gradients (GradientOfLogQ)


def _topology_gradients(reps, factors, params, seg_id, child_seg,
                        childrot_seg, num_segments: int):
    """grad = sum_t factor_t * d log q(tau_t) / d phi, fully vectorized.

    Per rooting r of topology t with P(rooted) p_{t,r} and q_t = sum_r p_{t,r}
    (reference GradientOfLogQ): the gradient contribution is
    scale_{t,r} * (indicator over rep indices - softmax over touched ranges)
    with scale_{t,r} = factor_t * p_{t,r} / q_t.  Touched ranges per rooting
    are segment 0 plus child_seg/childrot_seg of every rep index; each range
    is touched at most once per rooting (each subsplit appears once per
    rooted tree), and each in-tree index lies in exactly one touched range,
    so plain segment sums reproduce the reference's per-range loop."""
    size = seg_id.shape[0]
    n_topo, n_root, L = reps.shape
    dtype, dev = params.dtype, params.device
    zero = torch.zeros((), dtype=dtype, device=dev)

    in_support = (reps >= 0) & (reps < size)
    present = reps >= 0
    # A rooting is usable iff every present index is in support
    # (reference skips rootings containing the out-of-support sentinel).
    row_valid = present.any(-1) & ~(present & ~in_support).any(-1)
    safe = torch.where(in_support, reps, torch.zeros_like(reps))

    norm = _normalize_in_log(params, seg_id, num_segments)
    exp_norm = torch.where(torch.isfinite(norm), torch.exp(norm), zero)
    padded = torch.cat([norm, torch.zeros(1, dtype=dtype, device=dev)])
    entry = torch.where(in_support, padded[safe], zero)
    log_p_rooted = torch.where(row_valid, entry.sum(-1),
                               torch.full_like(zero, NEG_INF))    # [T, R]
    log_q = _logsumexp_rows(log_p_rooted)                         # [T]
    scale = torch.where(
        torch.isfinite(log_p_rooted) & torch.isfinite(log_q)[:, None],
        torch.exp(log_p_rooted - log_q[:, None]), zero
    ) * factors[:, None]                                          # [T, R]

    # Indicator part: + scale at every in-tree index.
    flat_idx = torch.where(in_support, reps,
                           torch.full_like(reps, size)).reshape(-1)
    contrib = scale[:, :, None].expand(n_topo, n_root, L).reshape(-1)
    grad = _segment_sum(contrib, flat_idx, size + 1)[:size]

    # Softmax part: - (total touched weight per segment) * exp(norm).
    seg_gather = torch.stack([child_seg[safe], childrot_seg[safe]],
                             dim=-1)                              # [T,R,L,2]
    seg_ok = in_support[..., None] & (seg_gather >= 0)
    seg_safe = torch.where(seg_ok, seg_gather,
                           torch.full_like(seg_gather, num_segments))
    seg_contrib = torch.where(seg_ok, scale[:, :, None, None], zero)
    seg_w = _segment_sum(seg_contrib.reshape(-1), seg_safe.reshape(-1),
                         num_segments + 1)[:num_segments]
    # Rootsplit range (segment 0) is touched once per valid rooting.
    seg_w[0] += (scale * row_valid).sum()
    return grad - seg_w[seg_id] * exp_norm


def topology_gradients(
    support: SBNSupport,
    sbn_parameters: np.ndarray,
    unrooted_reps,
    log_f: np.ndarray,
    use_vimco: bool = True,
    *,
    device=PRODUCT_DEVICE,
) -> np.ndarray:
    """Device-side UnrootedSBNInstance::TopologyGradients in float64 on
    `device` (reference src/unrooted_sbn_instance.cpp:216-240)."""
    from . import gradients

    dev = torch.device(device)
    arrays = support_arrays(support)
    reps = pack_unrooted(unrooted_reps, support.size())
    factors = (gradients.vimco_multiplicative_factors(log_f) if use_vimco
               else gradients.multiplicative_factors(log_f))
    kw = dict(dtype=DTYPE, device=dev)
    grad = _topology_gradients(
        torch.as_tensor(reps, device=dev), torch.as_tensor(factors, **kw),
        torch.as_tensor(np.asarray(sbn_parameters, dtype=np.float64), **kw),
        torch.as_tensor(arrays.seg_id, device=dev),
        torch.as_tensor(arrays.child_seg, device=dev),
        torch.as_tensor(arrays.childrot_seg, device=dev),
        arrays.num_segments)
    return grad.cpu().numpy()
