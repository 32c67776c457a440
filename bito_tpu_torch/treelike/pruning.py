"""Batched Felsenstein pruning and linear-time branch gradients (torch).

Port of bito_tpu.treelike.pruning, the scan tape (reference:
src/engine.cpp:27-119, src/fat_beagle.cpp:49-169).  The batch axis that
JAX adds with `vmap` is written out here, and the tape runs as a Python
loop over its ops in place of `scan`.  Each op gathers one row per tree
(`buf[b, idx[b]]` with b = arange(B)) and scatters its result back.  The
buffers are updated in place, which JAX's functional scan cannot do; the
values are the same.

This is the engine's route wherever it takes no kernel: f64, per-tree
model rows, kernel="scan", and any model the kernels do not take.

Data layout (patterns last, as in bito_tpu):
  partials  [B, N+1, C, A, S]
  logscale  [B, N+1, S]        per-node accumulated log rescaling factors
  P         [B, N+1, C, A, A]  transition matrices (+ identity at index N)

Rescaling is always on, per postorder op (max over categories and states
per pattern), as in bito_tpu.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..models.substitution import (
    EigenDecomp,
    transition_derivatives,
    transition_matrices,
)


def _evolve(P_row: torch.Tensor, p_row: torch.Tensor) -> torch.Tensor:
    """[B,C,A,A] @ [B,C,A,S] -> [B,C,A,S]."""
    return P_row @ p_row


def _evolve_t(P_row: torch.Tensor, o_row: torch.Tensor) -> torch.Tensor:
    """Transpose evolve: [B,C,A,A]^T @ [B,C,A,S] -> [B,C,A,S]."""
    return P_row.transpose(-1, -2) @ o_row


def transition_matrices_ext(
    eig: EigenDecomp, branch_lengths: torch.Tensor,
    category_rates: torch.Tensor, clock_rate: torch.Tensor,
    derivative: bool = False,
) -> torch.Tensor:
    """[B, N] branch lengths -> [B, N+1, C, A, A] transition matrices with
    an identity (or zero, for derivatives) appended at index N.

    All model ingredients are per-tree batched: eig fields lead with B,
    category_rates is [B, C], clock_rate is [B]."""
    t = (branch_lengths[:, :, None] * category_rates[:, None, :]
         * clock_rate[:, None, None])                     # [B, N, C]
    eig_b = EigenDecomp(eig.U[:, None, None], eig.values[:, None, None],
                        eig.U_inv[:, None, None], eig.pi)
    if derivative:
        # Chain rule: transition_derivatives gives dP/d(tau) with
        # tau = bl*rate_c*clock; fold in d(tau)/d(bl).
        P = transition_derivatives(eig_b, t) * (
            category_rates * clock_rate[:, None])[:, None, :, None, None]
    else:
        P = transition_matrices(eig_b, t)
    B, _, C, A, _ = P.shape
    pad = torch.zeros((B, 1, C, A, A), device=P.device, dtype=P.dtype)
    if not derivative:
        pad = pad + torch.eye(A, device=P.device, dtype=P.dtype)
    return torch.cat([P, pad], dim=1)


def init_partials(
    tip_partials: torch.Tensor, batch_size: int, num_slots: int,
    category_count: int, pattern_pad: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The initial [B, N+1, C, A, S] buffer: tip rows one-hot (gaps all
    ones), internal and dummy rows ones; padded patterns are ones
    (weight 0).  tip_partials: [T, S0, A], SitePattern.tip_partials's
    layout."""
    T, S0, A = tip_partials.shape
    S = pattern_pad
    kw = dict(device=tip_partials.device, dtype=tip_partials.dtype)
    buf = torch.ones((batch_size, num_slots + 1, category_count, A, S), **kw)
    buf[:, :T, :, :, :S0] = tip_partials.transpose(1, 2)[None, :, None]
    logscale = torch.zeros((batch_size, num_slots + 1, S), **kw)
    return buf, logscale


def postorder_pass(
    post_ops: torch.Tensor,  # [B, M, 5] int64
    P: torch.Tensor,         # [B, N+1, C, A, A]
    partials: torch.Tensor,  # [B, N+1, C, A, S], updated in place
    logscale: torch.Tensor,  # [B, N+1, S], updated in place
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the postorder tape: the batched beagleUpdatePartials over the
    whole tree batch (reference src/fat_beagle.cpp:49-69)."""
    b = torch.arange(post_ops.shape[0], device=post_ops.device)
    for m in range(post_ops.shape[1]):
        dest, s1, e1, s2, e2 = post_ops[:, m].unbind(-1)
        prod = (_evolve(P[b, e1], partials[b, s1])
                * _evolve(P[b, e2], partials[b, s2]))     # [B, C, A, S]
        mx = prod.amax(dim=(1, 2))                        # [B, S]
        mx = torch.where(mx > 0, mx, torch.ones_like(mx))
        partials[b, dest] = prod / mx[:, None, None]
        logscale[b, dest] = logscale[b, s1] + logscale[b, s2] + torch.log(mx)
    return partials, logscale


def root_log_likelihood(
    partials: torch.Tensor, logscale: torch.Tensor, root: torch.Tensor,
    pi: torch.Tensor, category_proportions: torch.Tensor,
) -> torch.Tensor:
    """Per-(tree, pattern) log likelihood at the root (the batched
    beagleCalculateRootLogLikelihoods, reference src/fat_beagle.cpp:60-69).
    pi: [B, A]; category_proportions: [B, C]."""
    b = torch.arange(root.shape[0], device=root.device)
    site = torch.einsum("bc,ba,bcas->bs", category_proportions, pi,
                        partials[b, root])
    return torch.log(site) + logscale[b, root]


def pad_patterns(n: int, multiple: int = 128) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def log_likelihoods_impl(
    post_ops, root, tip_partials, weights, branch_lengths,
    eig: EigenDecomp, category_rates, category_proportions, clock_rate,
    *, num_slots: int, pattern_pad: int, category_count: int,
) -> torch.Tensor:
    """Per-tree log likelihoods for a batch.  Returns [B]."""
    B = branch_lengths.shape[0]
    dt = tip_partials.dtype
    P = transition_matrices_ext(eig, branch_lengths, category_rates,
                                clock_rate).to(dt)
    buf, logs = init_partials(tip_partials, B, num_slots, category_count,
                              pattern_pad)
    buf, logs = postorder_pass(post_ops, P, buf, logs)
    per_pattern = root_log_likelihood(buf, logs, root, eig.pi.to(dt),
                                      category_proportions.to(dt))
    return per_pattern @ weights


def ll_and_branch_gradients_impl(
    post_ops, pre_ops, root, edge_mask, tip_partials, weights,
    branch_lengths, eig: EigenDecomp, category_rates, category_proportions,
    clock_rate, *, num_slots: int, pattern_pad: int, category_count: int,
):
    """Log likelihood + d logL / d branch lengths.  Returns ([B], [B, N]):
    each edge's gradient is its d logL / d P (edge_adjoints, the
    reference's beagleUpdatePrePartials + beagleCalculateEdgeDerivatives,
    src/fat_beagle.cpp:113-169) contracted with its dP / dt."""
    B = branch_lengths.shape[0]
    dt = tip_partials.dtype
    P = transition_matrices_ext(eig, branch_lengths, category_rates,
                                clock_rate).to(dt)
    dP = transition_matrices_ext(eig, branch_lengths, category_rates,
                                 clock_rate, derivative=True).to(dt)
    pi, props = eig.pi.to(dt), category_proportions.to(dt)
    buf, logs = init_partials(tip_partials, B, num_slots, category_count,
                              pattern_pad)
    buf, logs = postorder_pass(post_ops, P, buf, logs)
    ll = root_log_likelihood(buf, logs, root, pi, props) @ weights
    adj, _, _ = edge_adjoints(pre_ops, P, buf, root, pi, props, weights)
    N = edge_mask.shape[1]
    return ll, (adj * dP).sum((-3, -2, -1))[:, :N] * edge_mask


def edge_adjoints(
    pre_ops: torch.Tensor,   # [B, Mp, 6] int64
    P: torch.Tensor,         # [B, N+1, C, A, A]
    partials: torch.Tensor,  # [B, N+1, C, A, S] (postorder results)
    root: torch.Tensor,      # [B]
    pi: torch.Tensor,        # [B, A]
    category_proportions: torch.Tensor,  # [B, C]
    weights: torch.Tensor,               # [S]
):
    """d logL / d P [B, N+1, C, A, A], d logL / d pi [B, A] and d logL /
    d category proportions [B, C], by one preorder: for the edge above
    node u,
      d logL / d P_u[c, a, k] = sum_s w_s prop_c o_u[c, a, s] p_u[c, k, s]
                                / den_s,
    with o_u the outside vector at the edge's parent end (rescaled per
    op, max over categories and states per pattern) and den_s the site
    likelihood up to the same per-site scale, so the rescaling of o and p
    cancels.  Rows of P that no edge uses get 0."""
    B, N1, C, A, S = partials.shape
    b = torch.arange(B, device=partials.device)
    upper = torch.zeros_like(partials)
    upper[b, root] = pi[:, None, :, None].expand(B, C, A, S)
    adj = torch.zeros_like(P)
    for m in range(pre_ops.shape[1]):
        dest, parent, s1, e1, s2, e2 = pre_ops[:, m].unbind(-1)
        o = (upper[b, parent] * _evolve(P[b, e1], partials[b, s1])
             * _evolve(P[b, e2], partials[b, s2]))
        mx = o.amax(dim=(1, 2))
        mx = torch.where(mx > 0, mx, torch.ones_like(mx))
        o = o / mx[:, None, None]
        P_dest = P[b, dest]
        p_dest = partials[b, dest]
        den = torch.einsum("bc,bcas->bs", category_proportions,
                           o * _evolve(P_dest, p_dest))
        scale = weights / torch.where(den > 0, den, torch.ones_like(den))
        adj[b, dest] = torch.einsum("bc,bcas,bcks,bs->bcak",
                                    category_proportions, o, p_dest, scale)
        upper[b, dest] = _evolve_t(P_dest, o)
    at_root = partials[b, root]
    scale = weights / torch.einsum("bc,ba,bcas->bs", category_proportions,
                                   pi, at_root)
    return (adj,
            torch.einsum("bc,bcas,bs->ba", category_proportions, at_root,
                         scale),
            torch.einsum("ba,bcas,bs->bc", pi, at_root, scale))


class _ScanLogLikelihoods(torch.autograd.Function):
    """Per-tree log likelihoods [B] from P, pi and the category
    proportions by the postorder; backward by edge_adjoints, one preorder,
    in place of autograd through the tape's in-place writes (whose
    backward materialises the whole partials buffer at every op)."""

    @staticmethod
    def forward(ctx, P, pi, props, post_ops, pre_ops, root, tip_partials,
                weights, num_slots, pattern_pad):
        buf, logs = init_partials(tip_partials, P.shape[0], num_slots,
                                  props.shape[1], pattern_pad)
        buf, logs = postorder_pass(post_ops, P, buf, logs)
        ctx.save_for_backward(P, pi, props, pre_ops, root, weights)
        ctx.partials = buf
        return root_log_likelihood(buf, logs, root, pi, props) @ weights

    @staticmethod
    def backward(ctx, grad):
        P, pi, props, pre_ops, root, weights = ctx.saved_tensors
        adj, d_pi, d_props = edge_adjoints(pre_ops, P, ctx.partials, root,
                                           pi, props, weights)
        return (grad[:, None, None, None, None] * adj, grad[:, None] * d_pi,
                grad[:, None] * d_props) + (None,) * 7


def log_likelihoods_differentiable(
    post_ops, pre_ops, root, tip_partials, weights, branch_lengths,
    eig: EigenDecomp, category_rates, category_proportions, clock_rate,
    *, num_slots: int, pattern_pad: int,
) -> torch.Tensor:
    """log_likelihoods_impl's values [B], differentiable by reverse-mode
    autodiff in every model ingredient (and the branch lengths) at the
    cost of one postorder and one preorder; the model ingredients are
    per-tree rows."""
    dt = tip_partials.dtype
    P = transition_matrices_ext(eig, branch_lengths, category_rates,
                                clock_rate).to(dt)
    return _ScanLogLikelihoods.apply(
        P, eig.pi.to(dt), category_proportions.to(dt), post_ops, pre_ops,
        root, tip_partials, weights, num_slots, pattern_pad)
