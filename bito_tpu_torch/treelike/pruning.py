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


def _preorder(pre_ops, P, partials, root, pi):
    """The preorder tape (reference beagleUpdatePrePartials,
    src/fat_beagle.cpp:113-169): for each op, yields (dest [B], o [B, C, A,
    S], P_dest [B, C, A, A]), with o the outside vector at the parent end of
    the edge above `dest`, rescaled per op (max over categories and states
    per pattern).  The up values (P^T o) are kept here; preorder_pass and
    edge_adjoints read the ops' outside vectors as they come."""
    B, N1, C, A, S = partials.shape
    b = torch.arange(B, device=partials.device)
    upper = torch.zeros_like(partials)
    upper[b, root] = pi[:, None, :, None].expand(B, C, A, S)
    for m in range(pre_ops.shape[1]):
        dest, parent, s1, e1, s2, e2 = pre_ops[:, m].unbind(-1)
        o = (upper[b, parent] * _evolve(P[b, e1], partials[b, s1])
             * _evolve(P[b, e2], partials[b, s2]))
        mx = o.amax(dim=(1, 2))
        mx = torch.where(mx > 0, mx, torch.ones_like(mx))
        o = o / mx[:, None, None]
        P_dest = P[b, dest]
        upper[b, dest] = _evolve_t(P_dest, o)
        yield dest, o, P_dest


def preorder_pass(
    pre_ops: torch.Tensor,   # [B, Mp, 6] int64
    P: torch.Tensor,         # [B, N+1, C, A, A]
    partials: torch.Tensor,  # [B, N+1, C, A, S] (postorder results)
    root: torch.Tensor,      # [B]
    pi: torch.Tensor,        # [B, A]
) -> torch.Tensor:
    """Per-node outside vectors o_u [B, N+1, C, A, S] (the root's row and
    the dummy row 0) such that for every edge (above node) u
        site_lik ~ sum_c prop_c * (o_u^c . (P_c(t_u) @ p_u^c))
    with the same per-site scale factor for every u, so derivative ratios
    are scale-free."""
    outside = torch.zeros_like(partials)
    b = torch.arange(partials.shape[0], device=partials.device)
    for dest, o, _ in _preorder(pre_ops, P, partials, root, pi):
        outside[b, dest] = o
    return outside


def branch_length_gradients(
    outside: torch.Tensor,     # [B, N+1, C, A, S]
    partials: torch.Tensor,    # [B, N+1, C, A, S]
    P: torch.Tensor,           # [B, N+1, C, A, A]
    dP: torch.Tensor,          # [B, N+1, C, A, A]
    category_proportions: torch.Tensor,  # [B, C]
    weights: torch.Tensor,     # [S] pattern weights (0 on padding)
    edge_mask: torch.Tensor,   # [B, N]
) -> torch.Tensor:
    """d log L / d branch length per (tree, node) from the outside
    vectors (the batched beagleCalculateEdgeDerivatives, reference
    src/fat_beagle.cpp:141-169): num / den with
      num[b,u,s] = sum_c prop_c o[b,u,c,:,s] . (dP[b,u,c] @ p[b,u,c,:,s]),
      den[b,u,s] = the same with P (the site likelihood up to the shared
                   scale)."""
    N = edge_mask.shape[1]
    o, p = outside[:, :N], partials[:, :N]
    evolved = P[:, :N] @ p
    devolved = dP[:, :N] @ p
    den = torch.einsum("tc,tncas->tns", category_proportions, o * evolved)
    num = torch.einsum("tc,tncas->tns", category_proportions, o * devolved)
    ratio = num / torch.where(den > 0, den, torch.ones_like(den))
    return torch.einsum("s,tns->tn", weights, ratio) * edge_mask


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
    with o_u the outside vector at the edge's parent end (_preorder) and
    den_s the site likelihood up to the same per-site scale, so the
    rescaling of o and p cancels.  Rows of P that no edge uses get 0."""
    b = torch.arange(partials.shape[0], device=partials.device)
    adj = torch.zeros_like(P)
    for dest, o, P_dest in _preorder(pre_ops, P, partials, root, pi):
        p_dest = partials[b, dest]
        den = torch.einsum("bc,bcas->bs", category_proportions,
                           o * _evolve(P_dest, p_dest))
        scale = weights / torch.where(den > 0, den, torch.ones_like(den))
        adj[b, dest] = torch.einsum("bc,bcas,bcks,bs->bcak",
                                    category_proportions, o, p_dest, scale)
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


MIN_LOG_BL = -13.9   # reference src/dag_branch_handler.hpp:272
MAX_LOG_BL = 1.1     # reference src/dag_branch_handler.hpp:275


def optimize_selected_branches_impl(
    post_ops, pre_ops, root, tip_partials, weights, branch_lengths,
    eig: EigenDecomp, category_rates, category_proportions, clock_rate,
    sel_nodes,     # [B, K] int64 node ids to optimize (pad with num_slots)
    sel_mask,      # [B, K] bool
    *, num_slots: int, pattern_pad: int, category_count: int,
    iterations: int = 2,
) -> torch.Tensor:
    """Batched exact conditional branch-length optimization of selected
    edges (the classical-engine counterpart of the reference's
    proposed-NNI new-edge optimization: TPEngine with optimize_new_edges,
    src/tp_engine.cpp:1423-1427 + Optimization::BrentMinimize).

    Given fixed other branches, LL as a function of one edge's length t
    factorizes through that node's outside vector o and partial p:
        LL(t) = sum_s w_s log( sum_c prop_c  o . (P_c(t) @ p) ) + const,
    so a vectorized Brent per (tree, selected node) lane is exact.  The
    selected edges update Jacobi-style; `iterations` rounds of
    (postorder + preorder, joint Brent) form the coordinate ascent.  Runs
    on the scan tape in the tips' dtype (the model ingredients and each
    P are float64, cast to it), as bito_tpu runs it on its scan tape.
    Returns the branch lengths [B, N]."""
    from ..gp import optimize as gp_optimize

    dt = tip_partials.dtype
    B, K = sel_nodes.shape
    b = torch.arange(B, device=sel_nodes.device)[:, None]
    pi = eig.pi.to(dt)
    # One column past the nodes, where the padded lanes (sel_nodes =
    # num_slots) read and write: bito_tpu's gather clamps them and its
    # scatter drops them, and no real lane reads that column.
    bl = torch.cat([branch_lengths,
                    branch_lengths.new_zeros((B, 1))], dim=1)
    for _ in range(iterations):
        P = transition_matrices_ext(eig, bl[:, :-1], category_rates,
                                    clock_rate).to(dt)
        buf, logs = init_partials(tip_partials, B, num_slots,
                                  category_count, pattern_pad)
        buf, logs = postorder_pass(post_ops, P, buf, logs)
        outside = preorder_pass(pre_ops, P, buf, root, pi)
        o = outside[b, sel_nodes]           # [B, K, C, A, S]
        p = buf[b, sel_nodes]

        def neg_ll(y):                      # y: [B, K] log branch length
            tau = ((torch.exp(y) * clock_rate[:, None])[:, :, None]
                   * category_rates[:, None, :])               # [B, K, C]
            e = torch.exp(eig.values[:, None, None, :]
                          * tau[..., None])                    # [B, K, C, A]
            Pk = torch.einsum("bia,bkca,baj->bkcij", eig.U, e,
                              eig.U_inv).to(dt)
            val = torch.einsum("bc,bkcas->bks", category_proportions.to(dt),
                               o * (Pk @ p))
            tiny = torch.full_like(val, 1e-300)
            return -(torch.log(torch.where(val > 0, val, tiny)) @ weights)

        lo = torch.full((B, K), MIN_LOG_BL, dtype=dt, device=bl.device)
        hi = torch.full((B, K), MAX_LOG_BL, dtype=dt, device=bl.device)
        old = bl[b, sel_nodes]
        guess = torch.log(old.clamp(min=1e-300)).clamp(MIN_LOG_BL,
                                                       MAX_LOG_BL)
        y_opt = gp_optimize.brent_minimize_batched(neg_ll, guess, lo, hi)
        # Reset-if-worse guard (reference dag_branch_handler.cpp:143-150).
        y_opt = torch.where(neg_ll(y_opt) > neg_ll(guess), guess, y_opt)
        bl = bl.clone()
        bl[b, sel_nodes] = torch.where(sel_mask, torch.exp(y_opt), old)
    return bl[:, :-1]
