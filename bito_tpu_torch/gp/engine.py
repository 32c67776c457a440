"""GP engine: generalized pruning on the subsplit DAG as levelized
wavefronts of torch operations.

Counterpart of bito_tpu.gp.engine (a rebuild of the reference GPEngine,
src/gp_engine.cpp:213-816, src/gp_engine.hpp:287-377).  The per-node PLV
store is one device tensor
  plv[6, N+1, 4, S]   (P, PHatRight, PHatLeft, RHat, RRight, RLeft)
with per-(PLV, site) log rescaling offsets
  ls[6, N+1, S],
slot N (the node capacity) being the dummy slot that padded entries read
and write.  The serial GPOperation tape (src/gp_dag.cpp:260-304) becomes
one batched gather -> q-weighted 4x4 matvec -> scatter-add per DAG level,
and branch-length optimization runs whole levels of independent line
searches at once.  The substitution model is JC69 with four states, as the
reference engine's (src/gp_engine.hpp:362-377).

No part of it is a hand-written kernel: bito_tpu's programs here are XLA
scans and loops (no Pallas kernel), and each of them becomes the same
torch operations, run level by level from Python:
  - bito_tpu's `lax.scan` over the levels is a Python loop over the DAG's
    real levels; the capacity-padded rows of the index tensors are kept
    (padded entries carry q = 0 and land in the dummy slot), the padded
    levels are not run, since they touch the dummy slot only;
  - `.at[key].max` and `.at[key].add` are `scatter_reduce(reduce="amax")`
    over a -inf start and `index_add_`;
  - `.at[...].set(mode="drop")` is a write of the in-range rows only;
  - `EstimateBranchLengths`' `while_loop` is a host loop that reads the
    mean |delta bl| back once a sweep;
  - einsums and products run in full float32 (or float64) precision, as
    bito_tpu asks XLA for Precision.HIGHEST: a float32 engine on the card
    raises while `torch.backends.cuda.matmul.allow_tf32` is True.
Every entry point runs on the engine's device in its dtype; a CUDA device
without a card raises (device.resolve).

shard_patterns(group) splits the site patterns over the ranks of a
torch.distributed process group, as bito_tpu's shards them over a device
mesh: each rank keeps its slice of the tips and weights, and every sum
over patterns (the per-edge and marginal likelihoods, every line
search's objective and derivatives, the quartet totals) is all-reduced
over the group through the programs' `reduce` argument, so every rank
takes the same line searches and holds the same branch lengths.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.site_pattern import SitePattern
from ..dag.schedule import (
    P,
    PHAT_LEFT,
    PHAT_RIGHT,
    RHAT,
    RLEFT,
    RRIGHT,
    build_schedule,
)
from ..dag.subsplit_dag import LEFT, RIGHT, SubsplitDAG
from ..device import PRODUCT_DEVICE, PRODUCT_DTYPE, resolve
from ..dist.mesh import PatternSharded, unsharded
from . import optimize

MIN_LOG_BL = -13.9       # reference src/dag_branch_handler.hpp:272
MAX_LOG_BL = 1.1         # reference src/dag_branch_handler.hpp:275
DEFAULT_BL = 0.1         # reference src/dag_branch_handler.hpp:266
METHODS = ("brent", "brent_with_gradients", "gradient_ascent",
           "log_space_gradient_ascent", "newton")


def jc69_transition(t: torch.Tensor) -> torch.Tensor:
    """JC69 P(t): 0.25(1-e) off-diagonal + e on the diagonal with
    e = exp(-4t/3) (reference src/gp_engine.cpp:341-350 via eigendecomp).
    Symmetric, so it serves both rootward and leafward evolution."""
    e = torch.exp(-4.0 * t / 3.0)
    eye = torch.eye(4, dtype=t.dtype, device=t.device)
    return 0.25 * (1.0 - e)[..., None, None] + e[..., None, None] * eye


def _pad_stack(arrays: List[np.ndarray], pad_value: int,
               dtype=np.int32, width: int | None = None,
               rows: int | None = None) -> np.ndarray:
    """Stack variable-length 1-D index arrays into [L, W] with padding:
    padding rows index dummy slots (node cap / edge cap).  `width`/`rows`
    pad to capacity buckets, as bito_tpu does."""
    W = width if width is not None else max([len(a) for a in arrays] + [1])
    L = rows if rows is not None else len(arrays)
    out = np.full((L, W), pad_value, dtype=dtype)
    for i, a in enumerate(arrays):
        out[i, : len(a)] = a
    return out


def _edge_values(r: torch.Tensor, trans: torch.Tensor,
                 p: torch.Tensor) -> torch.Tensor:
    """sum_ab r[k,a,s] trans[k,a,b] p[k,b,s] -> [k, s]: bito_tpu's einsum
    "kas,kab,kbs->ks", summed over a first and then over b, the order in
    which XLA sums it (so that the float64 values agree to the bit)."""
    return ((r[:, :, None, :] * trans[:, :, :, None]).sum(1) * p).sum(1)


def _log_positive(val: torch.Tensor) -> torch.Tensor:
    """log(val) where val > 0, else log(1e-300) in val's dtype (-inf in
    float32, where 1e-300 rounds to 0), as bito_tpu's
    log(where(val > 0, val, 1e-300))."""
    return torch.log(torch.where(val > 0, val,
                                 torch.full_like(val, 1e-300)))


# ---------------------------------------------------------------------------
# Wavefront programs
# ---------------------------------------------------------------------------

def _accumulate(plv, ls, edge, dest, src, src_plv, trans_all, q_ext,
                dest_plv):
    """Scatter-accumulate q-weighted evolved PLVs into fresh dest slots,
    aligning per-site scales to the per-dest max.  Padding entries carry
    q_ext[ecap] == 0 and dest == ncap, so they contribute zero and land in
    the dummy slot.  Every key that receives an entry has a finite max, so
    exp(src_ls - ls_max[key]) never meets -inf - (-inf)."""
    np1 = plv.shape[1]
    S = plv.shape[-1]
    src_vals = plv[src_plv, src]          # [K, 4, S]
    src_ls = ls[src_plv, src]             # [K, S]
    key = dest_plv * np1 + dest           # [K] flat (plv_type, node)
    ls_max = torch.full((6 * np1, S), -torch.inf, dtype=ls.dtype,
                        device=ls.device).scatter_reduce(
        0, key[:, None].expand(-1, S), src_ls, reduce="amax")
    factor = torch.exp(src_ls - ls_max[key])
    contrib = (
        q_ext[edge][:, None, None]
        * torch.einsum("kab,kbs->kas", trans_all[edge], src_vals)
        * factor[:, None, :]
    )
    acc = torch.zeros((6 * np1, 4, S), dtype=plv.dtype,
                      device=plv.device).index_add_(0, key, contrib)
    acc_ls = torch.where(torch.isfinite(ls_max), ls_max,
                         torch.zeros_like(ls_max))
    return acc.reshape(6, np1, 4, S), acc_ls.reshape(6, np1, S)


def _write_levels(plv, ls, acc, acc_ls, plv_types, nodes):
    for ptype in plv_types:
        plv[ptype, nodes] = acc[ptype, nodes]
        ls[ptype, nodes] = acc_ls[ptype, nodes]


def _multiply_rescale(plv, ls, dest, src1, src2, nodes):
    prod = plv[src1, nodes] * plv[src2, nodes]
    lsn = ls[src1, nodes] + ls[src2, nodes]
    m = prod.amax(dim=1)                  # [M, S]
    m_safe = torch.where(m > 0, m, torch.ones_like(m))
    plv[dest, nodes] = prod / m_safe[:, None, :]
    ls[dest, nodes] = lsn + torch.log(m_safe)


def _ext(blc, qc):
    bl_ext = torch.cat([blc, torch.full((1,), DEFAULT_BL, dtype=blc.dtype,
                                        device=blc.device)])
    q_ext = torch.cat([qc, torch.zeros((1,), dtype=qc.dtype,
                                       device=qc.device)])
    return bl_ext, q_ext


def _seed_rhat(plv, ls, q_ext, rootsplit_nodes, rootsplit_edges):
    # Seed rootsplits' RHat with q * stationary (reference
    # SetToStationaryDistribution, src/gp_engine.cpp:218).  Padded
    # rootsplit entries carry edge ecap (q 0) and node ncap (dummy slot).
    S = plv.shape[-1]
    plv[RHAT, rootsplit_nodes] = (q_ext[rootsplit_edges] * 0.25)[
        :, None, None].expand(-1, 4, S)
    ls[RHAT, rootsplit_nodes] = 0.0


def _level(entries: dict, i: int) -> dict:
    return {k: v[i] for k, v in entries.items()}


def _populate_impl(idx, blc, qc, tips, np1, n_taxa):
    bl_ext, q_ext = _ext(blc, qc)
    trans = jc69_transition(bl_ext)       # [ecap+1, 4, 4]
    S = tips.shape[-1]
    kw = dict(dtype=blc.dtype, device=blc.device)
    plv = torch.zeros((6, np1, 4, S), **kw)
    ls = torch.zeros((6, np1, S), **kw)
    plv[P, :n_taxa] = tips
    for i in range(idx["n_rw"]):
        lvl = _level(idx["rw"], i)
        dest_plv = torch.where(lvl["side"] != 0,
                               torch.full_like(lvl["side"], PHAT_LEFT),
                               torch.full_like(lvl["side"], PHAT_RIGHT))
        acc, acc_ls = _accumulate(plv, ls, lvl["edge"], lvl["dest"],
                                  lvl["src"], lvl["src_plv"], trans, q_ext,
                                  dest_plv)
        _write_levels(plv, ls, acc, acc_ls, (PHAT_RIGHT, PHAT_LEFT),
                      lvl["nodes"])
        _multiply_rescale(plv, ls, P, PHAT_LEFT, PHAT_RIGHT, lvl["nodes"])
    _seed_rhat(plv, ls, q_ext, idx["rootsplit_nodes"],
               idx["rootsplit_edges"])
    for i in range(idx["n_lw"]):
        lvl = _level(idx["lw"], i)
        dest_plv = torch.full_like(lvl["edge"], RHAT)
        acc, acc_ls = _accumulate(plv, ls, lvl["edge"], lvl["dest"],
                                  lvl["src"], lvl["src_plv"], trans, q_ext,
                                  dest_plv)
        _write_levels(plv, ls, acc, acc_ls, (RHAT,), lvl["acc_nodes"])
        _multiply_rescale(plv, ls, RRIGHT, RHAT, PHAT_LEFT, lvl["nodes"])
        _multiply_rescale(plv, ls, RLEFT, RHAT, PHAT_RIGHT, lvl["nodes"])
    return plv, ls


def _likelihoods_impl(idx, plv, ls, blc, qc, weights, reduce=unsharded):
    """Per-edge log likelihoods + per-site log marginal + total marginal
    (reference GPDAG::ComputeLikelihoods + IncrementMarginalLikelihood).
    Outputs are capacity-sized; padded edge rows are masked to zero and
    padded rootsplit rows are not written.  `reduce` makes the per-edge
    and total sums over this rank's patterns the whole alignment's (one
    all_reduce); the per-site log marginal stays this rank's."""
    _, q_ext = _ext(blc, qc)
    trans = jc69_transition(blc)
    r = plv[idx["like_r_plv"], idx["like_parent"]]      # [ecap, 4, S]
    lsr = ls[idx["like_r_plv"], idx["like_parent"]]
    p = plv[P, idx["like_child"]]
    lsp = ls[P, idx["like_child"]]
    val = _edge_values(r, trans, p)
    rows = _log_positive(val) + lsr + lsp
    per_edge = rows @ weights
    rootsplit_nodes = idx["rootsplit_nodes"]
    rootsplit_edges = idx["rootsplit_edges"]
    r0 = plv[RHAT, rootsplit_nodes]
    p0 = plv[P, rootsplit_nodes]
    lsp0 = ls[P, rootsplit_nodes]
    val0 = torch.einsum("eas,eas->es", r0, p0)
    rows0 = _log_positive(val0) + lsp0
    # Padded rootsplit rows gather the all-zero dummy slot -> rows0 ~ -690
    # (-inf in float32); their exp underflows to 0 in the logsumexp,
    # leaving the marginal exact.
    log_marginal_site = torch.logsumexp(rows0, dim=0)
    per_edge_root = (
        rows0 @ weights
        - torch.log(q_ext[rootsplit_edges]) * torch.sum(weights)
    )
    per_edge = torch.where(idx["like_mask"], per_edge,
                           torch.zeros_like(per_edge))
    # bito_tpu's .at[rootsplit_edges].set(..., mode="drop"): padded
    # rootsplit rows carry edge ecap, past the end, and are not written.
    real = rootsplit_edges < per_edge.shape[0]
    per_edge[rootsplit_edges[real]] = per_edge_root[real]
    sums = reduce(torch.cat([per_edge, (log_marginal_site @ weights)[None]]))
    return sums[:-1], log_marginal_site, sums[-1]


def _estimate_impl(idx, blc, qc, tips, weights, tol, edge_mask, np1,
                   n_taxa, method, max_iter, reduce=unsharded):
    """EstimateBranchLengths' coordinate ascent: populate, then while
    (it < max_iter and mean |dbl| over real edges >= tol) { sweep;
    populate }, the mean read back to the host once a sweep.  Returns
    (plv, ls, blc, |dbl| per edge (capacity-sized), iters)."""
    plv, ls = _populate_impl(idx, blc, qc, tips, np1, n_taxa)
    denom = torch.clamp(edge_mask.sum(), min=1.0)
    diffs = torch.zeros_like(blc)
    it = 0
    while it < max_iter:
        old = blc
        plv, ls, blc = _sweep_impl(idx, plv, ls, blc, qc, weights, method,
                                   reduce)
        plv, ls = _populate_impl(idx, blc, qc, tips, np1, n_taxa)
        diffs = torch.abs(blc - old) * edge_mask
        it += 1
        if float(diffs.sum() / denom) < tol:
            break
    return plv, ls, blc, diffs, it


def _per_lane_grad(f, x):
    return torch.func.jvp(f, (x,), (torch.ones_like(x),))[1]


def _ll_and_tangent(r, p, w, t, dt):
    """The per-edge log likelihood at branch lengths t, and its derivative
    along the tangent dt, with the operations of bito_tpu's jax.jvp of it,
    in their order: JC69's P(t) and its tangent, the edge values, the log
    of the positive ones (log(1e-300) elsewhere, with tangent 0)."""
    a, da = -4.0 * t / 3.0, -4.0 * dt / 3.0
    e = torch.exp(a)
    de = e * da
    eye = torch.eye(4, dtype=t.dtype, device=t.device)
    trans = 0.25 * (1.0 - e)[..., None, None] + e[..., None, None] * eye
    dtrans = (0.25 * -de)[..., None, None] + de[..., None, None] * eye
    val, dval = _edge_values(r, trans, p), _edge_values(r, dtrans, p)
    pos = val > 0
    v = torch.where(pos, val, torch.full_like(val, 1e-300))
    dv = torch.where(pos, dval, torch.zeros_like(dval))
    return torch.log(v) @ w, (dv / v) @ w


def _optimize_side(plv, bl_ext, edges, parents, children, r_plv, w, method,
                   reduce=unsharded):
    """Batched per-edge 1-D optimization over one side's edges
    (reference DAGBranchHandler::OptimizeBranchLength,
    src/dag_branch_handler.cpp:123-285); padding rows optimize a flat
    objective and write the dummy bl slot.  Returns the new bl_ext.
    First derivatives are the closed forms of _ll_and_tangent; Newton's
    second derivative is one jvp of that first derivative (torch.func),
    taken on this rank's sum, which is linear in it, before `reduce`
    (one all_reduce an evaluation, of every quantity it returns)."""
    dtype = bl_ext.dtype
    r = plv[r_plv, parents]               # [K, 4, S]
    p = plv[P, children]

    def ll_of_t(t):
        return reduce(_log_positive(_edge_values(r, jc69_transition(t), p))
                      @ w)

    def ll_y(y):
        return ll_of_t(torch.exp(y))

    def local_ll_prime_y(y):  # d ll(exp(y)) / dy = ll'(x) x, this rank's
        x = torch.exp(y)
        return _ll_and_tangent(r, p, w, x, x * 1.0)[1]

    def ll_prime_y(y):
        return reduce(local_ll_prime_y(y))

    def ffp(x):  # (ll, d ll / d x)
        both = reduce(torch.stack(_ll_and_tangent(r, p, w, x,
                                                  torch.ones_like(x))))
        return both[0], both[1]

    guess_x = bl_ext[edges]
    lo = torch.full(edges.shape, MIN_LOG_BL, dtype=dtype, device=r.device)
    hi = torch.full(edges.shape, MAX_LOG_BL, dtype=dtype, device=r.device)

    if method in ("brent", "brent_with_gradients"):
        y0 = torch.log(guess_x)

        def neg_ll(y):
            return -ll_y(y)

        def neg_ll_prime(y):  # the jvp of neg_ll with a ones tangent
            return -ll_prime_y(y)

        y_opt = optimize.brent_minimize_batched(
            neg_ll, y0, lo, hi, iterations=60,
            use_gradients=(method == "brent_with_gradients"),
            fprime=neg_ll_prime)
        # Reset-if-worse guard (dag_branch_handler.cpp:143-150).
        worse = neg_ll(y_opt) > neg_ll(y0)
        x_new = torch.where(worse, guess_x, torch.exp(y_opt))
    elif method == "gradient_ascent":
        # The reference floors x at min_log_branch_length_ itself
        # (dag_branch_handler.cpp:225-228) — replicated as-is.
        x_new = optimize.gradient_ascent_batched(
            ffp, guess_x, torch.full_like(guess_x, MIN_LOG_BL))
    elif method == "log_space_gradient_ascent":
        x_new = optimize.log_space_gradient_ascent_batched(
            ffp, guess_x,
            torch.full_like(guess_x, float(np.exp(MIN_LOG_BL))))
    elif method == "newton":
        def f3(y):
            x = torch.exp(y)
            local = torch.stack([
                _log_positive(_edge_values(r, jc69_transition(x), p)) @ w,
                local_ll_prime_y(y), _per_lane_grad(local_ll_prime_y, y)])
            both = reduce(local)
            return both[0], both[1], both[2]

        y_opt = optimize.newton_raphson_batched(
            f3, torch.log(guess_x), lo, hi)
        x_new = torch.exp(y_opt)
    else:
        raise ValueError(f"Unknown optimization method: {method!r}")
    bl_ext = bl_ext.clone()
    bl_ext[edges] = x_new
    return bl_ext


def _rebuild_phat(plv, ls, bl_ext, q_ext, edge, dest, src, ptype, nodes):
    trans = jc69_transition(bl_ext)
    acc, acc_ls = _accumulate(plv, ls, edge, dest, src,
                              torch.full_like(edge, P), trans, q_ext,
                              torch.full_like(edge, ptype))
    _write_levels(plv, ls, acc, acc_ls, (ptype,), nodes)


def _sweep_impl(idx, plv, ls, blc, qc, weights, method, reduce=unsharded):
    """One leafward optimization sweep (the tidy traversal, levelized);
    see GPEngine.optimize_branch_lengths_once.  Works on copies of plv and
    ls, which it returns with the new branch lengths.  `reduce`: as in
    _optimize_side."""
    plv, ls = plv.clone(), ls.clone()
    bl_ext, q_ext = _ext(blc, qc)
    _seed_rhat(plv, ls, q_ext, idx["rootsplit_nodes"],
               idx["rootsplit_edges"])
    for i in range(idx["n_lw"]):
        lvl = _level(idx["sweep"], i)
        trans = jc69_transition(bl_ext)
        dest_plv = torch.full_like(lvl["edge"], RHAT)
        acc, acc_ls = _accumulate(plv, ls, lvl["edge"], lvl["dest"],
                                  lvl["src"], lvl["src_plv"], trans, q_ext,
                                  dest_plv)
        _write_levels(plv, ls, acc, acc_ls, (RHAT,), lvl["acc_nodes"])
        # Right side: RRight = RHat o PHatLeft, optimize, rebuild.
        _multiply_rescale(plv, ls, RRIGHT, RHAT, PHAT_LEFT, lvl["nodes"])
        bl_ext = _optimize_side(plv, bl_ext, lvl["r_edge"], lvl["r_parent"],
                                lvl["r_child"], RRIGHT, weights, method,
                                reduce)
        _rebuild_phat(plv, ls, bl_ext, q_ext, lvl["reb_r_edge"],
                      lvl["reb_r_dest"], lvl["reb_r_src"], PHAT_RIGHT,
                      lvl["internal"])
        # Left side.
        _multiply_rescale(plv, ls, RLEFT, RHAT, PHAT_RIGHT, lvl["nodes"])
        bl_ext = _optimize_side(plv, bl_ext, lvl["l_edge"], lvl["l_parent"],
                                lvl["l_child"], RLEFT, weights, method,
                                reduce)
        _rebuild_phat(plv, ls, bl_ext, q_ext, lvl["reb_l_edge"],
                      lvl["reb_l_dest"], lvl["reb_l_src"], PHAT_LEFT,
                      lvl["internal"])
        _multiply_rescale(plv, ls, P, PHAT_LEFT, PHAT_RIGHT, lvl["internal"])
    return plv, ls, bl_ext[:-1]


class GPEngine(PatternSharded):
    def __init__(self, site_pattern: SitePattern, dag: SubsplitDAG,
                 optimization_method: str = "brent",
                 caps: Optional[Dict[str, int]] = None,
                 headroom: int = 1, *, device=PRODUCT_DEVICE,
                 dtype=PRODUCT_DTYPE):
        """`caps` optionally shares a capacity-bucket dict with other
        engines (e.g. an NNI loop's per-iteration grafted scorers): buckets
        only grow, so engines sharing the dict keep one set of index-tensor
        shapes.  `headroom` > 1 makes every cap ratchet jump that factor
        past the current need.  The engine's tensors live on `device` in
        `dtype` (the card in float32 by default)."""
        self.device, self.dtype = resolve(device, dtype)
        self._check_precision()
        self.site_pattern = site_pattern
        self.dag = dag
        self._headroom = headroom
        self.optimization_method = optimization_method
        self.schedule = build_schedule(dag)
        S0 = site_pattern.pattern_count
        self.S = S0  # patterns kept unpadded
        tips = site_pattern.tip_partials().astype(np.float64)  # [n, S, 4]
        self.tips = self._tensor(np.swapaxes(tips, 1, 2))
        self.weights = self._tensor(site_pattern.weights)
        # Priors (reference GPInstance::MakeGPEngine, src/gp_instance.cpp:146)
        self.sbn_prior = dag.build_uniform_on_topological_support_prior()
        node_probs = dag.unconditional_node_probabilities(self.sbn_prior)
        self.unconditional_node_probabilities = node_probs[
            : dag.node_count_without_dag_root()
        ]
        self.inverted_sbn_prior = dag.inverted_gpcsp_probabilities(
            self.sbn_prior, node_probs
        )
        # Mutable engine state.  Branch lengths and q live at CAPACITY
        # size (padded to the bucket); the public `branch_lengths` / `q`
        # properties expose true-size views.
        self._caps: Dict[str, int] = caps if caps is not None else {}
        self._prepare_index_arrays(headroom=self._headroom)
        E = self.schedule.edge_count
        ecap = self._caps["e"]
        qc0 = np.zeros(ecap)
        qc0[:E] = np.asarray(self.sbn_prior)
        self._qc = self._tensor(qc0)
        self._blc = self._tensor(np.full(ecap, DEFAULT_BL))
        self.branch_length_differences = np.zeros(E)
        self.plv: Optional[torch.Tensor] = None
        self.ls: Optional[torch.Tensor] = None
        self.per_edge_ll: Optional[torch.Tensor] = None
        self.log_marginal_site: Optional[torch.Tensor] = None
        self._log_marginal = None
        self.hybrid_marginal_log_likelihoods = np.full(E, -np.inf)

    def _tensor(self, value) -> torch.Tensor:
        return torch.as_tensor(np.asarray(value), dtype=self.dtype,
                               device=self.device)

    def _check_precision(self):
        """Raises for float32 on the card while TF32 matmuls are allowed:
        the engine's einsums and matvecs must keep float32's 24-bit
        products.  Checked at every entry point that runs a program, since
        the flag is global and may change after construction."""
        if (self.device.type == "cuda" and self.dtype == torch.float32
                and torch.backends.cuda.matmul.allow_tf32):
            raise RuntimeError(
                "the GP engine needs full float32 matmuls on the card: set "
                "torch.backends.cuda.matmul.allow_tf32 = False")

    def _host(self, value) -> np.ndarray:
        return value.detach().cpu().numpy() if torch.is_tensor(value) else (
            np.asarray(value))

    # ------------------------------------------------------------------
    # capacity-sized state views
    # ------------------------------------------------------------------
    @property
    def branch_lengths(self):
        return self._blc[: self.schedule.edge_count]

    @branch_lengths.setter
    def branch_lengths(self, value):
        value = torch.as_tensor(value, dtype=self.dtype, device=self.device)
        if value.shape[0] == self._blc.shape[0]:
            self._blc = value.clone()
        else:
            blc = self._blc.clone()
            blc[: value.shape[0]] = value
            self._blc = blc

    @property
    def q(self):
        return self._qc[: self.schedule.edge_count]

    @q.setter
    def q(self, value):
        value = torch.as_tensor(value, dtype=self.dtype, device=self.device)
        if value.shape[0] == self._qc.shape[0]:
            self._qc = value.clone()
        else:
            qc = self._qc.clone()
            qc[: value.shape[0]] = value
            self._qc = qc

    # ------------------------------------------------------------------
    # index-tensor preparation (host work, as bito_tpu's)
    # ------------------------------------------------------------------
    def _prepare_index_arrays(self, headroom: int = 1):
        sch = self.schedule
        caps = self._caps
        N, E, R = sch.node_count, sch.edge_count, len(sch.rootsplit_nodes)

        def bucket(value, m):
            """Geometric capacity buckets (m, 2m, 4m, ...)."""
            b = m
            while b < value:
                b *= 2
            return b

        def need(key, value, m):
            cur = caps.get(key, 0)
            if bucket(value, m) <= cur:
                return
            # A key that ratchets during growth jumps to headroom x the
            # need (the reference's 2x spare-allocation on GrowPLVs,
            # src/gp_engine.cpp:64-209); static engines (headroom=1) keep
            # exact buckets.
            caps[key] = bucket(value * headroom, m)

        need("n", N, 32)
        need("e", E, 64)
        need("r", R, 8)
        need("Lr", len(sch.rootward), 2)
        need("Ll", len(sch.leafward), 2)
        need("Kr", max((len(l.edge) for l in sch.rootward), default=1), 16)
        need("Kl", max((len(l.edge) for l in sch.leafward), default=1), 16)
        need("Mr", max((len(l.nodes) for l in sch.rootward), default=1), 16)
        need("Ml", max((len(l.nodes) for l in sch.leafward), default=1), 16)
        ncap, ecap = caps["n"], caps["e"]

        def stack_entries(levels, L, K, M):
            return dict(
                edge=_pad_stack([l.edge for l in levels], ecap,
                                width=K, rows=L),
                dest=_pad_stack([l.dest for l in levels], ncap,
                                width=K, rows=L),
                side=_pad_stack(
                    [l.dest_side.astype(np.int32) for l in levels], 0,
                    width=K, rows=L),
                src=_pad_stack([l.src for l in levels], ncap,
                               width=K, rows=L),
                src_plv=_pad_stack(
                    [l.src_plv for l in levels], 0, width=K, rows=L),
                nodes=_pad_stack([l.nodes for l in levels],
                                 ncap, width=M, rows=L),
            )

        rw = (stack_entries(sch.rootward, caps["Lr"], caps["Kr"], caps["Mr"])
              if sch.rootward else {})
        lw = stack_entries(sch.leafward, caps["Ll"], caps["Kl"], caps["Ml"])
        # Leafward level 0 (the rootsplits) receives no accumulation: its
        # RHat is seeded from the stationary distribution, so its acc write
        # targets only the dummy node.
        lw["acc_nodes"] = _pad_stack(
            [np.zeros(0, dtype=np.int32)]
            + [l.nodes for l in sch.leafward[1:]], ncap,
            width=caps["Ml"], rows=caps["Ll"],
        )

        # -- optimization sweep columns (tidy traversal, levelized) -------
        opt_cols: Dict[str, List[np.ndarray]] = {
            k: [] for k in ("r_edge", "r_parent", "r_child",
                            "l_edge", "l_parent", "l_child",
                            "internal",
                            "reb_r_edge", "reb_r_dest", "reb_r_src",
                            "reb_l_edge", "reb_l_dest", "reb_l_src")
        }
        for lvl in sch.leafward:
            internal = np.asarray(
                [u for u in lvl.nodes.tolist() if u >= sch.taxon_count],
                dtype=np.int32,
            )
            opt_cols["internal"].append(internal)
            for side, tag in ((RIGHT, "r"), (LEFT, "l")):
                edges, parents, children = [], [], []
                for u in lvl.nodes.tolist():
                    for c, e in self.dag.leafward[u][side]:
                        edges.append(e)
                        parents.append(u)
                        children.append(c)
                opt_cols[f"{tag}_edge"].append(
                    np.asarray(edges, dtype=np.int32))
                opt_cols[f"{tag}_parent"].append(
                    np.asarray(parents, dtype=np.int32))
                opt_cols[f"{tag}_child"].append(
                    np.asarray(children, dtype=np.int32))
                re_e, re_d, re_s = [], [], []
                for u in internal.tolist():
                    for c, e in self.dag.leafward[u][side]:
                        re_e.append(e)
                        re_d.append(u)
                        re_s.append(c)
                opt_cols[f"reb_{tag}_edge"].append(
                    np.asarray(re_e, dtype=np.int32))
                opt_cols[f"reb_{tag}_dest"].append(
                    np.asarray(re_d, dtype=np.int32))
                opt_cols[f"reb_{tag}_src"].append(
                    np.asarray(re_s, dtype=np.int32))
        pad_of = {"edge": ecap, "parent": ncap, "child": ncap,
                  "dest": ncap, "src": ncap, "internal": ncap}
        sweep = dict(lw)
        for k, cols in opt_cols.items():
            kind = k.split("_")[-1]
            ck = f"Ko_{k}"
            need(ck, max((len(c) for c in cols), default=1), 16)
            sweep[k] = _pad_stack(
                cols, pad_of[kind], width=caps[ck], rows=caps["Ll"])

        rs_nodes = _pad_stack([sch.rootsplit_nodes], ncap,
                              width=caps["r"])[0]
        rs_edges = _pad_stack([sch.rootsplit_edges], ecap,
                              width=caps["r"])[0]
        like_parent = np.full(ecap, ncap, dtype=np.int32)
        like_parent[:E] = sch.like_parent
        like_r_plv = np.zeros(ecap, dtype=np.int32)
        like_r_plv[:E] = sch.like_r_plv
        like_child = np.full(ecap, ncap, dtype=np.int32)
        like_child[:E] = sch.like_child
        like_mask = np.zeros(ecap, dtype=bool)
        like_mask[:E] = sch.like_mask

        def dev(x):
            if isinstance(x, dict):
                return {k: dev(v) for k, v in x.items()}
            kind = torch.bool if x.dtype == bool else torch.long
            return torch.as_tensor(x, dtype=kind, device=self.device)

        self._idx = dev(dict(
            rw=rw, lw=lw, sweep=sweep,
            rootsplit_nodes=rs_nodes,
            rootsplit_edges=rs_edges,
            like_parent=like_parent,
            like_r_plv=like_r_plv,
            like_child=like_child,
            like_mask=like_mask,
        ))
        # The wavefront loops run the real levels; the padded ones touch
        # the dummy slot only.
        self._idx["n_rw"] = len(sch.rootward)
        self._idx["n_lw"] = len(sch.leafward)
        self._np1 = ncap + 1

    # ------------------------------------------------------------------
    # incremental growth (reference GPEngine::GrowPLVs / GrowGPCSPs with
    # reindexing, src/gp_engine.cpp:64-209): branch lengths carry over by
    # PCSP and PLVs by subsplit; the index tensors are rebuilt.
    # ------------------------------------------------------------------
    def grow(self, new_dag: SubsplitDAG, mods=None):
        """Grow the engine onto `new_dag`.  Pass the ModificationResult as
        `mods` when `new_dag` is the SAME object mutated in place
        (dag.add_node_pair); otherwise carry maps come from the old DAG's
        subsplit/PCSP indexers."""
        old_dag = self.dag
        if mods is None:
            assert new_dag is not old_dag, (
                "in-place DAG mutation: pass the ModificationResult so the "
                "engine can reindex (the old id maps are gone)")
            old_node_of = old_dag.subsplit_to_id
            old_edge_of = old_dag.build_edge_indexer()
        old_blc = self._blc
        old_plv, old_ls = self.plv, self.ls
        old_np1 = self._np1

        self.dag = new_dag
        self.schedule = build_schedule(new_dag)
        E = self.schedule.edge_count
        self.sbn_prior = new_dag.build_uniform_on_topological_support_prior()
        node_probs = new_dag.unconditional_node_probabilities(self.sbn_prior)
        self.unconditional_node_probabilities = node_probs[
            : new_dag.node_count_without_dag_root()
        ]
        self.inverted_sbn_prior = new_dag.inverted_gpcsp_probabilities(
            self.sbn_prior, node_probs
        )
        self._prepare_index_arrays(headroom=max(self._headroom, 2))
        ecap = self._caps["e"]
        # Branch lengths carry over by PCSP; q restarts from the new prior
        # (the reference re-derives the prior on growth too).
        bl = np.full(ecap, DEFAULT_BL)
        old_bl_host = self._host(old_blc)
        if mods is not None:
            bl[mods.edge_reindexer] = old_bl_host[
                : len(mods.edge_reindexer)]
        else:
            new_edge_of = new_dag.build_edge_indexer()
            for pcsp, e_new in new_edge_of.items():
                e_old = old_edge_of.get(pcsp)
                if e_old is not None:
                    bl[e_new] = old_bl_host[e_old]
        self._blc = self._tensor(bl)
        qc0 = np.zeros(ecap)
        qc0[:E] = np.asarray(self.sbn_prior)
        self._qc = self._tensor(qc0)
        self.branch_length_differences = np.zeros(E)
        self.hybrid_marginal_log_likelihoods = np.full(E, -np.inf)
        # PLV carry-over by subsplit identity: surviving nodes keep their
        # values bit-for-bit (new/changed nodes start zeroed and are filled
        # by the next populate).
        if old_plv is not None:
            if mods is not None:
                old_ids_np = np.arange(len(mods.node_reindexer),
                                       dtype=np.int64)
                new_ids_np = np.asarray(mods.node_reindexer, dtype=np.int64)
                keep = old_ids_np < old_np1 - 1
                old_ids_np, new_ids_np = old_ids_np[keep], new_ids_np[keep]
            else:
                new_ids_np, old_ids_np = [], []
                for new_id, ss in enumerate(new_dag.nodes):
                    old_id = old_node_of.get(ss.to_string())
                    if old_id is not None and old_id < old_np1 - 1:
                        new_ids_np.append(new_id)
                        old_ids_np.append(old_id)
            new_ids = torch.as_tensor(np.asarray(new_ids_np, dtype=np.int64),
                                      device=self.device)
            old_ids = torch.as_tensor(np.asarray(old_ids_np, dtype=np.int64),
                                      device=self.device)
            S = old_plv.shape[-1]
            kw = dict(dtype=self.dtype, device=self.device)
            self.plv = torch.zeros((6, self._np1, 4, S), **kw)
            self.ls = torch.zeros((6, self._np1, S), **kw)
            self.plv[:, new_ids] = old_plv[:, old_ids]
            self.ls[:, new_ids] = old_ls[:, old_ids]
        self.per_edge_ll = None
        self.log_marginal_site = None
        self._log_marginal = None

    # ------------------------------------------------------------------
    # public API (mirroring reference GPEngine / GPInstance verbs)
    # ------------------------------------------------------------------
    def shard_patterns(self, group=None):
        """Shard the site-pattern axis over the ranks of `group`, a
        torch.distributed process group (the world where None), as
        bito_tpu/gp/engine.py:730-770 shards it over a device mesh: the
        patterns are padded to a multiple of the group's size with all-ones
        tips and weight 0, this rank keeps its contiguous slice
        (`pattern_shard`; `S` is its width from here on), and the
        per-pattern state is cleared.  DAG structure, q and branch lengths
        stay whole on every rank, and every sum over patterns is
        all-reduced (`_all_reduce`), so each public method returns the
        whole alignment's value on every rank.  `log_marginal_site` holds
        this rank's patterns."""
        shard = self._take_shard(self.S, 1, group)
        self.tips = shard.take(self.tips, 2, fill=1.0)
        self.weights = shard.take(self.weights, 0, fill=0.0)
        self.S = shard.width
        self.plv = None
        self.ls = None
        self.per_edge_ll = None
        self.log_marginal_site = None
        self._log_marginal = None

    def populate_plvs(self):
        self._check_precision()
        self.plv, self.ls = _populate_impl(
            self._idx, self._blc, self._qc, self.tips, self._np1,
            self.schedule.taxon_count)

    def compute_likelihoods(self):
        self._check_precision()
        assert self.plv is not None, "Call populate_plvs first"
        per_edge, self.log_marginal_site, self._log_marginal = (
            _likelihoods_impl(self._idx, self.plv, self.ls, self._blc,
                              self._qc, self.weights, self._all_reduce))
        self.per_edge_ll = per_edge[: self.schedule.edge_count]

    def log_marginal_likelihood(self) -> float:
        """Reference GPEngine::GetLogMarginalLikelihood: per-site log
        marginal dotted with site weights."""
        assert self._log_marginal is not None, (
            "Call compute_likelihoods first (grow()/populate invalidate "
            "the cached marginal)")
        return float(self._log_marginal)

    def per_gpcsp_log_likelihoods(self) -> np.ndarray:
        return self._host(self.per_edge_ll)

    def per_gpcsp_components_of_full_log_marginal(self) -> np.ndarray:
        """Reference GetPerGPCSPComponentsOfFullLogMarginal."""
        return (
            self._host(self.per_edge_ll)
            + float(self.site_pattern.weights.sum())
            * np.log(self._host(self.q))
        )

    def set_optimization_method(self, method: str):
        """Reference GPEngine::SetOptimizationMethod
        (src/gp_engine.cpp:656-658)."""
        if method not in METHODS:
            raise ValueError(f"Unknown optimization method {method!r}; "
                             f"expected one of {METHODS}")
        self.optimization_method = method

    def use_gradient_optimization(self, use_gradients: bool = True):
        """Reference GPEngine::UseGradientOptimization
        (src/gp_engine.cpp:660-664): selects Brent-with-gradient-fallback
        vs plain Brent."""
        self.set_optimization_method(
            "brent_with_gradients" if use_gradients else "brent")

    def optimize_branch_lengths_once(self):
        self._check_precision()
        E = self.schedule.edge_count
        old = self._blc
        self.plv, self.ls, self._blc = _sweep_impl(
            self._idx, self.plv, self.ls, self._blc, self._qc,
            self.weights, self.optimization_method, self._all_reduce)
        self.branch_length_differences = torch.abs(self._blc - old)[:E]

    def estimate_branch_lengths(self, tol: float, max_iter: int,
                                quiet: bool = True) -> float:
        """Reference GPInstance::EstimateBranchLengths
        (src/gp_instance.cpp:241-310): coordinate-ascent sweeps until the
        mean |Delta bl| drops below tol.  Convergence is decided by the
        mean alone (the reference's criterion), so quiet runs compute the
        likelihoods once, after the loop; verbose ones print each sweep's
        marginal."""
        self._check_precision()
        if quiet:
            E = self.schedule.edge_count
            ecap = self._blc.shape[0]
            mask = np.zeros(ecap)
            mask[:E] = 1.0
            plv, ls, blc, diff, _it = _estimate_impl(
                self._idx, self._blc, self._qc, self.tips, self.weights,
                tol, self._tensor(mask), self._np1,
                self.schedule.taxon_count, self.optimization_method,
                max_iter, self._all_reduce)
            self.plv, self.ls, self._blc = plv, ls, blc
            self.branch_length_differences = self._host(diff)[:E]
            self.compute_likelihoods()
            return self.log_marginal_likelihood()
        self.populate_plvs()
        for it in range(max_iter):
            self.optimize_branch_lengths_once()
            self.populate_plvs()
            diff = float(torch.mean(self.branch_length_differences))
            self.compute_likelihoods()
            print(f"Iteration {it + 1}: marginal "
                  f"{self.log_marginal_likelihood():.9f} "
                  f"mean|dbl| {diff:.3e}")
            if diff < tol:
                break
        self.compute_likelihoods()
        return self.log_marginal_likelihood()

    def _sbn_segment_arrays(self):
        """Flat segment-id arrays for the device-side SBN update, cached per
        schedule: seg_ids[e] in [0, nseg) for covered edges (-> bucket nseg
        for uncovered), plus singleton and covered masks."""
        segs = self.schedule.sbn_segments
        key = id(self.schedule)
        cached = getattr(self, "_sbn_seg_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1:]
        E = self.schedule.edge_count
        seg_ids = np.full(E, len(segs), dtype=np.int64)
        singleton = np.zeros(E, dtype=bool)
        for i, (start, end) in enumerate(segs):
            seg_ids[start:end] = i
            if end - start == 1:
                singleton[start] = True
        covered = seg_ids < len(segs)
        out = tuple(torch.as_tensor(x, device=self.device)
                    for x in (seg_ids, singleton, covered))
        out = (out[0], len(segs), out[1], out[2])
        self._sbn_seg_cache = (key,) + out
        return out

    def update_sbn_probabilities(self):
        """Reference UpdateSBNProbabilities (src/gp_engine.cpp:304-321):
        per-parent-segment posterior normalization of q, as one segment
        softmax on the device.  Segments whose hybrid marginals are all
        finite use those; otherwise the per-edge likelihoods."""
        seg_ids, nseg, singleton, covered = self._sbn_segment_arrays()
        hybrid = self._tensor(self.hybrid_marginal_log_likelihoods)
        self.q = _sbn_segment_softmax(self.q, self.per_edge_ll, hybrid,
                                      seg_ids, nseg, singleton, covered)

    def estimate_sbn_parameters(self):
        """Reference GPInstance::EstimateSBNParameters: populate, compute
        likelihoods, then normalize q per segment."""
        self.populate_plvs()
        self.compute_likelihoods()
        self.update_sbn_probabilities()
        self.compute_likelihoods()

    # -- branch length initialization from trees -----------------------
    def _edge_lengths_from_trees(self, tree_collection) -> Dict[int, List[float]]:
        from ..core.bitset import PCSP, Subsplit

        indexer = self.dag.build_edge_indexer()
        observed: Dict[int, List[float]] = {}
        for tree in tree_collection.trees:
            topo = tree.topology
            n = topo.num_taxa
            cl = topo.clades()
            ch = topo.children()
            ss = {}
            for v in range(n):
                ss[v] = Subsplit.leaf(v, n)
            for v in range(n, topo.num_nodes):
                kids = ch[v]
                ss[v] = Subsplit.of_pair(cl[kids[0]], cl[kids[1]], n)
            for v in range(topo.num_nodes - 1):
                parent = int(topo.parents[v])
                pcsp = PCSP.of_parent_child(ss[parent], ss[v]).to_string()
                if pcsp in indexer:
                    observed.setdefault(indexer[pcsp], []).append(
                        float(tree.branch_lengths[v])
                    )
        return observed

    def hot_start_branch_lengths(self, tree_collection):
        """Reference GPEngine::HotStartBranchLengths
        (src/gp_engine.cpp:676-746): per-edge mean of observed lengths."""
        bl = self._host(self.branch_lengths).copy()
        for e, vals in self._edge_lengths_from_trees(tree_collection).items():
            bl[e] = float(np.mean(vals))
        self.branch_lengths = bl

    def take_first_branch_length(self, tree_collection):
        bl = self._host(self.branch_lengths).copy()
        for e, vals in self._edge_lengths_from_trees(tree_collection).items():
            bl[e] = vals[0]
        self.branch_lengths = bl


def _sbn_segment_softmax(q, ll, hybrid, seg_ids, nseg, singleton, covered):
    """Segment softmax for UpdateSBNProbabilities: per segment, normalize
    exp(src + log q); singletons pin to 1; uncovered edges keep their q."""
    def segment(reduce, x, start):
        return torch.full((nseg + 1,), start, dtype=x.dtype,
                          device=x.device).scatter_reduce(
            0, seg_ids, x, reduce=reduce)

    finite = torch.isfinite(hybrid)
    # A segment uses hybrid values iff every member is finite.
    seg_all_finite = segment("amin", finite.to(torch.int64),
                             torch.iinfo(torch.int64).max)
    use_hybrid = seg_all_finite[seg_ids] > 0
    src = torch.where(use_hybrid, hybrid, ll)
    x = src + torch.log(q)
    m = segment("amax", x, -torch.inf)
    p = torch.exp(x - m[seg_ids])
    s = torch.zeros((nseg + 1,), dtype=p.dtype,
                    device=p.device).index_add_(0, seg_ids, p)
    out = p / s[seg_ids]
    out = torch.where(singleton, torch.ones_like(out), out)
    return torch.where(covered, out, q)


# ---------------------------------------------------------------------------
# Quartet hybrid marginals (reference GPEngine::CalculateQuartetHybridLikelihoods,
# src/gp_engine.cpp:748-816; requests per GPDAG::QuartetHybridRequestOf,
# src/gp_dag.cpp:413-458).
# ---------------------------------------------------------------------------
def _quartet_hybrid_program(root_pv, root_ls, root_bl, log_prior_g,
                            inv_prior_i, sis_pv, sis_ls, sis_bl, q_j,
                            central_bl, rot_pv, rot_ls, rot_bl, q_k,
                            sor_pv, sor_ls, sor_bl, q_l, weights,
                            reduce=unsharded):
    """All (i, j, k, l) quartet log likelihoods of a batch of hybrid
    requests of one shape, with a leading request axis r on every input
    but the weights (replaces the reference's nested per-tip loops,
    src/gp_engine.cpp:748-816).  PV inputs are [R, N, 4, S]; scale inputs
    [R, N, S]; returns [R, I, J, K, L] in the reference's loop order.
    `reduce` makes the sums over this rank's patterns whole, before the
    terms that are not sums over patterns are added."""
    root = torch.einsum("riab,ribs->rias", jc69_transition(root_bl), root_pv)
    sis = torch.einsum("rjab,rjbs->rjas", jc69_transition(sis_bl), sis_pv)
    rot = torch.einsum("rkab,rkbs->rkas", jc69_transition(rot_bl), rot_pv)
    sor = torch.einsum("rlab,rlbs->rlas", jc69_transition(sor_bl), sor_pv)
    r_s = root[:, :, None] * sis[:, None]                 # [R,I,J,4,S]
    q_s = torch.einsum("rab,rijbs->rijas", jc69_transition(central_bl), r_s)
    r_sorted = q_s[:, :, :, None] * rot[:, None, None]    # [R,I,J,K,4,S]
    val = torch.einsum("rijkas,rlas->rijkls", r_sorted, sor)
    scales_ijk = (root_ls[:, :, None, None, :] + sis_ls[:, None, :, None, :]
                  + rot_ls[:, None, None, :, :])          # [R,I,J,K,S]
    per_site = (_log_positive(val)
                + scales_ijk[:, :, :, :, None, :]
                + sor_ls[:, None, None, None, :, :]
                - log_prior_g[:, :, None, None, None, None])
    total = reduce(torch.einsum("rijkls,s->rijkl", per_site, weights))
    non_seq = (torch.log(inv_prior_i)[:, :, None, None, None]
               + torch.log(q_j)[:, None, :, None, None]
               + torch.log(q_k)[:, None, None, :, None]
               + torch.log(q_l)[:, None, None, None, :])
    return total + non_seq


class _HybridMixin:
    def _hybrid_request(self, parent_id: int, is_left: bool, child_id: int):
        """(rootward, sister, rotated, sorted) tip lists: each entry is
        (node_id, plv_type, edge_id)."""
        dag = self.dag
        rootward = []
        for side in (RIGHT, LEFT):
            for g, e in dag.rootward[parent_id][side]:
                if g == dag.root_id:
                    continue
                rootward.append((g, RLEFT if side == LEFT else RRIGHT, e))
        sister_side = RIGHT if is_left else LEFT
        sister = [(s, P, e) for s, e in dag.leafward[parent_id][sister_side]]
        rotated = [(c, P, e) for c, e in dag.leafward[child_id][LEFT]]
        sorted_ = [(c, P, e) for c, e in dag.leafward[child_id][RIGHT]]
        return rootward, sister, rotated, sorted_

    def _hybrid_inputs(self, requests, centrals):
        """The quartet program's inputs for requests of one shape, stacked
        on a leading request axis."""
        plv, ls, bl, q = self.plv, self.ls, self.branch_lengths, self.q
        inv_prior = self._tensor(self.inverted_sbn_prior)
        node_probs = self._tensor(self.unconditional_node_probabilities)

        def ids(entries_list, k):
            return torch.as_tensor([[entry[k] for entry in ee]
                                    for ee in entries_list],
                                   dtype=torch.long, device=self.device)

        def stacked(entries_list):
            nodes, types, edges = (ids(entries_list, k) for k in range(3))
            return (plv[types, nodes], ls[types, nodes], bl[edges], edges)

        root_pv, root_ls, root_bl, root_e = stacked([r[0] for r in requests])
        sis_pv, sis_ls, sis_bl, sis_e = stacked([r[1] for r in requests])
        rot_pv, rot_ls, rot_bl, rot_e = stacked([r[2] for r in requests])
        sor_pv, sor_ls, sor_bl, sor_e = stacked([r[3] for r in requests])
        g_ids = ids([r[0] for r in requests], 0)
        central = torch.as_tensor(np.asarray(centrals), dtype=torch.long,
                                  device=self.device)
        return (root_pv, root_ls, root_bl, torch.log(node_probs[g_ids]),
                inv_prior[root_e], sis_pv, sis_ls, sis_bl, q[sis_e],
                bl[central], rot_pv, rot_ls, rot_bl, q[rot_e],
                sor_pv, sor_ls, sor_bl, q[sor_e], self.weights)

    def calculate_quartet_hybrid_likelihoods(
        self, parent_id: int, is_left: bool, child_id: int
    ) -> Optional[np.ndarray]:
        """Per-combination quartet log likelihoods for the central edge
        (parent, child); None if the request is not fully formed."""
        self._check_precision()
        req = self._hybrid_request(parent_id, is_left, child_id)
        if not all(req):
            return None
        central_edge = self.dag.edge_to_id[(parent_id, child_id)]
        vals = _quartet_hybrid_program(*self._hybrid_inputs(
            [req], [central_edge]), reduce=self._all_reduce)
        return self._host(vals[0]).reshape(-1)

    def process_quartet_hybrid_request(self, parent_id: int, is_left: bool,
                                       child_id: int):
        vals = self.calculate_quartet_hybrid_likelihoods(
            parent_id, is_left, child_id
        )
        if vals is None:
            return
        from scipy.special import logsumexp

        central = self.dag.edge_to_id[(parent_id, child_id)]
        self.hybrid_marginal_log_likelihoods[central] = float(logsumexp(vals))

    def calculate_hybrid_marginals(self):
        """Reference GPInstance::CalculateHybridMarginals
        (src/gp_instance.cpp:408-417).

        Requests are grouped by their (rootward, sister, rotated, sorted)
        tip-count shape; each group runs as one batched program with a
        logsumexp on the device."""
        self.populate_plvs()
        dag = self.dag
        self.hybrid_marginal_log_likelihoods = np.full(
            dag.edge_count(), -np.inf
        )
        groups: Dict[Tuple[int, int, int, int], list] = {}
        for parent, side, child, edge in dag.topological_edge_traversal():
            if parent == dag.root_id or child < dag.taxon_count:
                continue
            req = self._hybrid_request(parent, side == LEFT, child)
            if not all(req):
                continue
            shape = tuple(len(x) for x in req)
            central = dag.edge_to_id[(parent, child)]
            groups.setdefault(shape, []).append((central, req))
        for shape, reqs in groups.items():
            centrals = np.asarray([c for c, _ in reqs])
            vals = _quartet_hybrid_program(*self._hybrid_inputs(
                [r for _, r in reqs], centrals), reduce=self._all_reduce)
            self.hybrid_marginal_log_likelihoods[centrals] = self._host(
                torch.logsumexp(vals.flatten(1), dim=1))


for _name in ("_hybrid_request", "_hybrid_inputs",
              "calculate_quartet_hybrid_likelihoods",
              "process_quartet_hybrid_request", "calculate_hybrid_marginals"):
    setattr(GPEngine, _name, getattr(_HybridMixin, _name))
