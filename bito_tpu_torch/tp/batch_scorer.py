"""Batched proposed-NNI scoring: the 5-edge local program over every
candidate at once (torch, float64).

Port of bito_tpu.tp.batch_scorer.  Candidate NNI scoring is the
reference's declared hot loop (reference src/nni_engine.cpp:230-257
FilterScoreAdjacentNNIs; src/tp_evaluation_engine.cpp:466-643
GetTopTreeScoreWithProposedNNI).  Each proposed NNI is scored by a
fixed-shape program over five local edges: rootward + leafward passes over
[4, S] partial vectors, then `optimize_max_iter` rounds of serial Brent
line searches in log-branch-length space over the slots (left, right,
sister, central, parent), then the focal-edge log likelihood.

What bito_tpu vmaps over candidates is written out here with a leading
candidate axis, and its Brent (`lax.while_loop` whose lanes stop on their
own `done` flags under vmap; the reference's Boost-adapted guess-init
Brent, src/optimization.hpp:70-188) is a Python loop of masked updates
(`torch.where`): a lane that is done keeps its state, so the loop may run
past the moment the last lane finishes without changing a result, and it
reads the all-done flag back from the device only every CHECK_EVERY
iterations.  XLA's Precision.HIGHEST dots are float64 products.  No part
of it is a hand-written kernel: bito_tpu's program is XLA, not Pallas.

Numerical contract: the faithful path's precision is float64 (bito_tpu
pins this scorer to the host CPU because the TPU lacks float64; the H100
has it), so the scorer runs in float64 on the device it is given, the card
by default, and follows the exact update sequence of
`FaithfulTPEvalEngine.score_proposed_nni` (eval_engine.py) up to the
reassociation of its sums.  bito_tpu pads the candidate count to a bucket
(`_bucket`) so that XLA compiles once a bucket; torch compiles nothing,
and the port pads nothing.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import PRODUCT_DEVICE, resolve
from .eval_engine import (
    A_FOCAL,
    A_LEFT,
    A_PARENT,
    A_RIGHT,
    A_SISTER,
    BL_DIFF_THRESHOLD,
    BRENT_MAX_ITER,
    JC69_EIGENVALUES,
    JC69_V,
    JC69_VINV,
    MAX_LOG_BL,
    MIN_LOG_BL,
    SIGNIFICANT_DIGITS,
)

_GOLDEN = 0.3819659948348999  # float32 of the reference's 0.3819660f
# Brent iterations between reads of the all-done flag (one host sync each)
CHECK_EVERY = 8


def _transition(bl, V, lam, Vinv):
    """P(t) [K, 4, 4] for branch lengths bl [K]: V diag(exp(t*lambda))
    V^-1 (reference SetTransitionMatrixToHaveBranchLength,
    tp_evaluation_engine.cpp:1223)."""
    return (V * torch.exp(bl[:, None] * lam)[:, None, :]) @ Vinv


def _brent_minimize(f, guess, lo0, hi0, max_iter=BRENT_MAX_ITER,
                    significant_digits=SIGNIFICANT_DIGITS, active=None,
                    check_every=CHECK_EVERY):
    """Lane-wise replica of eval_engine.brent_minimize_scalar (itself the
    reference Optimization::BrentMinimize, src/optimization.hpp:70-188):
    each iteration reproduces one serial iteration in every lane that is
    not done, and leaves the lanes that are done as they were, so each
    lane follows the scalar loop step for step.  Returns (argmin, min).

    `active=False` lanes start done and return (guess, f(guess))
    untouched: callers whose result would be masked off anyway (slots with
    fixed branch lengths under fix_proposed_bls_from_dag) then cost no
    iterations."""
    tolerance = math.ldexp(1.0, 1 - significant_digits)
    x = w = v = guess
    fx = f(x)
    fw = fv = fx
    delta = delta2 = torch.zeros_like(x)
    lo, hi = lo0, hi0
    count = torch.full(x.shape, max_iter, dtype=torch.int64,
                       device=x.device)
    done = (torch.zeros(x.shape, dtype=torch.bool, device=x.device)
            if active is None else ~active)
    it = 0
    while not (it % check_every == 0 and bool(done.all())):
        it += 1
        mid = (lo + hi) / 2.0
        fract1 = tolerance * torch.abs(x) + tolerance / 4.0
        fract2 = 2.0 * fract1
        stop = torch.abs(x - mid) <= (fract2 - (hi - lo) / 2.0)

        # Parabolic interpolation attempt (guarded where the serial code
        # would not evaluate it).
        r = (x - w) * (fx - fv)
        q = (x - v) * (fx - fw)
        p = (x - v) * q - (x - w) * r
        q = 2.0 * (q - r)
        p = torch.where(q > 0, -p, p)
        q = torch.abs(q)
        td = delta2
        interp_ok = (
            (torch.abs(delta2) > fract1)
            & ~(torch.abs(p) >= torch.abs(q * td / 2.0))
            & ~(p <= q * (lo - x))
            & ~(p >= q * (hi - x))
        )
        q_safe = torch.where(q == 0.0, torch.ones_like(q), q)
        delta_cand = p / q_safe
        u_cand = x + delta_cand
        near_end = ((u_cand - lo) < fract2) | ((hi - u_cand) < fract2)
        delta_interp = torch.where(
            near_end,
            torch.where(mid - x < 0, -torch.abs(fract1), torch.abs(fract1)),
            delta_cand,
        )
        delta2_bis = torch.where(x >= mid, lo - x, hi - x)
        new_delta2 = torch.where(interp_ok, delta, delta2_bis)
        new_delta = torch.where(interp_ok, delta_interp, _GOLDEN * delta2_bis)
        u = torch.where(
            torch.abs(new_delta) >= fract1,
            x + new_delta,
            torch.where(new_delta > 0, x + torch.abs(fract1),
                        x - torch.abs(fract1)),
        )
        fu = f(u)
        improved = fu <= fx
        lo_n = torch.where(improved, torch.where(u >= x, x, lo),
                           torch.where(u < x, u, lo))
        hi_n = torch.where(improved, torch.where(u >= x, hi, x),
                           torch.where(u < x, hi, u))
        # v,w,x bookkeeping (the serial else-branch's two sub-cases).
        case_w = (fu <= fw) | (w == x)
        case_v = (fu <= fv) | (v == x) | (v == w)
        v_n = torch.where(improved, w, torch.where(
            case_w, w, torch.where(case_v, u, v)))
        fv_n = torch.where(improved, fw, torch.where(
            case_w, fw, torch.where(case_v, fu, fv)))
        w_n = torch.where(improved, x, torch.where(case_w, u, w))
        fw_n = torch.where(improved, fx, torch.where(case_w, fu, fw))
        x_n = torch.where(improved, u, x)
        fx_n = torch.where(improved, fu, fx)
        count_n = count - 1

        # A lane that was done, or stops now, keeps its state.
        keep = done | stop

        def upd(old, new):
            return torch.where(keep, old, new)

        x, w, v = upd(x, x_n), upd(w, w_n), upd(v, v_n)
        fx, fw, fv = upd(fx, fx_n), upd(fw, fw_n), upd(fv, fv_n)
        delta, delta2 = upd(delta, new_delta), upd(delta2, new_delta2)
        lo, hi = upd(lo, lo_n), upd(hi, hi_n)
        count = upd(count, count_n)
        done = done | stop | (count_n == 0)
    return x, fx


def _score_batch(sister_p, left_p, right_p, parent_rhat_in, gp_rfocal,
                 has_gp, bl0, do_opt, rootsplit, weights, V, lam, Vinv,
                 optimize_max_iter: int, do_optimize: bool):
    """Every candidate's proposed-NNI score [K]; mirrors
    FaithfulTPEvalEngine.score_proposed_nni statement for statement, with
    a leading candidate axis: PVs [K, 4, S], bl0 and do_opt [K, 5], has_gp
    and rootsplit [K]."""
    def P_of(b):
        return _transition(b, V, lam, Vinv)

    def make_neg_ll(ppv, cpv):
        """JC69 closed-form Brent objective: P(t) = 1/4 + (I - 1/4)
        e^{-4t/3}, so the per-site values collapse to c0 + c1 e^{-4t/3}
        with c0/c1 precomputed once per slot, in place of a [4, 4] matrix
        build and a [4, 4] @ [4, S] product per evaluation.  Algebraically
        identical to the matrix form; the different rounding shifts
        converged scores at about 1e-12 (tests/test_torch_batch_scorer.py
        pins the batched-against-serial agreement)."""
        c0 = 0.25 * ppv.sum(dim=1) * cpv.sum(dim=1)
        c1 = torch.einsum("kas,kas->ks", ppv, cpv) - c0

        def f(y):
            u = torch.exp(-4.0 / 3.0 * torch.exp(y))
            return -(torch.log(c0 + c1 * u[:, None]) @ weights)

        return f

    def brent_slot(bl, diffs, slot, ppv, cpv, check, extra=None):
        obj = make_neg_ll(ppv, cpv)
        cur_y = torch.log(bl[:, slot])
        cur_f = obj(cur_y)
        run = do_opt[:, slot]
        if extra is not None:
            run = run & extra
        if check:
            run = run & (diffs[:, slot] >= BL_DIFF_THRESHOLD)
        y, fy = _brent_minimize(obj, cur_y,
                                torch.full_like(cur_y, MIN_LOG_BL),
                                torch.full_like(cur_y, MAX_LOG_BL),
                                active=run)
        new_bl = torch.where(fy > cur_f, torch.exp(cur_y), torch.exp(y))
        diffs, bl = diffs.clone(), bl.clone()
        diffs[:, slot] = torch.where(run, torch.abs(torch.exp(cur_y)
                                                    - new_bl), diffs[:, slot])
        bl[:, slot] = torch.where(run, new_bl, bl[:, slot])
        return bl, diffs

    def rootward(bl):
        cpl = P_of(bl[:, A_LEFT]) @ left_p
        cpr = P_of(bl[:, A_RIGHT]) @ right_p
        cp = cpl * cpr
        pps = P_of(bl[:, A_SISTER]) @ sister_p
        ppf = P_of(bl[:, A_FOCAL]) @ cp
        return cpl, cpr, cp, pps, ppf

    def leafward(bl, pps):
        prhat = torch.where(has_gp[:, None, None],
                            P_of(bl[:, A_PARENT]) @ gp_rfocal,
                            parent_rhat_in)
        prf = prhat * pps
        crhat = P_of(bl[:, A_FOCAL]) @ prf
        return prhat, prf, crhat

    bl = bl0
    diffs = torch.zeros_like(bl0)
    cpl, cpr, cp, pps, ppf = rootward(bl)
    prhat, prf, crhat = leafward(bl, pps)

    if do_optimize:
        for it in range(optimize_max_iter):
            check = it > 0
            # OptimizeLeftChild (tp_evaluation_engine.cpp:571-579)
            child_rleft = crhat * cpr
            bl, diffs = brent_slot(bl, diffs, A_LEFT, child_rleft, left_p,
                                   check)
            cpl = P_of(bl[:, A_LEFT]) @ left_p
            cp = cpl * cpr
            # OptimizeRightChild
            child_rright = crhat * cpl
            bl, diffs = brent_slot(bl, diffs, A_RIGHT, child_rright, right_p,
                                   check)
            cpr = P_of(bl[:, A_RIGHT]) @ right_p
            cp = cpr * cpl
            # OptimizeSister
            parent_rsister = prhat * ppf
            bl, diffs = brent_slot(bl, diffs, A_SISTER, parent_rsister,
                                   sister_p, check)
            pps = P_of(bl[:, A_SISTER]) @ sister_p
            # OptimizeCentral
            cp = cpl * cpr
            prf = prhat * pps
            bl, diffs = brent_slot(bl, diffs, A_FOCAL, prf, cp, check)
            ppf = P_of(bl[:, A_FOCAL]) @ cp
            # OptimizeParent — skipped for rootsplit parents / absent
            # grandparent (eval_engine.py:759-766).
            parent_p = ppf * pps
            bl, diffs = brent_slot(bl, diffs, A_PARENT, gp_rfocal, parent_p,
                                   check, extra=(~rootsplit) & has_gp)
            cpl, cpr, cp, pps, ppf = rootward(bl)
            prhat, prf, crhat = leafward(bl, pps)

    vals = torch.einsum("kas,kas->ks", prf, P_of(bl[:, A_FOCAL]) @ cp)
    return torch.log(vals) @ weights


def score_proposed_nnis_batched(
    engine, posts: Sequence[Tuple], best_edge_map: Optional[Dict[str, int]]
) -> np.ndarray:
    """Score a set of proposed NNIs as one batched float64 program on the
    engine's `device` attribute where its owner set one, else on the card.

    `engine` is a FaithfulTPEvalEngine; host-side candidate prep (choice-map
    remapping, best-edge lookup, PV gathering) reuses its
    `_proposed_nni_inputs`, and the compute — 5-slot Brent optimization plus
    the focal-edge likelihood — runs on the device for all candidates at
    once.  Returns scores in `posts` order as a host array, matching
    `score_proposed_nni` serial results to float64 reassociation tolerance.
    """
    device, dtype = resolve(getattr(engine, "device", PRODUCT_DEVICE),
                            torch.float64)
    C = len(posts)
    if C == 0:
        return np.zeros(0)
    S = engine.site_pattern.pattern_count
    # Absent grandparents get uniform PVs: their Brent lanes are inactive.
    sister = np.empty((C, 4, S))
    left = np.empty((C, 4, S))
    right = np.empty((C, 4, S))
    prhat = np.empty((C, 4, S))
    gp = np.full((C, 4, S), 0.25)
    has_gp = np.zeros(C, dtype=bool)
    bl0 = np.empty((C, 5))
    do_opt = np.empty((C, 5), dtype=bool)
    rootsplit = np.zeros(C, dtype=bool)
    for i, post in enumerate(posts):
        refs, bl_i, do_i, _pre, _adj = engine._proposed_nni_inputs(
            post, best_edge_map if engine.use_best_edge_map else None)
        sister[i] = refs.sister_p
        left[i] = refs.leftchild_p
        right[i] = refs.rightchild_p
        prhat[i] = refs.parent_rhat
        if refs.grandparent_rfocal is not None:
            gp[i] = refs.grandparent_rfocal
            has_gp[i] = True
        bl0[i] = bl_i
        do_opt[i] = do_i
        rootsplit[i] = post[0].is_rootsplit()

    def dev(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=device)

    scores = _score_batch(
        dev(sister), dev(left), dev(right), dev(prhat), dev(gp),
        dev(has_gp, torch.bool), dev(bl0), dev(do_opt, torch.bool),
        dev(rootsplit, torch.bool), dev(engine.weights), dev(JC69_V),
        dev(JC69_EIGENVALUES), dev(JC69_VINV),
        optimize_max_iter=engine.optimize_max_iter,
        do_optimize=engine.do_optimize_new_edges,
    )
    return scores.cpu().numpy()


def scores_with_brent_traces(engine, nnis, best_edge_map):
    """(batched, serial, rounded) for the proposed NNIs `nnis` of a
    FaithfulTPEvalEngine: this module's scores, the serial numpy scorer's
    (score_proposed_nni), and for each candidate whether their Brent line
    searches ended at different points (log branch lengths more than 1e-8
    apart in some search, or another number of searches).  Where they
    did, a step of Brent was decided by rounding: its parabolic steps
    magnify a change in the last bits of a guess or an objective, and the
    two scores are the objective's maxima to Brent's tolerance (2^-9 in
    log branch length), not to rounding.  The searches are traced by
    wrapping both Brent functions for the duration of the call."""
    from . import eval_engine

    global _brent_minimize
    serial_fn, batched_fn = eval_engine.brent_minimize_scalar, _brent_minimize
    trace = {"serial": [], "batched": []}

    def serial_rec(*args, **kwargs):
        y, fy = serial_fn(*args, **kwargs)
        trace["serial"].append(y)
        return y, fy

    def batched_rec(f, guess, lo, hi, active=None, **kwargs):
        y, fy = batched_fn(f, guess, lo, hi, active=active, **kwargs)
        act = (torch.ones_like(guess, dtype=torch.bool) if active is None
               else active)
        trace["batched"].append((y.cpu().numpy(), act.cpu().numpy()))
        return y, fy

    eval_engine.brent_minimize_scalar, _brent_minimize = serial_rec, batched_rec
    try:
        batched = np.asarray(score_proposed_nnis_batched(
            engine, list(nnis), best_edge_map))
        serial, rounded = [], []
        for k, nni in enumerate(nnis):
            trace["serial"].clear()
            serial.append(engine.score_proposed_nni(nni, best_edge_map))
            a = np.array(trace["serial"])
            b = np.array([y[k] for y, act in trace["batched"] if act[k]])
            rounded.append(a.shape != b.shape
                           or bool(np.any(np.abs(a - b) > 1e-8)))
    finally:
        eval_engine.brent_minimize_scalar, _brent_minimize = (serial_fn,
                                                              batched_fn)
    return batched, np.array(serial), np.array(rounded)
