"""The per-node-slot tree-likelihood kernels over the scan tape's own ops.

Counterpart of bito_tpu.treelike.pallas_pruning's two Pallas kernels,
`pallas_log_likelihoods` and `pallas_ll_and_gradients` (named pernode here
to keep it apart from the scan tape, pruning.py).  They read the tapes of
encode.py as they are: post_ops [B, M, 5] = (dest, src1, edge1, src2,
edge2) and pre_ops [B, Mp, 6] = (dest, parent, sib1, edge1, sib2, edge2),
with one partial slot per node and slot N (the dummy) all ones.  The root
comes as root [B]; bito_tpu appended it to the tape as an extra row for
the TPU's scalar memory.

The engine does not route to them, as bito_tpu's engine does not: they are
public functions, driven the way scripts/bench_kernel_race.py drives their
originals (prep.prepare_inputs_grad operands on the engine's tapes).

Each kernel has, as in paired.py:
  - the plain torch version (`*_ref`): the scan tape's own postorder,
    root and preorder adjoints (pruning.py) on the kernels' compact operands;
  - the public wrapper: a CPU tensor goes to the plain version; a CUDA
    tensor goes to a hand-written kernel, and the call raises if the
    kernel cannot take the inputs or fails to launch;
  - a launch count on each launcher, `launcher.launches`.

Each kernel has two bodies on the card.  The LL kernel's on-chip body is
the paired LL body (csrc/paired_ll_onchip.cu, `pernode_ll_onchip`) over
the tape that `ll_tape` derives on the host: the per-node ops as a paired
tape, each source a child code (the op that last wrote it, a tip, or ones)
and each output a row by liveness.  Its global body, for trees past the
on-chip limit, is csrc/pernode_ll.cu (`pernode_ll_global`);
`paired.onchip_plan("ll", ...)` chooses before the launch.  The grad
kernel's on-chip body is csrc/pernode_grad_onchip.cu over
csrc/pernode_onchip.cuh (a node's partial and then its up value in one
shared-memory row, a parent's children evolved together,
`pernode_grad_onchip`), its global body csrc/pernode_grad.cu (partials in
device memory, `pernode_grad_global`); `onchip_plan` chooses, from the
tape that `onchip_tape` derives on the host.  Where that body gets no
plan (at 17-32 categories, where the tree's P and dP staged at once leave
it too few warps, and past 32) the grad kernel runs the paired grad
kernel's on-chip body (csrc/paired_grad_onchip.cu, `pernode_grad_paired`)
on the per-node ops turned into a paired tape (`PairedGradTape`, which
onchip_tape derives beside its own: the LL body's post_dst and child
codes, gradient rows by node id), where the paired plan gives one, and
the global body below it.

At 4 states both kernels take any count of rate categories, as the
paired ones do: 1-8 compiled one count at a time, 9-32 on 16 or 32 lanes
a pattern with the count read at run time (the on-chip bodies'
templates; the global bodies are then csrc/pernode_lanes.cuh, which
walks post_ops and pre_ops as pernode_ll.cu and pernode_grad.cu do, a
category a lane), and past 32 (paired.ONCHIP_CATEGORIES) on 32 lanes of
paired.lane_categories(C) categories each: the paired on-chip LL and
grad bodies up to paired.ONCHIP_MAX_CATEGORIES, the global bodies at any
count; their launchers split the batch over slices of trees where the
scratch would not fit (paired.launch_sliced).

At 64 states (MG94 codon models, as bito_tpu's per-node kernels take
them) both functions run on the paired kernels' A=64 bodies
(csrc/paired_ll_a64.cu, csrc/paired_grad_a64.cu, `paired.paired_ll_a64`
and `paired.paired_grad_a64`, which count the launches), over the paired
tape that `a64_tape` derives on the host: the LL's from post_ops and
root, as ll_tape derives it; the grad's the same, after checking that
pre_ops describes the same tree, since the paired walk reads the
preorder from the postorder's own tape.  They take any count of
categories there too, and the launchers' slices of trees where the
scratch would not fit (paired.tree_slices).

Operands: post_ops, pre_ops, root int32; P, dP [B, N+1, C, A, A]; tips
[T, A, S]; pi [A]; props [C]; weights [S]; edge_mask [B, N]; A is 4 or 64
(paired.KERNEL_STATES).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import timing
from . import _kernels, paired, pruning
from .paired import _check_cuda_operands, _check_cuda_tensors


def _postorder(post_ops, P, tips):
    """The per-node buffer [B, N+1, C, A, S] (tips in slots 0..T-1, ones
    elsewhere) and log scales [B, N+1, S] after the postorder tape."""
    B, N1, C, A = P.shape[:4]
    T, _, S = tips.shape
    buf = torch.ones((B, N1, C, A, S), device=P.device, dtype=P.dtype)
    buf[:, :T] = tips.to(P.dtype)[None, :, None]
    ls = torch.zeros((B, N1, S), device=P.device, dtype=P.dtype)
    return pruning.postorder_pass(post_ops.long(), P, buf, ls)


def _batch_model(pi, props, B, dtype):
    return (pi.to(dtype).expand(B, pi.shape[0]),
            props.to(dtype).expand(B, props.shape[0]))


def pernode_log_likelihoods_ref(post_ops, root, P, tips, pi, props,
                                weights) -> torch.Tensor:
    """Plain torch version of the LL kernel: per-tree log likelihoods [B]."""
    buf, ls = _postorder(post_ops, P, tips)
    pi_b, props_b = _batch_model(pi, props, P.shape[0], P.dtype)
    return (pruning.root_log_likelihood(buf, ls, root.long(), pi_b, props_b)
            @ weights.to(P.dtype))


def pernode_ll_and_gradients_ref(post_ops, pre_ops, root, edge_mask, P, dP,
                                 tips, pi, props, weights):
    """Plain torch version of the LL+gradient kernel: (ll [B], branch
    gradients [B, N])."""
    w = weights.to(P.dtype)
    buf, ls = _postorder(post_ops, P, tips)
    pi_b, props_b = _batch_model(pi, props, P.shape[0], P.dtype)
    root = root.long()
    ll = pruning.root_log_likelihood(buf, ls, root, pi_b, props_b) @ w
    adj, _, _ = pruning.edge_adjoints(pre_ops.long(), P, buf, root, pi_b,
                                      props_b, w)
    grads = (adj * dP).sum((-3, -2, -1))
    N = edge_mask.shape[1]
    return ll, grads[:, :N] * edge_mask.to(P.dtype)


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------

def _check_shapes(post_ops, root, P, tips, pi, props, weights):
    B, M, _ = post_ops.shape
    N1, C, A = P.shape[1], P.shape[2], P.shape[3]
    T, _, S = tips.shape
    expect = {
        "post_ops": (post_ops, (B, M, 5)), "root": (root, (B,)),
        "P": (P, (B, N1, C, A, A)), "tips": (tips, (T, A, S)),
        "pi": (pi, (A,)), "props": (props, (C,)), "weights": (weights, (S,)),
    }
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    return B, M, T, N1, C, A, S


def pernode_log_likelihoods(post_ops, root, P, tips, pi, props, weights, *,
                            onchip: LLTape | A64Tape | None = None
                            ) -> torch.Tensor:
    """Per-tree log likelihoods [B] over the per-node tape.

    On the card it launches, at 4 states, the on-chip body where
    `paired.onchip_plan("ll", ...)` gives a plan, else the global body,
    and `onchip` is the tape's `ll_tape`; at 64 states the paired A=64 LL
    kernel, and `onchip` is the tape's `a64_tape`.  Where `onchip` is not
    given the wrapper derives it (a copy of the tapes to the host).  The
    CPU runs the plain version, which needs none."""
    if paired.on_cpu(P):
        return pernode_log_likelihoods_ref(post_ops, root, P, tips, pi, props,
                                           weights)
    B, M, T, N1, C, A, S = _check_shapes(post_ops, root, P, tips, pi, props,
                                         weights)
    _check_cuda_operands(
        dict(post_ops=post_ops, root=root),
        dict(P=P, tips=tips, pi=pi, props=props, weights=weights), C, A,
        paired.KERNEL_STATES)
    if A == 64:
        tape = _a64_of(onchip, post_ops, root, None, T, N1, P.device)
        return paired.paired_ll_a64(tape.post_dst, tape.tip_slot,
                                    tape.post_e, P, tips, pi, props) @ weights
    if onchip is None:
        onchip = ll_tape(post_ops.cpu().numpy(), root.cpu().numpy(), T,
                         N1 - 1, P.device)
    if tuple(onchip.post_dst.shape) != (B, M):
        raise ValueError("the on-chip tape does not match post_ops")
    plan = paired.onchip_plan("ll", onchip.ll_rows, M, N1, C)
    if plan is None:
        ll_rows = pernode_ll_global(post_ops, root, P, tips, pi, props)
    else:
        ll_rows = pernode_ll_onchip(onchip, P, tips, pi, props, plan)
    return ll_rows @ weights


def pernode_ll_and_gradients(post_ops, pre_ops, root, edge_mask, P, dP, tips,
                             pi, props, weights, *,
                             onchip: OnchipTape | A64Tape | None = None):
    """Per-tree (log likelihood [B], branch gradients [B, N]).

    On the card it launches, at 4 states, the on-chip body where
    `onchip_plan` gives a plan, else the paired grad kernel's on-chip body
    on the tape's PairedGradTape where `paired_plan` gives one, else the
    global body, and `onchip` is the tape's OnchipTape; at 64 states the
    paired A=64 grad kernel, and `onchip` is the tape's `a64_tape` with
    pre_ops.  Where `onchip` is not
    given the wrapper derives it (a copy of the tapes to the host).  The
    CPU runs the plain version, which needs none."""
    if paired.on_cpu(P):
        return pernode_ll_and_gradients_ref(post_ops, pre_ops, root,
                                            edge_mask, P, dP, tips, pi, props,
                                            weights)
    B, M, T, N1, C, A, S = _check_shapes(post_ops, root, P, tips, pi, props,
                                         weights)
    Mp = pre_ops.shape[1]
    if tuple(pre_ops.shape) != (B, Mp, 6) or tuple(dP.shape) != tuple(P.shape):
        raise ValueError("pre_ops or dP does not match post_ops and P")
    if tuple(edge_mask.shape) != (B, N1 - 1):
        raise ValueError(f"edge_mask has shape {tuple(edge_mask.shape)}, "
                         f"expected {(B, N1 - 1)}")
    _check_cuda_operands(
        dict(post_ops=post_ops, pre_ops=pre_ops, root=root),
        dict(P=P, dP=dP, tips=tips, pi=pi, props=props, weights=weights,
             edge_mask=edge_mask),
        C, A, paired.KERNEL_STATES)
    if A == 64:
        tape = _a64_of(onchip, post_ops, root, pre_ops, T, N1, P.device)
        return paired.finish_rows(*paired.paired_grad_a64(
            tape.post_dst, tape.tip_slot, tape.post_src, tape.post_e, P, dP,
            tips, pi, props, weights), edge_mask, weights)
    if onchip is None:
        onchip = onchip_tape(*(x.cpu().numpy() for x in (post_ops, pre_ops,
                                                         root)),
                             T, N1 - 1, P.device)
    if tuple(onchip.post.shape[:2]) != (B, M):
        raise ValueError("the on-chip tape does not match post_ops")
    plan = onchip_plan(onchip.rows, onchip.ints, N1, C)
    if plan is not None:
        return finish_rows(*pernode_grad_onchip(
            onchip, root, P, dP, tips, pi, props, weights, plan), edge_mask,
            weights)
    plan = paired_plan(onchip.paired, N1, C)
    if plan is not None:  # gradient rows by node, some not written
        return paired.finish_rows(*pernode_grad_paired(
            onchip.paired, P, dP, tips, pi, props, weights, plan), edge_mask,
            weights)
    return finish_rows(*pernode_grad_global(
        post_ops, pre_ops, root, P, dP, tips, pi, props, weights), edge_mask,
        weights)


def finish_rows(ll_rows, grad_rows, edge_mask, weights):
    """(ll [B], grads [B, N]) from a body's per-pattern rows: the weighted
    sums over patterns, masked by edge."""
    N = edge_mask.shape[1]
    return ll_rows @ weights, grad_rows.sum(dim=-1)[:, :N] * edge_mask


# ---------------------------------------------------------------------------
# The LL kernel: its on-chip tape and its two launchers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LLTape:
    """The per-node tape as the paired LL body reads it (paired.py's
    layout, M ops walked one at a time), on the device of the tapes."""

    post_dst: torch.Tensor  # [B, M] int32: 2M root op, 2M+1 skipped, else
    #                         2m'+j, the child slot of the op m' that reads it
    post_e: torch.Tensor    # [B, M, 2] int32: the two edges (N: identity)
    child: torch.Tensor     # [B, M, 2] int32: child codes (paired.ONES, a
    #                         tip -1 - t, or the op that last wrote the node)
    live_row: torch.Tensor  # [B, M] int32: paired.live_rows
    ll_rows: int            # rows a pattern: their peak over the batch


def _paired_post(post_ops: np.ndarray, root: np.ndarray, T: int,
                 N: int) -> tuple[np.ndarray, np.ndarray]:
    """(post_dst [B, M], child [B, M, 2]) int32: the per-node postorder as
    a paired tape walked one op at a time (see ll_tape), from post_ops and
    root (numpy) for T tips and the dummy node N."""
    _post_tape(post_ops, T, N)  # raises where it is not a per-node tape
    B, M, _ = post_ops.shape
    post_dst = np.full((B, M), 2 * M + 1, dtype=np.int32)
    child = np.full((B, M, 2), paired.ONES, dtype=np.int32)
    for b in range(B):
        r = int(root[b])
        if r < T:
            raise ValueError(f"tree {b}: the root {r} is a tip")
        codes, last = {}, {}
        for m, (u, s1, _e1, s2, _e2) in enumerate(post_ops[b].tolist()):
            if u == N:
                continue  # padded
            for j, s in enumerate((s1, s2)):
                if s < T:
                    codes[m, j] = -1 - s
                elif s in last:
                    codes[m, j] = last[s]
                elif s != N:
                    raise ValueError(f"tree {b}: op {m} reads node {s}, "
                                     "which no earlier op wrote")
            last[u] = m
        if r not in last:
            raise ValueError(f"tree {b}: no op writes the root {r}")
        # Walk back from the root op: every op it reaches stores to the
        # child slot of the op that reads it.
        todo = [last[r]]
        post_dst[b, last[r]] = 2 * M
        while todo:
            m = todo.pop()
            for j in (0, 1):
                c = codes.get((m, j), paired.ONES)
                child[b, m, j] = c
                if c >= 0:
                    if post_dst[b, c] != 2 * M + 1:
                        raise ValueError(f"tree {b}: the output of op {c} "
                                         "is read twice")
                    post_dst[b, c] = 2 * m + j
                    todo.append(c)
    return post_dst, child


def ll_tape(post_ops: np.ndarray, root: np.ndarray, num_taxa: int,
            num_slots: int, device) -> LLTape:
    """The LL body's tape, derived on the host from the scan tape's
    post_ops and root (numpy) for `num_taxa` tips and the dummy node
    `num_slots`, and put on `device`.

    A source is read as the op that last wrote it before the reading op.
    So the trifurcating root's accumulator [u, u, N, x, x] reads the
    earlier op that wrote u, never itself, and its output may take the row
    that read frees (a thread loads both children before it stores).  The
    root op is the last op that writes root[b]; an earlier op that writes
    it stores to a row like any other.  Ops whose outputs do not reach the
    root op (padded ones, dest N, among them) are skipped, as the root's
    partial does not depend on them.  Raises where an op reads an internal
    node that no earlier op wrote (bito_tpu's kernel would read ones
    there), an output is read twice, or the root is a tip or never
    written."""
    post_ops, root = np.asarray(post_ops), np.asarray(root)
    post_dst, child = _paired_post(post_ops, root, num_taxa, num_slots)
    row, rows = paired.live_rows(post_dst, child)
    post_e = post_ops[..., [2, 4]].astype(np.int32)
    return LLTape(*(torch.as_tensor(np.ascontiguousarray(x), device=device)
                    for x in (post_dst, post_e, child, row)), ll_rows=rows)


def pernode_ll_onchip(tape: LLTape, P, tips, pi, props,
                      plan: paired.OnchipPlan) -> torch.Tensor:
    """Launch csrc/paired_ll_onchip.cu on the per-node tape as `plan` says
    (operands checked by the wrapper): per-pattern LL rows [B, S]."""
    B, M = tape.post_dst.shape
    if B != P.shape[0] or tuple(tape.post_e.shape) != (B, M, 2):
        raise ValueError("the on-chip tape does not match P")
    _check_cuda_tensors(dict(post_dst=tape.post_dst, post_e=tape.post_e),
                        {})
    ll_rows = paired.launch_ll_onchip(tape.post_dst, tape, tape.post_e, P,
                                      tips, pi, props, plan)
    pernode_ll_onchip.launches += 1
    return ll_rows


pernode_ll_onchip.launches = 0


def _global_rows(T, N1, C, S, grad):
    """alloc(n, device) of the global bodies' per-node scratch: at 1..8
    categories [n, N1, C*4, S] and the log scales [n, N1, S]; past 8 the
    lane layout of csrc/pernode_lanes.cuh, the internal nodes' rows [n,
    N1-T, Sp, G, 4] (past 32 [n, N1-T, Sp, K, 32, 4]; Sp = S rounded up to
    a block's patterns; paired.global_scratch) and no log scales; with
    `grad` also the up values, laid out as the rows."""
    rows = paired.global_scratch(
        N1 if C <= paired.COMPILED_CATEGORIES else N1 - T, C, S)

    def alloc(n, device):
        buf, ls = rows(n, device)
        return (buf, torch.empty_like(buf), ls) if grad else (buf, ls)
    return alloc


def pernode_ll_global(post_ops, root, P, tips, pi, props) -> torch.Tensor:
    """Launch csrc/pernode_ll.cu, the global body (operands checked by the
    wrapper): per-pattern LL rows [B, S].  Its scratch is allocated here,
    for the batch where it can be, else over slices of trees
    (paired.launch_sliced), each a launch."""
    B, M = post_ops.shape[:2]
    T, S = tips.shape[0], tips.shape[-1]
    N1, C = P.shape[1], P.shape[2]
    ll_rows = torch.empty((B, S), device=P.device, dtype=torch.float32)
    lib = _kernels.library()
    n = paired.launch_sliced(
        "bito_pernode_ll", B, _global_rows(T, N1, C, S, False),
        lambda b0, b1, buf, ls: lib.bito_pernode_ll(
            post_ops[b0:b1].data_ptr(), root[b0:b1].data_ptr(),
            P[b0:b1].data_ptr(), tips.data_ptr(), pi.data_ptr(),
            props.data_ptr(), buf.data_ptr(), ls.data_ptr(),
            ll_rows[b0:b1].data_ptr(), b1 - b0, M, T, N1, C, S,
            paired._stream()),
        P.device)
    pernode_ll_global.launches += n
    timing.count("global_launches", n)
    return ll_rows


pernode_ll_global.launches = 0


# ---------------------------------------------------------------------------
# The A=64 route: the paired A=64 kernels on the per-node tape
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class A64Tape:
    """The per-node tape as the paired A=64 kernels read it (paired.py's
    layout, M ops walked one at a time), on the device of the tapes."""

    post_dst: torch.Tensor  # [B, M] int32, as LLTape's
    tip_slot: torch.Tensor  # [B, T] int32: each tip's pair slot (2M+1
    #                         where no op that runs reads it)
    post_src: torch.Tensor  # [B, M, 2] int32: the node each child is (its
    #                         gradient row; N for the dummy)
    post_e: torch.Tensor    # [B, M, 2] int32: the two edges (N: identity)
    with_pre: bool = False  # derived with pre_ops, as the grad needs


def _same_parents(post_ops: np.ndarray, pre_ops: np.ndarray, N: int):
    """Raise where pre_ops gives a node another parent than post_ops (the
    accumulator's read of its own node aside)."""
    for b in range(post_ops.shape[0]):
        post = {(s, u) for u, s1, _e1, s2, _e2 in post_ops[b].tolist()
                if u != N for s in (s1, s2) if s not in (N, u)}
        pre = {(c, v) for c, v, *_ in pre_ops[b].tolist() if c != N}
        if post != pre:
            raise ValueError(f"tree {b}: pre_ops and post_ops give nodes "
                             "other parents")


def a64_tape(post_ops: np.ndarray, root: np.ndarray, num_taxa: int,
             num_slots: int, device, pre_ops: np.ndarray | None = None
             ) -> A64Tape:
    """The A=64 kernels' tape, derived on the host from the scan tape's
    post_ops and root (numpy), as ll_tape derives its own (the same
    post_dst and edges; each tip at the slot that reads it), for
    `num_taxa` tips and the dummy node `num_slots`, and put on `device`.
    For the grad kernel pass pre_ops: it must be the scan tape's preorder
    (the checks of onchip_tape) of the same tree, each node under the
    parent that post_ops gives it, since the paired walk reads the
    preorder from the postorder; raises otherwise, and where a tip is
    read twice."""
    post_ops, root = np.asarray(post_ops), np.asarray(root)
    T, N = num_taxa, num_slots
    post_dst, child = _paired_post(post_ops, root, T, N)
    if pre_ops is not None:
        pre_ops = np.asarray(pre_ops)
        _group_tape(post_ops, pre_ops, root, T, N)
        _same_parents(post_ops, pre_ops, N)
    B, M = post_dst.shape
    tip_slot = np.full((B, T), 2 * M + 1, dtype=np.int32)
    b, m, j = np.nonzero((child < 0) & (child != ONES))
    t = -1 - child[b, m, j]
    if len(set(zip(b.tolist(), t.tolist()))) < len(t):
        raise ValueError("a tip is read twice: the paired tape holds each "
                         "tip in one slot")
    tip_slot[b, t] = 2 * m + j
    return A64Tape(*(torch.as_tensor(np.ascontiguousarray(x), device=device)
                     for x in (post_dst, tip_slot,
                               post_ops[..., [1, 3]].astype(np.int32),
                               post_ops[..., [2, 4]].astype(np.int32))),
                   with_pre=pre_ops is not None)


def _a64_of(onchip, post_ops, root, pre_ops, T, N1, device) -> A64Tape:
    """`onchip`, or where it is None the tape's a64_tape (a copy of the
    tapes to the host); raises where it is not an A64Tape of the tape, or,
    for the grad (pre_ops given), one derived without pre_ops."""
    if onchip is None:
        onchip = a64_tape(post_ops.cpu().numpy(), root.cpu().numpy(), T,
                          N1 - 1, device,
                          None if pre_ops is None else pre_ops.cpu().numpy())
    if not isinstance(onchip, A64Tape) or tuple(
            onchip.post_dst.shape) != tuple(post_ops.shape[:2]):
        raise ValueError("at 64 states the kernels take the tape's "
                         "pernode.a64_tape")
    if pre_ops is not None and not onchip.with_pre:
        raise ValueError("the grad at 64 states takes the tape's "
                         "pernode.a64_tape derived with pre_ops")
    _check_cuda_tensors(dict(post_dst=onchip.post_dst,
                             tip_slot=onchip.tip_slot,
                             post_src=onchip.post_src,
                             post_e=onchip.post_e), {})
    return onchip


# ---------------------------------------------------------------------------
# The grad kernel's on-chip tape and sizing
# ---------------------------------------------------------------------------

ONES = paired.ONES  # a child code read as all ones: the dummy
PAD = -2            # a padded post op's row, a padded group's parent
ROOT_UP = -1        # the root group's parent: its up value is pi


@dataclass(frozen=True)
class PairedGradTape:
    """The per-node ops as a paired tape, as the paired grad kernel's
    on-chip body reads it (paired.py's layout, M ops walked one at a time;
    the preorder read from the postorder, as the A=64 route does), on the
    device of the tapes."""

    post_dst: torch.Tensor  # [B, M] int32, as LLTape's
    post_src: torch.Tensor  # [B, M, 2] int32: each child's node id, its
    #                         gradient row (N for the dummy)
    post_e: torch.Tensor    # [B, M, 2] int32: the two edges (N: identity)
    onchip: paired.OnchipTape  # child codes, and the rows a pattern


@dataclass(frozen=True)
class OnchipTape:
    """What the on-chip body reads instead of post_ops and pre_ops, on the
    device of the tapes (csrc/pernode_onchip.cuh has the layout), and the
    paired form of the same ops for where that body gets no plan."""

    post: torch.Tensor    # [B, M, 5] int32: (dest row, c0, c1, e0, e1)
    groups: torch.Tensor  # [B, NG, 4] int32: (parent row, 3 child codes)
    zero: torch.Tensor    # [B, Z] int32: nodes whose rows no group writes
    rows: int             # shared-memory rows a pattern: internal nodes
    paired: PairedGradTape  # the same ops as the paired grad body's tape

    @property
    def ints(self) -> int:
        """The ints of one tree's tape, which the body stages."""
        return sum(t[0].numel() for t in (self.post, self.groups, self.zero))


def _codes(nodes: np.ndarray, T: int, N: int) -> np.ndarray:
    """Child codes of node ids: row v - T for internal node v, -1 - t for
    tip t, ONES for the dummy N."""
    return np.where(nodes < T, -1 - nodes,
                    np.where(nodes == N, ONES, nodes - T)).astype(np.int32)


def _post_tape(post_ops: np.ndarray, T: int, N: int) -> np.ndarray:
    """[B, M, 5] int32 (dest row, c0, c1, e0, e1) from the scan tape's
    post_ops (dest, src1, edge1, src2, edge2): a padded op (dest N) has row
    PAD; sources are child codes."""
    dst, s1, e1, s2, e2 = np.moveaxis(np.asarray(post_ops), -1, 0)
    pad = dst == N
    if (~pad & ((dst < T) | (dst > N))).any() or any(
            ((x < 0) | (x > N)).any() for x in (s1, e1, s2, e2)):
        raise ValueError("post_ops writes a tip or reads past the dummy: not "
                         "a per-node postorder tape")
    row = np.where(pad, PAD, dst - T)
    return np.stack([row, _codes(s1, T, N), _codes(s2, T, N), e1, e2],
                    axis=-1).astype(np.int32)


def _tree_groups(pre: np.ndarray, root: int, written: set, T: int, N: int):
    """One tree's groups [(parent row, [child codes])] and the nodes whose
    gradient rows they write.  Raises where the preorder is not the scan
    tape's: a parent's ops apart, a parent whose up value no earlier group
    wrote, a child twice, more than 3 children, or siblings other than the
    group's other children (the dummy through the identity edge aside)."""
    runs = []
    for c, v, s1, e1, s2, e2 in pre.tolist():
        if c == N:
            continue  # padded op
        if runs and runs[-1][0] == v:
            runs[-1][1].append((c, s1, e1, s2, e2))
        else:
            runs.append((v, [(c, s1, e1, s2, e2)]))
    out, parents, children = [], set(), set()
    for v, ops in runs:
        kids = [op[0] for op in ops]
        if not all(0 <= c < N for c in kids):
            raise ValueError(f"parent {v}: children {kids} are not nodes")
        if v in parents or (v != root and v not in children) or v not in (
                written):
            raise ValueError(f"parent {v}: its children are not one group "
                             "after its own parent's")
        if len(kids) > 3 or len(set(kids)) < len(kids) or children & set(
                kids):
            raise ValueError(f"parent {v}: children {kids} are not a group")
        parents.add(v)
        children.update(kids)
        out.append((ROOT_UP if v == root else v - T,
                    [int(x) for x in _codes(np.asarray(kids), T, N)]))
    for v, ops in runs:
        kids = [op[0] for op in ops]
        for c, s1, e1, s2, e2 in ops:
            sibs = sorted(s for s, e in ((s1, e1), (s2, e2))
                          if not (s == N and e == N))
            if sibs != sorted(k for k in kids if k != c) or any(
                    s != e for s, e in ((s1, e1), (s2, e2)) if s != N):
                raise ValueError(f"node {c}: siblings {sibs} are not the "
                                 f"other children of {v}")
            if c >= T and c not in written:
                raise ValueError(f"node {c} has no partial")
    return out, children


def _group_tape(post_ops: np.ndarray, pre_ops: np.ndarray, root: np.ndarray,
               T: int, N: int) -> tuple[np.ndarray, np.ndarray]:
    """(groups [B, NG, 4], zero [B, Z]) int32 from the scan tape's pre_ops
    (dest, parent, sib1, edge1, sib2, edge2): each group is one parent's
    consecutive ops, its parent row (ROOT_UP for the root) and its
    children's codes, padded with ONES; padded groups have parent PAD.
    `zero` lists the nodes 0..N whose gradient rows no group writes, padded
    with -1."""
    B = pre_ops.shape[0]
    trees, zeros = [], []
    for b in range(B):
        written = {int(d) for d in post_ops[b, :, 0] if d != N}
        groups, children = _tree_groups(pre_ops[b], int(root[b]), written, T,
                                        N)
        trees.append(groups)
        zeros.append(sorted(set(range(N + 1)) - children))
    NG = max(1, max(len(t) for t in trees))
    Z = max(len(z) for z in zeros)
    groups = np.full((B, NG, 4), ONES, dtype=np.int32)
    groups[:, :, 0] = PAD
    zero = np.full((B, Z), -1, dtype=np.int32)
    for b, (tree, z) in enumerate(zip(trees, zeros)):
        for k, (par, kids) in enumerate(tree):
            groups[b, k, 0] = par
            groups[b, k, 1:1 + len(kids)] = kids
        zero[b, :len(z)] = z
    return groups, zero


def paired_grad_tape(post_ops: np.ndarray, pre_ops: np.ndarray,
                     root: np.ndarray, num_taxa: int, num_slots: int,
                     device) -> PairedGradTape:
    """The paired grad body's tape, derived on the host from the scan
    tape's post_ops, pre_ops and root (numpy), as ll_tape derives its own
    (the same post_dst, child codes and edges), with gradient rows by node
    id, and put on `device`.  pre_ops must give each node the parent that
    post_ops gives it (the paired walk reads the preorder from the
    postorder); raises otherwise."""
    post_ops, pre_ops = np.asarray(post_ops), np.asarray(pre_ops)
    post_dst, child = _paired_post(post_ops, np.asarray(root), num_taxa,
                                   num_slots)
    _same_parents(post_ops, pre_ops, num_slots)
    row, ll_rows = paired.live_rows(post_dst, child)
    ints = [torch.as_tensor(np.ascontiguousarray(x), device=device)
            for x in (post_dst, post_ops[..., [1, 3]].astype(np.int32),
                      post_ops[..., [2, 4]].astype(np.int32), child, row)]
    return PairedGradTape(*ints[:3], onchip=paired.OnchipTape(
        child=ints[3], live_row=ints[4], ll_rows=ll_rows,
        grad_rows=paired.grad_rows_needed(post_dst)))


def onchip_tape(post_ops: np.ndarray, pre_ops: np.ndarray, root: np.ndarray,
                num_taxa: int, num_slots: int, device) -> OnchipTape:
    """The on-chip body's tape, derived on the host from the scan tape's
    post_ops, pre_ops and root (numpy) for `num_taxa` tips and the dummy
    node `num_slots`, and put on `device`, with the same ops' paired form
    (paired_grad_tape)."""
    T, N = num_taxa, num_slots
    post = _post_tape(post_ops, T, N)
    groups, zero = _group_tape(post_ops, pre_ops, root, T, N)
    stored = post[..., 0][post[..., 0] != PAD]
    rows = int(stored.max()) + 1 if stored.size else 1
    return OnchipTape(*(torch.as_tensor(x, device=device)
                        for x in (post, groups, zero)), rows=rows,
                      paired=paired_grad_tape(post_ops, pre_ops, root, T, N,
                                              device))


# The on-chip body is the faster where a block holds at least MIN_WARPS
# warps of patterns, below that the global body (pernode_grad.cu); set from
# times on an H100 (chip_smoke.py phase 4, 27-400 taxa, GTR+Gamma4,
# PERF.md): 1.12x faster at 4 warps (76 taxa), 0.88x at 3 (84 taxa).  A
# block takes one SM's shared memory, so its warps are the SM's.
MIN_WARPS = 4


def smem_bytes(rows: int, tape_ints: int, N1: int, C: int, cols: int) -> int:
    """Dynamic shared memory of one block, laid out as the kernel lays it
    out (csrc/pernode_onchip.cuh smem_bytes): `rows` rows of a 16-byte lane
    slice per pattern and category lane, the tree's P and dP, then the
    tape."""
    G = paired.lanes(C)
    return rows * cols * G * 16 + 2 * N1 * G * 4 * 16 + paired._rup(
        tape_ints * 4, 16)


def onchip_plan(rows: int, tape_ints: int, N1: int, C: int,
                least: int = MIN_WARPS) -> paired.OnchipPlan | None:
    """How the on-chip body launches, or None where the global body takes
    the tape: a block of as many whole warps of patterns as fit in
    paired.SMEM_BYTES, up to paired.MAX_THREADS threads, and at least
    `least` warps (1 asks for the body wherever it fits, to measure it).
    None past paired.ONCHIP_CATEGORIES: the body holds a category a lane
    (`paired_plan` takes the tape there)."""
    paired.check_categories(C)
    if C > paired.ONCHIP_CATEGORIES:
        return None
    G = paired.lanes(C)
    per_warp = paired.WARP // G  # patterns a warp
    fixed = smem_bytes(rows, tape_ints, N1, C, 0)
    warps = 0 if fixed >= paired.SMEM_BYTES else min(
        (paired.SMEM_BYTES - fixed)
        // (smem_bytes(rows, tape_ints, N1, C, per_warp) - fixed),
        paired.MAX_THREADS // paired.WARP)
    if warps < least:
        return None
    cols = warps * per_warp
    return paired.OnchipPlan(G, cols, False,
                             smem_bytes(rows, tape_ints, N1, C, cols))


def paired_plan(tape: PairedGradTape, N1: int,
                C: int) -> paired.OnchipPlan | None:
    """How the paired grad kernel's on-chip body launches on the per-node
    ops' paired tape `tape` (OnchipTape.paired), or None where the global
    body takes them: the paired plan (paired.onchip_plan("grad", ...), K
    categories a lane past 32) where a block holds MIN_WARPS warps (as
    this module's own body: at Gamma4 on the H100 the paired body took
    4.1877 / 5.0255 ms at 5 / 4 warps (84 / 96 taxa) against the global
    body's 5.0155 / 5.9500, and 8.5582 / 9.6180 at 3 (128 / 144 taxa)
    against 8.3137 / 9.2305; chip_smoke.py phase 4, PERF.md), or past 32
    paired.MIN_WARPS (the per-node wide kernel is slower than the paired
    and chunked ones).  The wrapper asks for it
    where `onchip_plan` gives none."""
    return paired.onchip_plan("grad", tape.onchip.grad_rows,
                              tape.post_dst.shape[1], N1, C,
                              min_warps=MIN_WARPS,
                              k_min_warps=paired.MIN_WARPS)


# ---------------------------------------------------------------------------
# The grad kernel's three launchers
# ---------------------------------------------------------------------------

def check_onchip(onchip: OnchipTape, B: int, tips, P, dP) -> None:
    """Raise where the on-chip body cannot take the tape or the operands."""
    if onchip.post.shape[0] != B or onchip.groups.shape[0] != B or (
            onchip.zero.shape[0] != B):
        raise ValueError("the on-chip tape does not match post_ops")
    if tips.numel() >= 2**31:  # the kernel indexes tips with 32-bit offsets
        raise ValueError(f"tips has {tips.numel()} entries, the on-chip "
                         "body takes fewer than 2**31")
    _check_cuda_tensors(dict(post=onchip.post, groups=onchip.groups,
                             zero=onchip.zero), {})
    for name, t in (("P", P), ("dP", dP)):  # cp.async copies 16-byte rows
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def pernode_grad_onchip(onchip: OnchipTape, root, P, dP, tips, pi, props,
                        weights, plan: paired.OnchipPlan):
    """Launch csrc/pernode_grad_onchip.cu as `plan` says (operands checked
    by the wrapper): (LL rows [B, S], weighted gradient rows [B, N1, S],
    every row written)."""
    B, M = P.shape[0], onchip.post.shape[1]
    check_onchip(onchip, B, tips, P, dP)
    T, S = tips.shape[0], tips.shape[-1]
    N1, C = P.shape[1], P.shape[2]
    kw = dict(device=P.device, dtype=torch.float32)
    ll_rows = torch.empty((B, S), **kw)
    grad_rows = torch.empty((B, N1, S), **kw)
    with torch.cuda.device(P.device):
        rc = _kernels.library().bito_pernode_grad_onchip(
            onchip.post.data_ptr(), onchip.groups.data_ptr(),
            onchip.zero.data_ptr(), root.data_ptr(), P.data_ptr(),
            dP.data_ptr(), tips.data_ptr(), pi.data_ptr(), props.data_ptr(),
            weights.data_ptr(), ll_rows.data_ptr(), grad_rows.data_ptr(),
            B, M, onchip.groups.shape[1], onchip.zero.shape[1], T, N1, C, S,
            onchip.rows, plan.cols, paired._stream())
    _kernels.check(rc, "bito_pernode_grad_onchip")
    pernode_grad_onchip.launches += 1
    return ll_rows, grad_rows


pernode_grad_onchip.launches = 0


def pernode_grad_paired(tape: PairedGradTape, P, dP, tips, pi, props,
                        weights, plan: paired.OnchipPlan):
    """Launch csrc/paired_grad_onchip.cu, the paired grad kernel's on-chip
    body, on the per-node ops' paired tape as `plan` (paired_plan) says
    (operands checked by the wrapper): (LL rows [B, S], weighted gradient
    rows [B, N1, S] by node id; rows that no op writes, the root's among
    them, are not written: paired.finish_rows masks them)."""
    B, M = tape.post_dst.shape
    if B != P.shape[0] or tuple(tape.post_e.shape) != (B, M, 2) or tuple(
            tape.post_src.shape) != (B, M, 2):
        raise ValueError("the paired tape does not match P")
    _check_cuda_tensors(dict(post_dst=tape.post_dst, post_src=tape.post_src,
                             post_e=tape.post_e), {})
    rows = paired.launch_grad_onchip(tape.post_dst, tape.onchip,
                                     tape.post_src, tape.post_e, P, dP, tips,
                                     pi, props, weights, plan)
    pernode_grad_paired.launches += 1
    return rows


pernode_grad_paired.launches = 0


def pernode_grad_global(post_ops, pre_ops, root, P, dP, tips, pi, props,
                        weights):
    """Launch csrc/pernode_grad.cu, the global body (operands checked by
    the wrapper): (LL rows [B, S], weighted gradient rows [B, N1, S], zero
    where no op writes), with the scratch and the slices of
    pernode_ll_global (and the up values)."""
    B, M = post_ops.shape[:2]
    Mp = pre_ops.shape[1]
    T, S = tips.shape[0], tips.shape[-1]
    N1, C = P.shape[1], P.shape[2]
    kw = dict(device=P.device, dtype=torch.float32)
    ll_rows = torch.empty((B, S), **kw)
    grad_rows = torch.zeros((B, N1, S), **kw)
    lib = _kernels.library()
    n = paired.launch_sliced(
        "bito_pernode_grad", B, _global_rows(T, N1, C, S, True),
        lambda b0, b1, buf, up, ls: lib.bito_pernode_grad(
            post_ops[b0:b1].data_ptr(), pre_ops[b0:b1].data_ptr(),
            root[b0:b1].data_ptr(), P[b0:b1].data_ptr(),
            dP[b0:b1].data_ptr(), tips.data_ptr(), pi.data_ptr(),
            props.data_ptr(), weights.data_ptr(), buf.data_ptr(),
            up.data_ptr(), ls.data_ptr(), ll_rows[b0:b1].data_ptr(),
            grad_rows[b0:b1].data_ptr(), b1 - b0, M, Mp, T, N1, C, S,
            paired._stream()),
        P.device)
    pernode_grad_global.launches += n
    timing.count("global_launches", n)
    return ll_rows, grad_rows


pernode_grad_global.launches = 0
