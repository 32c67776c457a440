"""Chunked level-synchronous tapes and their two tree-likelihood kernels.

Counterpart of bito_tpu.treelike.pallas_chunked, the engine's
kernel="chunked" route.  The postorder ops of each tree are list-scheduled
into chunks of up to W ops, none of which reads what another op of its
chunk writes, so the W ops of a chunk can run side by side and a tree's
dependent chain shrinks from M ops to Mc chunks.  Op at grid position
g = c*W + k reads pair slots (2g, 2g+1); slot 2*Mc*W is the root and
2*Mc*W + 1 the trash slot of padded positions.  `build_chunked_encoding`
is a numpy copy of bito_tpu's, pinned equal to it by
tests/test_torch_chunked.py; it raises ValueError where the original
asserts.

Each kernel has two bodies on the card, as the paired kernels do
(paired.py):
  - the on-chip body: a block takes one tree and a tile of patterns and
    keeps the tile's partials in shared memory, through the child tape of
    `onchip_tape`.  The grad kernel's (csrc/chunked_grad_onchip.cu) keeps
    one row per grid op and gives a pattern the plan's op lanes (W where a
    warp holds W x G threads, else one: at G = 32 the chunk's ops run in
    turn) x one lane per rate category.  The LL kernel's is the paired LL body
    (csrc/paired_ll_onchip.cu) walking the chunked tape one grid op at a
    time, with rows by liveness: the chunked schedule is a postorder, and
    on the card the chunk's lanes buy nothing over a lane per category
    (the on-chip bodies are bound by instruction issue, not by the chain
    of dependent ops);
  - the global body (csrc/chunked_ll.cu, csrc/chunked_grad.cu): W threads
    per (tree, pattern), the pair slots in device memory; past 8 rate
    categories the paired kernels' lane bodies (csrc/paired_lanes.cuh)
    walking the chunked tape one grid op at a time, children by child
    code.  It takes any tree; the wrappers launch it where no on-chip
    body gets a plan, decided from the tape before the launch; its
    launchers split the batch over slices of trees where its scratch
    would not fit (paired.launch_sliced).
The grad kernel has a third body: the paired grad kernel's on-chip body
(csrc/paired_grad_onchip.cu, `chunked_grad_paired`) walking the chunked
tape one grid op at a time, with a row per grid op and gradient rows by
node (`node_src`), where the chunked body gets no plan (`onchip_plan`
returns None: at 17-32 categories, where the tree's P and dP staged at
once leave it too few warps, and past 32) and `paired_plan` gives one.
The kernels take any count of rate categories: 1-8 compiled one count at
a time, 9-32 on 16 or 32 lanes a pattern with the count read at run
time (every body), past 32 on 32 lanes of paired.lane_categories(C)
categories each (the on-chip LL body and the paired grad body up to
paired.ONCHIP_MAX_CATEGORIES, the global bodies at any count).

Beside them, in this module:
  - the plain torch version of each kernel (`*_ref`), which runs one
    chunk's W ops as one batched step, is what the CPU runs and what the
    kernels are checked against;
  - the public wrappers (`chunked_log_likelihoods`,
    `chunked_ll_and_gradients`): a CPU tensor goes to the plain version; a
    CUDA tensor goes to a body, and the call raises if the body cannot
    take the inputs or fails to launch;
  - each body's launcher (`chunked_ll_onchip`, `chunked_ll_global`,
    `chunked_grad_onchip`, `chunked_grad_paired`, `chunked_grad_global`)
    with its launch count,
    `.launches`, raised by one where it launches its kernel and nowhere
    else;
  - the pattern-sharded wrappers (`chunked_log_likelihoods_sharded`,
    `chunked_ll_and_gradients_sharded`), as paired.py's.

Operands: post_dst [B, MW], tip_slot [B, T], post_e [B, MW, 2] and
node_row [B, N] int32 tapes (MW = Mc*W); P, dP [B, N+1, C, 4, 4]; tips
[T, 4, S]; pi [4]; props [C]; weights [S]; edge_mask [B, N].  Gradient
rows are indexed by grid position and mapped to nodes through node_row,
whose default row 2*MW no op writes.

The chunk width is the module constant W: the engine builds its tapes at
W, and the plain versions and kernels run a tape W grid positions at a
time.  A tape built at a multiple of W (bito_tpu's W=4, say) runs as it
is, since W consecutive ops of an independent chunk are independent too,
and each op's arithmetic does not depend on the chunking.  bito_tpu chose
W so that one chunk filled a 128-wide MXU contraction (2*W*CA = 128, W=4
at CA=16); on the card W is a number of op lanes per block.  W=2: the
chunk count is bound by tree depth, and at the DS1 shape (27 taxa) W=2, 4
and 8 all give Mc=14 chunks for 26 ops, while the scratch grows with
2*Mc*W + 2 slots (58, 114, 226).  W=2 keeps the shortest chain at the
least scratch: 64 patterns per 128-thread block of the global bodies, and
W*G threads a pattern (8 at G=4) in the on-chip body's warps.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..dist import mesh
from ..utils import timing
from . import _kernels, paired
from .paired import (_check_cuda_operands, _check_cuda_tensors, _check_shapes,
                     _rescale, _root_rows)

W = 2  # ops per chunk (the kernels' op lanes); see the module docstring


@dataclass
class ChunkedEncoding:
    """Host-side chunked-schedule tapes derived from a TreeBatchEncoding."""

    num_taxa: int
    num_slots: int          # original per-node slot count
    W: int                  # chunk width (ops per chunk)
    Mc: int                 # number of chunks (max over trees)
    post_dst: np.ndarray    # [B, Mc*W] destination pair-slot per grid op
    post_e: np.ndarray      # [B, Mc*W, 2] edge indices per child
    tip_slot: np.ndarray    # [B, T] pair-slot of each tip's partial
    node_row: np.ndarray    # [B, num_slots] node id -> gradient grid row
    #   (2g+j of the op that consumes the node with its real edge;
    #    2*Mc*W, a padded zero row, for nodes with no real edge)

    @property
    def MW(self) -> int:
        return self.Mc * self.W

    @property
    def root_slot(self) -> int:
        return 2 * self.MW

    @property
    def trash_slot(self) -> int:
        return 2 * self.MW + 1

    @property
    def n_pair_slots(self) -> int:
        return 2 * self.MW + 2


def _schedule_tree(ops, T: int, DUMMY: int, W: int):
    """Greedy height-priority list scheduling of one tree's postorder ops
    into independence chunks of width <= W.

    ops: list of (u, s1, e1, s2, e2).  Returns a list of chunks, each a
    list of op indices, such that no op's source is produced by an op in
    the same chunk."""
    n = len(ops)
    producer = {}
    deps = []
    for m, (u, s1, e1, s2, e2) in enumerate(ops):
        d = []
        for s in (s1, s2):
            if s in producer:
                # internal node or accumulator value produced by an op
                d.append(producer[s])
            elif not (s == DUMMY or s < T):
                raise ValueError(f"op {m} reads node {s} before any op "
                                 "produced it")
        deps.append(d)
        producer[u] = m
    # height = longest path to the final op (critical-path priority)
    consumers = [[] for _ in range(n)]
    for m, d in enumerate(deps):
        for p in d:
            consumers[p].append(m)
    height = [0] * n
    for m in range(n - 1, -1, -1):
        for c in consumers[m]:
            height[m] = max(height[m], height[c] + 1)
    done = [False] * n
    chunks = []
    remaining = n
    while remaining:
        # done[] reflects only previous chunks here, so intra-chunk
        # dependencies can never be selected.
        ready = [m for m in range(n)
                 if not done[m] and all(done[p] for p in deps[m])]
        ready.sort(key=lambda m: (-height[m], m))
        take = ready[:W]
        if not take:
            raise ValueError("scheduler stall (cyclic tape?)")
        for m in take:
            done[m] = True
        remaining -= len(take)
        chunks.append(take)
    return chunks


def build_chunked_encoding(enc, W: int) -> ChunkedEncoding:
    """Derive chunked-schedule tapes from a TreeBatchEncoding (pure host
    work, cached by the engine per encoding)."""
    B, M0, _ = enc.post_ops.shape
    T = enc.num_taxa
    DUMMY = enc.num_slots

    per_tree = []
    Mc = 1
    for b in range(B):
        ops = []
        for m in range(M0):
            row = tuple(int(x) for x in enc.post_ops[b, m])
            if row[0] == DUMMY:
                break
            ops.append(row)
        chunks = _schedule_tree(ops, T, DUMMY, W)
        per_tree.append((ops, chunks))
        Mc = max(Mc, len(chunks))

    MW = Mc * W
    TRASH = 2 * MW + 1
    ROOT = 2 * MW
    GTRASH = 2 * MW  # padded zero gradient row

    post_dst = np.full((B, MW), TRASH, dtype=np.int32)
    post_e = np.full((B, MW, 2), DUMMY, dtype=np.int32)
    tip_slot = np.full((B, T), TRASH, dtype=np.int32)
    node_row = np.full((B, enc.num_slots), GTRASH, dtype=np.int32)

    for b, (ops, chunks) in enumerate(per_tree):
        producer = {}
        for c, chunk in enumerate(chunks):
            for i, m in enumerate(chunk):
                g = c * W + i
                u, s1, e1, s2, e2 = ops[m]
                for j, (s, e) in enumerate(((s1, e1), (s2, e2))):
                    post_e[b, g, j] = e
                    if s == DUMMY:
                        continue
                    slot = 2 * g + j
                    if s in producer:
                        post_dst[b, producer[s]] = slot
                    elif s < T:
                        tip_slot[b, s] = slot
                    else:
                        raise ValueError(f"tree {b}: op {m} reads node {s} "
                                         "before any op produced it")
                    if e != enc.identity_edge:
                        # the op consuming node s with its real edge owns
                        # s's gradient row (each non-root node is consumed
                        # with its real edge exactly once)
                        node_row[b, s] = 2 * g + j
                producer[u] = g
        root = int(enc.root[b])
        if root not in producer:
            raise ValueError(f"tree {b}: no op produces the root {root}")
        post_dst[b, producer[root]] = ROOT

    return ChunkedEncoding(
        num_taxa=T, num_slots=enc.num_slots, W=W, Mc=Mc,
        post_dst=post_dst, post_e=post_e, tip_slot=tip_slot,
        node_row=node_row,
    )


# ---------------------------------------------------------------------------
# The on-chip bodies' tape and sizing
# ---------------------------------------------------------------------------

def onchip_tape(post_dst: np.ndarray, tip_slot: np.ndarray,
                device) -> paired.OnchipTape:
    """The on-chip bodies' tape, derived on the host from a
    ChunkedEncoding's `post_dst` and `tip_slot` and put on `device`.  The
    paired layout's child tape and rows apply as they are: grid op g reads
    pair slots (2g, 2g+1), the root is slot 2MW and the trash slot 2MW+1.
    The LL rows (`ll_rows`, `live_row`) are assigned by liveness in grid
    order, for the LL body, which walks the grid one op at a time; they
    would be wrong for a body that ran a chunk's W ops side by side (one
    op could store over a row that another of its chunk still reads).  The
    grad body keeps one row per grid op (`grad_rows`).  The engine builds
    the tape with the chunked tapes, once per topology set.  It carries
    no checkpointed schedule: the chunked grad kernel has no such body."""
    child = paired.child_tape(post_dst, tip_slot)
    row, ll_rows = paired.live_rows(post_dst, child)
    return paired.OnchipTape(
        child=torch.as_tensor(child, device=device),
        live_row=torch.as_tensor(row, device=device), ll_rows=ll_rows,
        grad_rows=paired.grad_rows_needed(post_dst))


# The LL body's staging on the chunked tape, set from times on an H100
# (chip_smoke.py phase 4, 27-400 taxa, GTR+Gamma4, PERF.md): the tree's
# matrices staged where a block keeps LL_FULL_WARPS warps, else the ring
# where it holds more.  The chunked schedule keeps more outputs live than
# the paired order, so the ring's warps fall with the staged ones: at 160
# and 192 taxa the staged body at 7 and 6 warps was 8% and 7% faster than
# the ring at 12 and 10 (paired.FULL_WARPS, 8, took the ring there); at
# 256 taxa the staged body's 3 warps lost to the ring's 8 by 1.5x.  The
# global body (chunked_ll.cu) below paired.MIN_WARPS, as on the paired
# tape: the on-chip body was the faster at every size measured.
LL_FULL_WARPS = 6


def ll_plan(rows: int, MW: int, N1: int, C: int) -> paired.OnchipPlan | None:
    """How the on-chip LL body launches on a chunked tape of `rows` live
    rows, or None where the global body takes it."""
    return paired.onchip_plan("ll", rows, MW, N1, C,
                              full_warps=LL_FULL_WARPS)


# The on-chip body is the faster where a block holds at least MIN_WARPS
# warps of patterns, below that the global body (chunked_grad.cu); set from
# times on an H100 (chip_smoke.py phase 4, 64-400 taxa, PERF.md): at Gamma4
# 1.36x faster at 3 warps (128 taxa), 0.89x at 2 (144 taxa).  A block takes
# one SM's shared memory, so its warps are the SM's.
MIN_WARPS = 3


def smem_bytes(rows: int, MW: int, N1: int, C: int, cols: int) -> int:
    """Dynamic shared memory of one block of the on-chip body, laid out as
    the kernel lays it out (csrc/chunked_grad_onchip.cu, through
    `onchip::smem_bytes`): `rows` rows of a 16-byte lane slice per pattern
    and category lane, the tree's P and dP, then the tape (5 ints a grid
    position)."""
    G = paired.lanes(C)
    return rows * cols * G * 16 + 2 * N1 * G * 4 * 16 + paired._rup(
        5 * MW * 4, 16)


def op_lanes(C: int) -> int:
    """Op lanes a pattern of the on-chip grad body: W where a warp holds W
    x G threads, else WARP // G (one at G = 32, a pattern a warp, where
    the chunk's ops run in turn on its lanes)."""
    return min(W, paired.WARP // paired.lanes(C))


def onchip_plan(rows: int, MW: int, N1: int, C: int,
                least: int = MIN_WARPS) -> paired.OnchipPlan | None:
    """How the on-chip body launches, or None where the global body takes
    the tape: a block of as many whole warps of patterns as fit in
    paired.SMEM_BYTES, up to paired.MAX_THREADS threads, and at least
    `least` warps (1 asks for the body wherever it fits, to measure it).
    A pattern takes op_lanes(C) op lanes x G category lanes of one warp
    (the plan's `op_lanes`).  None past paired.ONCHIP_CATEGORIES: the
    body holds a category a lane (`paired_plan` takes the tape there)."""
    paired.check_categories(C)
    if C > paired.ONCHIP_CATEGORIES:
        return None
    G, L = paired.lanes(C), op_lanes(C)
    per_warp = paired.WARP // (L * G)  # patterns a warp
    fixed = smem_bytes(0, MW, N1, C, 0)
    warps = 0 if fixed >= paired.SMEM_BYTES else min(
        (paired.SMEM_BYTES - fixed)
        // (smem_bytes(rows, MW, N1, C, per_warp) - fixed),
        paired.MAX_THREADS // paired.WARP)
    if warps < least:
        return None
    cols = warps * per_warp
    return paired.OnchipPlan(G, cols, False,
                             smem_bytes(rows, MW, N1, C, cols), L)


def paired_plan(rows: int, MW: int, N1: int,
                C: int) -> paired.OnchipPlan | None:
    """How the paired grad kernel's on-chip body launches on a chunked
    tape of `rows` grad rows (a row per grid op), walked one grid op at a
    time, or None where the global body takes it: the paired plan
    (paired.onchip_plan("grad", ...), K categories a lane past 32).  The
    wrapper asks for it where `onchip_plan` gives none."""
    return paired.onchip_plan("grad", rows, MW, N1, C)


# ---------------------------------------------------------------------------
# Plain torch versions
# ---------------------------------------------------------------------------

def _chunk_edges(M, b, e_all, c):
    """The 2W matrices of chunk c's ops, [B, W, 2, C, A, A]."""
    return M[b[:, None, None], e_all[:, c * W:(c + 1) * W]]


def _postorder(post_dst, tip_slot, post_e, P, tips):
    """Run the chunked postorder, one chunk's W ops per step.  Returns the
    slot buffer [B, 2MW+2, C, A, S] and log scales [B, 2MW+2, S].  Slots
    that no tip or op writes stay all ones with log scale 0 (a child whose
    source is the dummy node reads them); padded positions write the trash
    slot, which nothing reads."""
    B, MW = post_dst.shape
    T = tip_slot.shape[1]
    C, A = P.shape[2], P.shape[3]
    S = tips.shape[-1]
    kw = dict(device=P.device, dtype=P.dtype)
    b = torch.arange(B, device=P.device)
    buf = torch.ones((B, 2 * MW + 2, C, A, S), **kw)
    ls = torch.zeros((B, 2 * MW + 2, S), **kw)
    buf[b[:, None], tip_slot.long()] = tips.to(P.dtype)[None, :, None].expand(
        B, T, C, A, S)
    dst_all, e_all = post_dst.long(), post_e.long()
    for c in range(MW // W):
        pairs = slice(2 * c * W, 2 * (c + 1) * W)
        ev = _chunk_edges(P, b, e_all, c) @ buf[:, pairs].unflatten(
            1, (W, 2))                                      # [B,W,2,C,A,S]
        prod, mx = _rescale(ev[:, :, 0] * ev[:, :, 1], (2, 3))
        dst = dst_all[:, c * W:(c + 1) * W]
        new_ls = (ls[:, pairs].unflatten(1, (W, 2)).sum(2)
                  + torch.log(mx[:, :, 0, 0]))
        buf[b[:, None], dst] = prod
        ls[b[:, None], dst] = new_ls
    return buf, ls


def chunked_log_likelihoods_ref(post_dst, tip_slot, post_e, P, tips, pi,
                                props, weights):
    """Plain torch version of the LL kernel: per-tree log likelihoods [B]."""
    buf, ls = _postorder(post_dst, tip_slot, post_e, P, tips)
    root = 2 * post_dst.shape[1]
    return _root_rows(buf, ls, root, pi, props) @ weights.to(P.dtype)


def chunked_ll_and_gradients_ref(post_dst, tip_slot, post_e, node_row,
                                 edge_mask, P, dP, tips, pi, props, weights):
    """Plain torch version of the LL+gradient kernel: (ll [B], branch
    gradients [B, N] in node order)."""
    B, MW = post_dst.shape
    C, A = P.shape[2], P.shape[3]
    S = tips.shape[-1]
    dtype = P.dtype
    w, pi, props = weights.to(dtype), pi.to(dtype), props.to(dtype)
    buf, ls = _postorder(post_dst, tip_slot, post_e, P, tips)
    root = 2 * MW
    ll = _root_rows(buf, ls, root, pi, props) @ w
    # Seed the outside pass: the root's outside value is pi.
    buf[:, root] = pi[None, None, :, None].expand(B, C, A, S)
    b = torch.arange(B, device=P.device)
    rows = torch.zeros((B, 2 * MW + 1, S), device=P.device, dtype=dtype)
    dst_all, e_all = post_dst.long(), post_e.long()
    for c in range(MW // W - 1, -1, -1):
        pairs = slice(2 * c * W, 2 * (c + 1) * W)
        P2 = _chunk_edges(P, b, e_all, c)                # [B,W,2,C,A,A]
        pair = buf[:, pairs].unflatten(1, (W, 2))           # [B,W,2,C,A,S]
        ev, dv = P2 @ pair, _chunk_edges(dP, b, e_all, c) @ pair
        up = buf[b[:, None], dst_all[:, c * W:(c + 1) * W]]  # [B,W,C,A,S]
        # o_j = up * ev_sibling, the pair rescaled by one common max.
        o, _ = _rescale(up[:, :, None] * ev.flip(2), (2, 3, 4))
        den = torch.einsum("c,bwjcas->bwjs", props, o * ev)
        num = torch.einsum("c,bwjcas->bwjs", props, o * dv)
        den = torch.where(den > 0, den, torch.ones_like(den))
        rows[:, pairs] = (w * num / den).flatten(1, 2)
        buf[:, pairs] = (P2.transpose(-1, -2) @ o).flatten(1, 2)
    grads = rows.sum(dim=-1).gather(1, node_row.long())
    return ll, grads * edge_mask.to(dtype)


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------

def _check_chunked(post_dst, tip_slot, post_e, P, tips, pi, props, weights):
    B, MW, T, N1, C, A, S = _check_shapes(post_dst, tip_slot, post_e, P,
                                          tips, pi, props, weights)
    if MW % W:
        raise ValueError(f"the tape's {MW} grid positions are not chunks of "
                         f"W={W}")
    if 2 * MW + 2 > 48 * 1024:
        raise ValueError(f"{2 * MW + 2} slots exceed the kernels' "
                         "shared-memory slot mask")
    return B, MW, T, N1, C, A, S


def chunked_log_likelihoods(post_dst, tip_slot, post_e, P, tips, pi, props,
                            weights, *,
                            onchip: paired.OnchipTape | None = None
                            ) -> torch.Tensor:
    """Per-tree log likelihoods [B] over the chunked tape.

    On the card it launches the on-chip body where `ll_plan` gives a
    plan, else the global body.  `onchip` is the tape's `onchip_tape`;
    where it is not given the wrapper derives it (a copy of the tapes to
    the host).  The CPU runs the plain version, which needs none."""
    if paired.on_cpu(P):
        with timing.span("launch"):
            return chunked_log_likelihoods_ref(post_dst, tip_slot, post_e, P,
                                               tips, pi, props, weights)
    with timing.span("launch"):
        B, MW, T, N1, C, A, S = _check_chunked(post_dst, tip_slot, post_e, P,
                                               tips, pi, props, weights)
        _check_cuda_operands(
            dict(post_dst=post_dst, tip_slot=tip_slot, post_e=post_e),
            dict(P=P, tips=tips, pi=pi, props=props, weights=weights), C, A)
        if onchip is None:
            with timing.span("host_sync"):
                timing.count("host_syncs", 2)
                dst, tip = post_dst.cpu().numpy(), tip_slot.cpu().numpy()
            onchip = onchip_tape(dst, tip, P.device)
        if tuple(onchip.live_row.shape) != (B, MW):
            raise ValueError("the on-chip tape does not match post_dst")
        plan = ll_plan(onchip.ll_rows, MW, N1, C)
        if plan is None:
            ll_rows = chunked_ll_global(post_dst, tip_slot, post_e, P, tips,
                                        pi, props, child=onchip.child)
        else:
            ll_rows = chunked_ll_onchip(post_dst, onchip, post_e, P, tips, pi,
                                        props, plan)
    with timing.span("finish"):
        return ll_rows @ weights


def chunked_ll_onchip(post_dst, onchip, post_e, P, tips, pi, props,
                      plan: paired.OnchipPlan) -> torch.Tensor:
    """Launch csrc/paired_ll_onchip.cu on the chunked tape, one grid op at
    a time, as `plan` says (operands checked by the wrapper): per-pattern
    LL rows [B, S]."""
    ll_rows = paired.launch_ll_onchip(post_dst, onchip, post_e, P, tips, pi,
                                      props, plan)
    chunked_ll_onchip.launches += 1
    return ll_rows


chunked_ll_onchip.launches = 0


def _global_scratch(post_dst, child, C, S):
    """alloc(n, device) of the global bodies' scratch
    (paired.global_scratch): at 1..8 categories the slots [n, 2MW+2,
    C*4, S] and their log scales [n, 2MW+2, S]; past 8 the lane layout
    over 2MW+3 slots, whose walk reads the children by code, so `child`
    (the on-chip tape's, onchip_tape(...).child) is required and checked
    there."""
    B, MW = post_dst.shape
    if C > paired.COMPILED_CATEGORIES:
        if child is None or tuple(child.shape) != (B, MW, 2):
            raise ValueError("the global body past 8 rate categories needs "
                             "the tape's child codes: pass child="
                             "chunked.onchip_tape(...).child")
        _check_cuda_tensors(dict(child=child), {})
        return paired.global_scratch(2 * MW + 3, C, S)
    return paired.global_scratch(2 * MW + 2, C, S)


def _child_ptr(child, b0, b1):
    return None if child is None else child[b0:b1].data_ptr()


def chunked_ll_global(post_dst, tip_slot, post_e, P, tips, pi, props,
                      child=None):
    """Launch csrc/chunked_ll.cu, the global body (operands checked by the
    wrapper): per-pattern LL rows [B, S].  Past 8 categories it needs
    `child`, the tape's child codes.  Its scratch is allocated here, for
    the batch where it can be, else over slices of trees
    (paired.launch_sliced), each a launch."""
    B, MW = post_dst.shape
    T, S = tips.shape[0], tips.shape[-1]
    N1, C = P.shape[1], P.shape[2]
    alloc = _global_scratch(post_dst, child, C, S)
    ll_rows = torch.empty((B, S), device=P.device, dtype=torch.float32)
    lib = _kernels.library()
    n = paired.launch_sliced(
        "bito_chunked_ll", B, alloc,
        lambda b0, b1, buf, ls: lib.bito_chunked_ll(
            post_dst[b0:b1].data_ptr(), tip_slot[b0:b1].data_ptr(),
            _child_ptr(child, b0, b1), post_e[b0:b1].data_ptr(),
            P[b0:b1].data_ptr(), tips.data_ptr(), pi.data_ptr(),
            props.data_ptr(), buf.data_ptr(), ls.data_ptr(),
            ll_rows[b0:b1].data_ptr(), b1 - b0, MW, W, T, N1, C, S,
            paired._stream()),
        P.device)
    chunked_ll_global.launches += n
    timing.count("global_launches", n)
    return ll_rows


chunked_ll_global.launches = 0


def chunked_ll_and_gradients(post_dst, tip_slot, post_e, node_row,
                             edge_mask, P, dP, tips, pi, props, weights, *,
                             onchip: paired.OnchipTape | None = None):
    """Per-tree (log likelihood [B], branch gradients [B, N]).

    On the card it launches the chunked on-chip body where `onchip_plan`
    gives a plan, else the paired grad kernel's on-chip body on this tape
    where `paired_plan` gives one, else the global body; `onchip`, the
    tape's `onchip_tape`, is required there.  The CPU runs the plain
    version, which needs none."""
    if paired.on_cpu(P):
        with timing.span("launch"):
            return chunked_ll_and_gradients_ref(
                post_dst, tip_slot, post_e, node_row, edge_mask, P, dP, tips,
                pi, props, weights)
    with timing.span("launch"):
        B, MW, T, N1, C, A, S = _check_chunked(post_dst, tip_slot, post_e, P,
                                               tips, pi, props, weights)
        if tuple(dP.shape) != tuple(P.shape):
            raise ValueError("dP does not match P")
        for name, t in (("node_row", node_row), ("edge_mask", edge_mask)):
            if tuple(t.shape) != (B, N1 - 1):
                raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                                 f"expected {(B, N1 - 1)}")
        _check_cuda_operands(
            dict(post_dst=post_dst, tip_slot=tip_slot, post_e=post_e,
                 node_row=node_row),
            dict(P=P, dP=dP, tips=tips, pi=pi, props=props, weights=weights,
                 edge_mask=edge_mask),
            C, A)
        if onchip is None:
            raise ValueError("the chunked grad kernel needs the tape's "
                             "OnchipTape on the card: pass "
                             "onchip=chunked.onchip_tape(...)")
        by_node = False  # gradient rows by node, not by grid position
        if (plan := onchip_plan(onchip.grad_rows, MW, N1, C)) is not None:
            rows = chunked_grad_onchip(post_dst, onchip, post_e, P, dP, tips,
                                       pi, props, weights, plan)
        elif (plan := paired_plan(onchip.grad_rows, MW, N1, C)) is not None:
            rows = chunked_grad_paired(post_dst, onchip, post_e, node_row, P,
                                       dP, tips, pi, props, weights, plan)
            by_node = True
        else:
            rows = chunked_grad_global(post_dst, tip_slot, post_e, P, dP,
                                       tips, pi, props, weights,
                                       child=onchip.child)
    with timing.span("finish"):
        if by_node:
            return paired.finish_rows(*rows, edge_mask, weights)
        return finish_rows(*rows, node_row, edge_mask, weights)


def chunked_log_likelihoods_sharded(group, post_dst, tip_slot, post_e, P,
                                    tips, pi, props, weights, *,
                                    onchip: paired.OnchipTape | None = None
                                    ) -> torch.Tensor:
    """Pattern-sharded chunked_log_likelihoods: `tips` and `weights` are
    this rank's slice of the pattern axis; one all_reduce over `group`
    sums the per-tree totals (paired.paired_log_likelihoods_sharded)."""
    return mesh.all_reduce_sum(chunked_log_likelihoods(
        post_dst, tip_slot, post_e, P, tips, pi, props, weights,
        onchip=onchip), group)


def chunked_ll_and_gradients_sharded(group, post_dst, tip_slot, post_e,
                                     node_row, edge_mask, P, dP, tips, pi,
                                     props, weights, *,
                                     onchip: paired.OnchipTape | None = None):
    """Pattern-sharded chunked_ll_and_gradients: one all_reduce of LL [B]
    and one of the gradients [B, N] over `group`."""
    ll, grads = chunked_ll_and_gradients(
        post_dst, tip_slot, post_e, node_row, edge_mask, P, dP, tips, pi,
        props, weights, onchip=onchip)
    return mesh.all_reduce_sum(ll, group), mesh.all_reduce_sum(grads, group)


def finish_rows(ll_rows, grad_rows, node_row, edge_mask, weights):
    """(ll [B], grads [B, N]) from a body's per-pattern rows: the weighted
    sums over patterns, grid rows mapped to nodes through node_row."""
    return (ll_rows @ weights,
            grad_rows.sum(dim=-1).gather(1, node_row.long()) * edge_mask)


def chunked_grad_onchip(post_dst, onchip, post_e, P, dP, tips, pi, props,
                        weights, plan: paired.OnchipPlan):
    """Launch csrc/chunked_grad_onchip.cu as `plan` says (operands checked
    by the wrapper): (LL rows [B, S], weighted gradient rows [B, 2MW+1, S];
    the rows of padded positions are not written)."""
    B, MW = post_dst.shape
    if tuple(onchip.child.shape) != (B, MW, 2):
        raise ValueError("the on-chip tape does not match post_dst")
    if tips.numel() >= 2**31:  # the kernel indexes tips with 32-bit offsets
        raise ValueError(f"tips has {tips.numel()} entries, the on-chip "
                         "body takes fewer than 2**31")
    _check_cuda_tensors(dict(child=onchip.child), {})
    for name, t in (("P", P), ("dP", dP)):  # cp.async copies 16-byte rows
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    T, S = tips.shape[0], tips.shape[-1]
    N1, C = P.shape[1], P.shape[2]
    kw = dict(device=P.device, dtype=torch.float32)
    ll_rows = torch.empty((B, S), **kw)
    grad_rows = torch.empty((B, 2 * MW + 1, S), **kw)
    with torch.cuda.device(P.device):
        rc = _kernels.library().bito_chunked_grad_onchip(
            post_dst.data_ptr(), onchip.child.data_ptr(), post_e.data_ptr(),
            P.data_ptr(), dP.data_ptr(), tips.data_ptr(), pi.data_ptr(),
            props.data_ptr(), weights.data_ptr(), ll_rows.data_ptr(),
            grad_rows.data_ptr(), B, MW, W, T, N1, C, S, onchip.grad_rows,
            plan.cols, plan.op_lanes, paired._stream())
    _kernels.check(rc, "bito_chunked_grad_onchip")
    chunked_grad_onchip.launches += 1
    return ll_rows, grad_rows


chunked_grad_onchip.launches = 0


def node_src(node_row: torch.Tensor, MW: int) -> torch.Tensor:
    """[B, MW, 2] int32: the node whose branch child j of grid op g is (its
    gradient row in the paired grad body), node_row inverted; N (the dummy
    node) where no node's real edge is consumed there."""
    B, N = node_row.shape
    src = torch.full((B, 2 * MW + 1), N, dtype=torch.int32,
                     device=node_row.device)
    # Nodes without a real edge point at row 2MW, which is cut off.
    src.scatter_(1, node_row.long(), torch.arange(
        N, dtype=torch.int32, device=node_row.device).expand(B, N))
    return src[:, :2 * MW].contiguous().view(B, MW, 2)


def chunked_grad_paired(post_dst, onchip, post_e, node_row, P, dP, tips, pi,
                        props, weights, plan: paired.OnchipPlan):
    """Launch csrc/paired_grad_onchip.cu, the paired grad kernel's on-chip
    body, on the chunked tape walked one grid op at a time as `plan`
    (paired_plan) says (operands checked by the wrapper): (LL rows [B, S],
    weighted gradient rows [B, N1, S] by node, through node_src; rows that
    no op writes are not written: paired.finish_rows masks them)."""
    rows = paired.launch_grad_onchip(
        post_dst, onchip, node_src(node_row, post_dst.shape[1]), post_e, P,
        dP, tips, pi, props, weights, plan)
    chunked_grad_paired.launches += 1
    return rows


chunked_grad_paired.launches = 0


def chunked_grad_global(post_dst, tip_slot, post_e, P, dP, tips, pi, props,
                        weights, child=None):
    """Launch csrc/chunked_grad.cu, the global body (operands checked by the
    wrapper): (LL rows [B, S], weighted gradient rows [B, 2MW+1, S], zero
    where no op writes).  Past 8 categories it needs `child`, the tape's
    child codes; the scratch and the slices as chunked_ll_global's."""
    B, MW = post_dst.shape
    T, S = tips.shape[0], tips.shape[-1]
    N1, C = P.shape[1], P.shape[2]
    alloc = _global_scratch(post_dst, child, C, S)
    kw = dict(device=P.device, dtype=torch.float32)
    ll_rows = torch.empty((B, S), **kw)
    grad_rows = torch.zeros((B, 2 * MW + 1, S), **kw)
    lib = _kernels.library()
    n = paired.launch_sliced(
        "bito_chunked_grad", B, alloc,
        lambda b0, b1, buf, ls: lib.bito_chunked_grad(
            post_dst[b0:b1].data_ptr(), tip_slot[b0:b1].data_ptr(),
            _child_ptr(child, b0, b1), post_e[b0:b1].data_ptr(),
            P[b0:b1].data_ptr(), dP[b0:b1].data_ptr(), tips.data_ptr(),
            pi.data_ptr(), props.data_ptr(), weights.data_ptr(),
            buf.data_ptr(), ls.data_ptr(), ll_rows[b0:b1].data_ptr(),
            grad_rows[b0:b1].data_ptr(), b1 - b0, MW, W, T, N1, C, S,
            paired._stream()),
        P.device)
    chunked_grad_global.launches += n
    timing.count("global_launches", n)
    return ll_rows, grad_rows


chunked_grad_global.launches = 0
