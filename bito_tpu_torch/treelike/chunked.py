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

Each kernel has three functions here, as in paired.py:
  - the plain torch version (`*_ref`), which runs one chunk's W ops as one
    batched step, is what the CPU runs and what the kernel is checked
    against;
  - the public wrapper (`chunked_log_likelihoods`,
    `chunked_ll_and_gradients`): a CPU tensor goes to the plain version; a
    CUDA tensor goes to the hand-written kernel (csrc/chunked_ll.cu,
    csrc/chunked_grad.cu), and the call raises if the kernel cannot take
    the inputs or fails to launch;
  - a launch count, `wrapper.launches`.

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
least scratch, and leaves 64 patterns per 128-thread block.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import _kernels
from .paired import _check_cuda_operands, _check_shapes, _rescale, _root_rows

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
                            weights) -> torch.Tensor:
    """Per-tree log likelihoods [B] over the chunked tape."""
    if P.device.type == "cpu":
        return chunked_log_likelihoods_ref(post_dst, tip_slot, post_e, P,
                                           tips, pi, props, weights)
    B, MW, T, N1, C, A, S = _check_chunked(post_dst, tip_slot, post_e, P,
                                           tips, pi, props, weights)
    _check_cuda_operands(
        dict(post_dst=post_dst, tip_slot=tip_slot, post_e=post_e),
        dict(P=P, tips=tips, pi=pi, props=props, weights=weights), C, A)
    NS = 2 * MW + 2
    kw = dict(device=P.device, dtype=torch.float32)
    buf = torch.empty((B, NS, C * A, S), **kw)
    ls = torch.empty((B, NS, S), **kw)
    ll_rows = torch.empty((B, S), **kw)
    lib = _kernels.library()
    with torch.cuda.device(P.device):
        rc = lib.bito_chunked_ll(
            post_dst.data_ptr(), tip_slot.data_ptr(), post_e.data_ptr(),
            P.data_ptr(), tips.data_ptr(), pi.data_ptr(), props.data_ptr(),
            buf.data_ptr(), ls.data_ptr(), ll_rows.data_ptr(),
            B, MW, W, T, N1, C, S, torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "bito_chunked_ll")
    chunked_log_likelihoods.launches += 1
    return ll_rows @ weights


chunked_log_likelihoods.launches = 0


def chunked_ll_and_gradients(post_dst, tip_slot, post_e, node_row,
                             edge_mask, P, dP, tips, pi, props, weights):
    """Per-tree (log likelihood [B], branch gradients [B, N])."""
    if P.device.type == "cpu":
        return chunked_ll_and_gradients_ref(
            post_dst, tip_slot, post_e, node_row, edge_mask, P, dP, tips, pi,
            props, weights)
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
    NS = 2 * MW + 2
    kw = dict(device=P.device, dtype=torch.float32)
    buf = torch.empty((B, NS, C * A, S), **kw)
    ls = torch.empty((B, NS, S), **kw)
    ll_rows = torch.empty((B, S), **kw)
    grad_rows = torch.zeros((B, 2 * MW + 1, S), **kw)
    lib = _kernels.library()
    with torch.cuda.device(P.device):
        rc = lib.bito_chunked_grad(
            post_dst.data_ptr(), tip_slot.data_ptr(), post_e.data_ptr(),
            P.data_ptr(), dP.data_ptr(), tips.data_ptr(), pi.data_ptr(),
            props.data_ptr(), weights.data_ptr(), buf.data_ptr(),
            ls.data_ptr(), ll_rows.data_ptr(), grad_rows.data_ptr(),
            B, MW, W, T, N1, C, S, torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "bito_chunked_grad")
    chunked_ll_and_gradients.launches += 1
    ll = ll_rows @ weights
    grads = grad_rows.sum(dim=-1).gather(1, node_row.long()) * edge_mask
    return ll, grads


chunked_ll_and_gradients.launches = 0
