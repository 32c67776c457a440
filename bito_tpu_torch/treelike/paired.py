"""Paired-slot tapes and the two tree-likelihood kernels of the main path.

Counterpart of bito_tpu.treelike.pallas_paired.  The paired-slot layout is
kept: the partial of a node lives in the slot where its parent's op reads
it, so op m's two children are always slots (2m, 2m+1), and the outside
pass can write each op's up pair over those slots in place.
`build_paired_encoding` is a numpy copy of bito_tpu's, pinned equal to it
by tests/test_torch_encode.py.

Each kernel has two bodies on the card:
  - the on-chip body (csrc/paired_ll_onchip.cu, csrc/paired_grad_onchip.cu):
    a block takes one tree and a tile of patterns, keeps every partial of
    the tile in shared memory, one row per op (indexed by the op that
    produced it, through the compact child tape of `onchip_tape`), and
    gives each rate category of a pattern its own lane;
  - the global body (csrc/paired_ll.cu, csrc/paired_grad.cu): one thread
    per (tree, pattern), the paired slots in device memory; past 8 rate
    categories the on-chip bodies' lane layout with the slots in device
    memory (csrc/paired_lanes.cuh).  It takes any tree and any category
    count; the wrappers launch it where a block of the on-chip body would
    hold too few warps of patterns to be the faster, and past
    ONCHIP_MAX_CATEGORIES (`onchip_plan` returns None), decided from the
    tape before the launch;
  - the grad kernel's third body, for trees past the on-chip grad body's
    limit at 1..COMPILED_CATEGORIES categories (about 144 taxa at C = 4),
    in place of the global one there: the checkpointed body
    (csrc/paired_grad_ckpt.cu), the on-chip body's layout on a bounded
    number of rows a pattern, which recomputes each cut clade's partials
    in the outside pass and keeps the partials above the cuts in a tier
    in device memory, over a schedule built on the host with the on-chip
    tape (`ckpt_schedule`, `OnchipTape.ckpt`); the global body keeps the
    trees whose edges pass the schedule's 16-bit fields (CKPT_MAX_EDGES).
The kernels take any count C >= 1 of rate categories, as bito_tpu's
Pallas kernels do: at 4 states 1-8 compiled one count at a time, 9-32 on
16 or 32 lanes a pattern (`lanes`) with the count read at run time, and
past 32 on 32 lanes a pattern of K = `lane_categories(C)` categories
each: the on-chip bodies up to K = MAX_LANE_CATEGORIES (128 categories;
K fixed at compile time, the matrices through the ring), the global
bodies at any K.  So do the chunked and per-node kernels (chunked.py,
pernode.py), whose grad kernels also run the on-chip grad body here on
their own tapes where their own on-chip bodies get no plan; the A=64
kernels take any count on their one body.  What bounds C is the card's
memory: the global bodies'
and the A=64 kernels' launchers allocate their scratch for the batch,
split it over slices of trees where it cannot be allocated
(`tree_slices`), and raise where one tree's does not fit, with the
bytes.
The on-chip LL body also serves the chunked and per-node LL kernels
(chunked.py, pernode.py): their tapes are walked as paired tapes, one op
at a time, through `launch_ll_onchip`.

At 64 states (MG94 codon models) each kernel has one body of its own
(csrc/paired_ll_a64.cu, csrc/paired_grad_a64.cu): a block takes one tree
and a tile of 128 patterns, a warp 16 patterns and all 64 states of
them, the partials stay in device memory, and every 64x64 product runs
on the tensor cores in 3xTF32 (csrc/paired_a64.cuh): a step's matrices
arrive during the step before and are split once a block into hi and lo
planes in shared memory.  The wrappers launch them for A=64 operands on
the card; they need no OnchipTape.  `tf32_mm` and
`paired_ll_and_gradients_tf32` emulate their arithmetic in plain torch,
for the tests.

Their scratch grows with the categories C: the partials buf [B, NS, C,
64, S] float32 (NS = 2M + 3), each slot's scales [B, NS, 2 + C, S] and
the slot codes [B, tiles, NS] (`a64_tree_bytes` a tree).  At config6's
shape (bench_configs.py: 27 taxa, 640 padded patterns, M = 28 ops, NS =
59, N + 1 = 53 edges, B = 128 trees) that is, at C = 9 / 16 / 32:
  - buf 9.67 MB a tree and category: 11.1 / 19.8 / 39.6 GB at B = 128;
  - the scales 0.15 MB a tree and (2 + C): 0.21 / 0.35 / 0.66 GB;
  - the codes 1,180 bytes a tree;
  - so 88.7 / 157.4 / 314.5 MB a tree, 11.3 / 20.1 / 40.3 GB at B = 128
    and 17.7 / 31.5 / 62.9 GB at B = 200;
  - beside it the operands P and dP [B, N + 1, C, 64, 64] float32, 0.111
    GB a category each at B = 128: 1.0 / 1.8 / 3.6 GB each;
  - and, before the launch, the float64 prep's transients (the
    uniformized P [B, N, C, 64, 64], its copy with the identity edge, dP
    = Q P: prep.prepare_inputs_grad_q) at 0.22 GB a category each: 2.0 /
    3.6 / 7.1 GB each, freed to torch's cache before the launch.
At C = 48 and 64 a tree's scratch is 471.5 / 628.6 MB (60.4 / 80.5 GB at
B = 128: past about 100 trees at 64 the launchers slice the batch).  The
4-state global bodies' scratch past 32 categories is the slots float4
[B, NS, Sp, K, 32] (K = lane_categories(C), 2 at 33-64): 61.9 MB a tree
at the flagship's shape, 12.4 GB at B = 200.  The plain version in
float64 holds buf in float64, twice the kernels' (about 80 GB at C = 32
over 128 trees), so the card's checks hold the kernels to it on a few of
the trees they time: each tree's rows depend on that tree alone.  The
launchers launch once where the scratch of the whole batch can be
allocated; where it cannot, over consecutive slices of the batch
(`tree_slices`), each of as many trees as the card's free memory holds
(`scratch_budget`: with what torch's cache can release; less
SCRATCH_HEADROOM), into one scratch; each slice is a launch
(`launch_sliced`, which the 4-state global bodies share).  Where one
tree does not fit they raise and name the bytes.

Beside them, in this module:
  - the plain torch version of each kernel (`*_ref`), which computes the
    same numbers and is what the CPU runs and what the kernels are checked
    against (the checkpointed body's, `paired_grad_ckpt_ref`, interprets
    its schedule as the kernel does);
  - the public wrappers (`paired_log_likelihoods`,
    `paired_ll_and_gradients`): a CPU tensor goes to the plain version; a
    CUDA tensor goes to a body, and the call raises if the body cannot take
    the inputs or fails to launch;
  - each body's launcher (`paired_ll_onchip`, `paired_ll_global`,
    `paired_grad_onchip`, `paired_grad_ckpt`, `paired_grad_global`), which
    returns the per-pattern rows (`finish_rows` sums them) and counts its
    launches in `.launches`, raised by one where it launches its kernel
    and nowhere else; the global bodies' launchers (here, in chunked.py
    and in pernode.py) also count them, one a slice, as the program's
    counter `global_launches` (utils/timing), and the checkpointed body's
    as `checkpoint_launches`, which say which body took a call;
  - the pattern-sharded wrappers (`paired_log_likelihoods_sharded`,
    `paired_ll_and_gradients_sharded`): each rank of a process group runs
    the public wrapper on its slice of the pattern axis, and one
    all_reduce a result sums the per-tree totals over the ranks
    (bito_tpu's shard_map and psum).

Operands (built by treelike/prep.py):
  post_dst [B, M], tip_slot [B, T], post_src / post_e [B, M, 2] int32 tapes;
  P, dP [B, N+1, C, A, A]; tips [T, A, S]; pi [A]; props [C]; weights [S];
  edge_mask [B, N]; A is 4 or 64 (KERNEL_STATES).

Both versions rescale after every op (bito_tpu's kernel: every fourth);
the log scales keep the log likelihoods exact and the gradient rows are
ratios that no scale changes.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ..dist import mesh
from ..utils import timing
from . import _kernels

RESK = 4  # the tape is padded to a multiple of this many ops, as in bito_tpu
# Every kernel takes any category count C >= 1.  The 4-state ones (the
# paired, chunked and per-node families) compile 1..COMPILED_CATEGORIES
# one count at a time; past it their bodies take the count at run time,
# on `lanes(C)` lanes a pattern, and their global bodies the lane layouts
# (csrc/paired_lanes.cuh, csrc/pernode_lanes.cuh).  Their on-chip bodies
# hold a category a lane, a pattern at most a warp, up to
# ONCHIP_CATEGORIES; past it a lane of 32 holds K = `lane_categories(C)`
# categories, the on-chip bodies of rows 1-2 compiled for K =
# 2..MAX_LANE_CATEGORIES (csrc/onchip.cuh kMaxK), so up to
# ONCHIP_MAX_CATEGORIES, and the global bodies at any K.  The A=64
# kernels take a step an (op, category) on one body.
COMPILED_CATEGORIES = 8
ONCHIP_CATEGORIES = 32
MAX_LANE_CATEGORIES = 4
ONCHIP_MAX_CATEGORIES = ONCHIP_CATEGORIES * MAX_LANE_CATEGORIES
KERNEL_STATES = (4, 64)  # the state counts the paired kernels take
# A shard's pattern count is a multiple of this (TreeLikelihoodEngine.
# shard_patterns): the A=64 kernels copy [64, S] rows in 16-byte pieces.
PATTERN_MULTIPLE = 4


def _rup(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class PairedEncoding:
    """Host-side paired-slot tapes derived from a TreeBatchEncoding."""

    num_taxa: int
    num_slots: int          # old per-node slot count (grad row space)
    M: int                  # padded postorder op count (multiple of RESK)
    n_pair_slots: int       # 2*M + 3 (root, trash, ones-dummy)
    post_dst: np.ndarray    # [B, M] destination pair-slot per op
    post_e: np.ndarray      # [B, M, 2] edge indices (into P) per child
    post_src: np.ndarray    # [B, M, 2] source node ids (gradient rows)
    tip_slot: np.ndarray    # [B, T] pair-slot of each tip's partial


def build_paired_encoding(enc) -> PairedEncoding:
    """Derive paired-slot tapes from a TreeBatchEncoding (pure host work,
    cached by the engine per encoding)."""
    B, M0, _ = enc.post_ops.shape
    T = enc.num_taxa
    DUMMY = enc.num_slots

    M = _rup(max(M0, 1), RESK)
    TRASH = 2 * M + 1
    ROOT = 2 * M
    GTRASH = enc.num_slots  # trash gradient row

    post_dst = np.full((B, M), TRASH, dtype=np.int32)
    post_e = np.full((B, M, 2), DUMMY, dtype=np.int32)  # DUMMY == identity
    post_src = np.full((B, M, 2), GTRASH, dtype=np.int32)
    tip_slot = np.full((B, T), TRASH, dtype=np.int32)

    for b in range(B):
        producer: dict = {}
        for m in range(M0):
            u, s1, e1, s2, e2 = (int(x) for x in enc.post_ops[b, m])
            if u == DUMMY:
                break
            for j, (s, e) in enumerate(((s1, e1), (s2, e2))):
                post_e[b, m, j] = e
                if s == DUMMY:
                    continue
                post_src[b, m, j] = s
                slot = 2 * m + j
                if s in producer:
                    post_dst[b, producer[s]] = slot
                else:
                    if s >= T:
                        raise ValueError(f"tree {b}: op {m} reads node {s} "
                                         "before any op produced it")
                    tip_slot[b, s] = slot
            producer[u] = m
        root = int(enc.root[b])
        if root not in producer:
            raise ValueError(f"tree {b}: no op produces the root {root}")
        post_dst[b, producer[root]] = ROOT

    return PairedEncoding(
        num_taxa=T, num_slots=enc.num_slots, M=M,
        n_pair_slots=2 * M + 3, post_dst=post_dst, post_e=post_e,
        post_src=post_src, tip_slot=tip_slot,
    )


# ---------------------------------------------------------------------------
# The on-chip bodies' tapes and sizing
# ---------------------------------------------------------------------------

# Child code of a pair slot that no tip and no op writes (a DUMMY child):
# the all-ones partial, read through the identity edge.
ONES = np.iinfo(np.int32).min


def child_tape(post_dst: np.ndarray, tip_slot: np.ndarray) -> np.ndarray:
    """child [B, M, 2] int32: who writes pair slot 2m+j, which op m reads as
    its child j.  Op m' >= 0 for an op's output, -1 - t for tip t, ONES
    where nothing writes the slot (padded ops and DUMMY children)."""
    B, M = post_dst.shape
    T = tip_slot.shape[1]
    owner = np.full((B, 2 * M + 3), ONES, dtype=np.int32)
    rows = np.arange(B)[:, None]
    # Padded ops write the trash slot and the root op writes ROOT, both
    # past the pair slots 0 .. 2M-1 that ops read.
    owner[rows, post_dst] = np.arange(M, dtype=np.int32)[None, :]
    owner[rows, tip_slot] = -1 - np.arange(T, dtype=np.int32)[None, :]
    return np.ascontiguousarray(owner[:, :2 * M].reshape(B, M, 2))


def live_rows(post_dst: np.ndarray, child: np.ndarray) -> tuple[np.ndarray,
                                                                 int]:
    """Rows of the LL kernel by liveness: (row [B, M] int32, rows).  Op m's
    output takes the lowest row free at op m, after its children's rows
    are freed (a thread loads both children before it stores), and keeps
    it until its consumer reads it.  The root op and padded ops store
    nothing (row 0).  `rows` is the peak over the batch.  The rows hold
    for a body that runs the ops one at a time, in tape order; a body that
    ran several ops side by side could store over a row that another of
    them still reads."""
    B, M = post_dst.shape
    trash, root = 2 * M + 1, 2 * M
    row = np.zeros((B, M), dtype=np.int32)
    free = np.ones((B, M), dtype=bool)  # the rows free in each tree
    trees = np.arange(B)
    for m in range(M):  # every tree at once, op by op
        runs = post_dst[:, m] != trash
        for j in (0, 1):
            c = child[:, m, j]
            read = runs & (c >= 0)
            free[trees[read], row[trees[read], c[read]]] = True
        store = runs & (post_dst[:, m] != root)
        lowest = np.argmax(free[store], axis=1)
        row[store, m] = lowest
        free[trees[store], lowest] = False
    stored = (post_dst != trash) & (post_dst != root)
    return row, int(row[stored].max()) + 1 if stored.any() else 1


def grad_rows_needed(post_dst: np.ndarray) -> int:
    """Rows of the grad kernel: op m's output and then its outside value
    live in row m, for every op but the root op and padded ones."""
    B, M = post_dst.shape
    stored = (post_dst != 2 * M + 1) & (post_dst != 2 * M)
    ops = np.nonzero(stored.any(axis=0))[0]
    return int(ops[-1]) + 1 if ops.size else 1


@dataclass(frozen=True)
class CkptTape:
    """The checkpointed grad body's schedule (ckpt_schedule) on the device
    of the tapes, and its sizes."""

    sched: torch.Tensor  # [B, L, CKPT_INTS] int32, one entry a step
    rows: int            # on-chip rows a pattern
    slots: int           # device-tier slots a tree (at least 1)


@dataclass(frozen=True)
class OnchipTape:
    """What the on-chip bodies read beside the paired tapes, on the
    device of the tapes."""

    child: torch.Tensor     # [B, M, 2] int32, child_tape
    live_row: torch.Tensor  # [B, M] int32, the LL kernel's row of each op
    ll_rows: int            # rows per pattern of the LL kernel
    grad_rows: int          # rows per pattern of the grad kernel
    # the checkpointed grad body's schedule, where the on-chip grad body
    # gets no plan at COMPILED_CATEGORIES categories (onchip_tape)
    ckpt: CkptTape | None = None


def onchip_tape(post_dst: np.ndarray, tip_slot: np.ndarray, device, *,
                post_src: np.ndarray, post_e: np.ndarray,
                edges: int) -> OnchipTape:
    """The on-chip bodies' tape, derived on the host from a
    PairedEncoding's `post_dst`, `tip_slot`, `post_src` and `post_e`, whose
    P has `edges` rows N1, and put on `device`.  The engine builds it with
    the paired tapes, once per topology set.  Where the on-chip grad body
    gets no plan at COMPILED_CATEGORIES categories (so none at fewer: a
    block's warps fall as a pattern's lanes grow) and the schedule's
    16-bit fields hold the edges (CKPT_MAX_EDGES), the tape carries the
    checkpointed grad body's schedule (ckpt_tape), which the grad wrapper
    takes in place of the on-chip body at 1..COMPILED_CATEGORIES
    categories."""
    child = child_tape(post_dst, tip_slot)
    row, ll_rows = live_rows(post_dst, child)
    grad_rows = grad_rows_needed(post_dst)
    ckpt = None
    if edges <= CKPT_MAX_EDGES and onchip_plan(
            "grad", grad_rows, post_dst.shape[1], edges,
            COMPILED_CATEGORIES) is None:
        ckpt = ckpt_tape(post_dst, child, post_e, post_src, device)
    return OnchipTape(
        child=torch.as_tensor(child, device=device),
        live_row=torch.as_tensor(row, device=device),
        ll_rows=ll_rows, grad_rows=grad_rows, ckpt=ckpt)


# ---------------------------------------------------------------------------
# The checkpointed grad body's schedule
# ---------------------------------------------------------------------------
#
# The on-chip grad body keeps a shared-memory row an op, since the outside
# pass reads every postorder partial: past about 144 taxa at C = 4 too few
# warps of patterns fit.  The checkpointed body (csrc/paired_grad_ckpt.cu)
# keeps a bounded number of rows instead.  Each tree is cut at its largest
# clades of at most CKPT_OPS ops; the ops above the cuts ("top" ops) and
# the cut clades' roots are checkpoints, whose partials go to a tier in
# device memory.  One linear schedule a tree:
#   1. the postorder over every op, a cut clade's ops together, each clade
#      op's partial in on-chip row = its rank in the clade, each
#      checkpoint's in its tier slot;
#   2. the outside pass over the top ops in reverse tape order; right after
#      a top op, each child that roots a cut clade: the clade's partials
#      recomputed from its tips into the same rows (the clade's root
#      excepted: its partial was the top op's to read), then the clade's
#      own outside pass in reverse.
# Every entry names its operands and destinations (on-chip row, tier slot,
# tip, all ones, pi), so the kernel interprets the schedule and decides
# nothing.  A recomputed partial is the first pass's bit for bit: the same
# entry kind on the same operands.

# Ops a cut clade at most, set from H100 times at rbcL 500's shape (200
# trees x 500 taxa x 1,024 patterns, PERF.md): 8, 12 and 16 ops a clade
# took 19.33-19.37 ms (18 rows a pattern at 16, a block's 16 warps), 20
# took 20.59 and 32 took 26.67 (34 rows, 11 warps): the body is
# latency-bound a warp, so its time goes as 1 / warps, and 16 is the
# largest clade that keeps all 16 with the smallest tier.
CKPT_OPS = 16
CKPT_INTS = 8  # int32s an entry: kind, e0 | e1 << 16, a0, a1, a2, d0, d1,
#               src0 | src1 << 16
CKPT_NOP, CKPT_POST, CKPT_ROOT, CKPT_OUT = 0, 1, 2, 3  # entry kinds
CKPT_TIER = 1 << 24     # codes from here: tier slot code - CKPT_TIER
CKPT_PI = ONES + 1      # operand: pi, the root op's outside value
CKPT_NONE = -1          # destination: not stored
# Edges N1 a tape's P has at most for a schedule: an entry packs two edge
# numbers, and two gradient rows (at most N1 - 1), in 16 bits each
CKPT_MAX_EDGES = 1 << 16


@dataclass(frozen=True)
class CkptSchedule:
    """ckpt_schedule's result on the host."""

    sched: np.ndarray  # [B, L, CKPT_INTS] int32
    op: np.ndarray     # [B, L] int32: the op of each entry, -1 for padding
    rows: int          # on-chip rows a pattern the entries name
    slots: int         # tier slots a tree the entries name (at least 1)


def ckpt_schedule(post_dst: np.ndarray, child: np.ndarray,
                  post_e: np.ndarray, post_src: np.ndarray,
                  ops: int = CKPT_OPS) -> CkptSchedule:
    """The checkpointed grad body's schedule of a paired tape, every tree
    at once (one numpy step an op, as live_rows).

    An entry of kind CKPT_POST or CKPT_ROOT runs op m's postorder product
    of its children a0, a1 over edges e0, e1 and stores it to d0 and d1
    (CKPT_ROOT: the LL row instead); CKPT_OUT runs op m's outside step from
    its outside value a2 and its children's partials a0, a1, writes the
    gradient rows src0 and src1, and child j's outside value to dj.  An
    operand code is an on-chip row (0 .. rows-1), a tier slot (CKPT_TIER +
    slot), a tip (-1 - t), ONES or CKPT_PI; a destination a row, a tier slot
    or CKPT_NONE.  The kernel fetches an entry's tier and tip operands
    while the entry before it runs, so no entry reads a slot that the entry
    just before it writes: such a value also goes to the forwarding row,
    which the next entry reads.  Rows: a clade's ranks 0 .. R-1, two for
    the outside values of a top op's cut children (U0, U1), the forwarding
    row; so at most ops + 2 a pattern."""
    B, M = post_dst.shape
    if B == 0 or M == 0:
        raise ValueError("the schedule takes a tape of one tree and op or "
                         "more")
    if max(int(post_e.max()), int(post_src.max())) >= CKPT_MAX_EDGES:
        raise ValueError("the schedule packs edges and gradient rows in 16 "
                         "bits")
    trash, root = 2 * M + 1, 2 * M
    trees = np.arange(B)
    valid = post_dst != trash
    is_root = post_dst == root
    cons = np.where(valid & ~is_root, post_dst // 2, 0)  # the consumer op
    has_cons = valid & ~is_root
    is_op = child >= 0
    kid = np.maximum(child, 0)

    size = np.zeros((B, M), dtype=np.int64)  # ops in each op's clade
    for m in range(M):
        size[:, m] = valid[:, m] + sum(
            np.where(is_op[:, m, j], size[trees, kid[:, m, j]], 0)
            for j in (0, 1))
    top = valid & (size > ops)
    cut = valid & ~top & (is_root | (has_cons & np.take_along_axis(
        top, cons, axis=1)))
    inner = valid & ~top & ~cut
    ckpt = (top | cut) & ~is_root
    group = np.full((B, M), M, dtype=np.int64)  # a clade's root, else m
    for m in range(M - 1, -1, -1):
        group[:, m] = np.where(top[:, m] | cut[:, m], m, np.where(
            inner[:, m], group[trees, cons[:, m]], M))

    # 1. the postorder: by clade, then by op
    order1 = np.argsort(group * M + np.arange(M), axis=1, kind="stable")
    n1 = valid.sum(axis=1)
    pos1 = np.empty((B, M), dtype=np.int64)
    np.put_along_axis(pos1, order1, np.arange(M)[None, :], axis=1)
    g_sorted = np.take_along_axis(group, order1, axis=1)
    start = np.ones((B, M), dtype=bool)
    start[:, 1:] = g_sorted[:, 1:] != g_sorted[:, :-1]
    first = np.maximum.accumulate(np.where(start, np.arange(M), 0), axis=1)
    rank = np.empty((B, M), dtype=np.int64)  # an op's rank in its clade
    np.put_along_axis(rank, order1, np.arange(M) - first, axis=1)
    R = int(rank[inner].max()) + 1 if inner.any() else 0
    U0, FWD = R, R + 2
    slot = np.cumsum(ckpt, axis=1) - 1
    slots = max(int(ckpt.sum(axis=1).max()), 1)

    # 2. the outside pass: each entry's key is (its top op's place in
    # reverse order, section 0 for the top op's own step or 1 + j for the
    # clade of its child j, place in the clade's block); a cut root's
    # clade hangs on its consumer, a root that roots a clade comes first
    W = 2 * ops + 2
    anchor = np.where(top, M - np.arange(M), 0)  # a group's anchor
    g = np.minimum(group, M - 1)
    r_cons = np.take_along_axis(cons, g, axis=1)
    r_root = np.take_along_axis(is_root, g, axis=1)
    r_j = np.take_along_axis(post_dst % 2, g, axis=1)
    k = np.take_along_axis(size, g, axis=1)  # the clade's ops
    clade_key = np.where(r_root, 0, (M - r_cons) * 3 * W + (1 + r_j) * W)
    big = np.iinfo(np.int64).max
    key_out = np.where(top, anchor * 3 * W, np.where(
        valid, clade_key + (k - 1) + (k - 1 - rank), big))
    key_re = np.where(inner, clade_key + rank, big)
    keys = np.concatenate([key_out, key_re], axis=1)
    order2 = np.argsort(keys, axis=1, kind="stable")
    pos2 = np.empty((B, 2 * M), dtype=np.int64)
    np.put_along_axis(pos2, order2, np.arange(2 * M)[None, :], axis=1)
    pos2 += n1[:, None]
    n2 = (keys < big).sum(axis=1)
    L = int((n1 + n2).max())
    out_pos, re_pos = pos2[:, :M], pos2[:, M:]

    # where each value lives: a forwarded checkpoint is also in FWD
    fwd1 = ckpt & (np.take_along_axis(pos1, cons, axis=1) == pos1 + 1)
    fwd2 = top & has_cons & (np.take_along_axis(out_pos, cons, axis=1) + 1
                             == out_pos)
    tier = CKPT_TIER + slot
    p1 = np.where(inner, rank, np.where(fwd1, FWD, tier))  # phase 1 reads
    p2 = np.where(inner, rank, tier)  # the outside pass reads
    up = np.where(is_root, CKPT_PI, np.where(inner, rank, np.where(
        cut, U0 + post_dst % 2, np.where(fwd2, FWD, tier))))

    def of(codes, none):  # child j's code: codes[child] for an op child
        return np.where(is_op, codes[trees[:, None, None], kid], none)

    e01 = post_e[..., 0] | post_e[..., 1] << 16
    kinds = np.where(is_root, CKPT_ROOT, CKPT_POST)
    none = np.full((B, M), CKPT_NONE)
    zero = np.zeros((B, M), dtype=np.int64)
    a = of(p1, child)
    post = np.stack([kinds, e01, a[..., 0], a[..., 1], zero,
                     np.where(inner, rank, np.where(fwd1, FWD, CKPT_NONE)),
                     np.where(ckpt, tier, CKPT_NONE), zero], axis=-1)
    a, d = of(p2, child), of(up, CKPT_NONE)
    out = np.stack([np.full((B, M), CKPT_OUT), e01, a[..., 0], a[..., 1],
                    up, d[..., 0], d[..., 1],
                    post_src[..., 0] | post_src[..., 1] << 16], axis=-1)
    a = of(rank, child)
    recompute = np.stack([np.full((B, M), CKPT_POST), e01, a[..., 0],
                          a[..., 1], zero, rank, none, zero], axis=-1)

    sched = np.zeros((B, L, CKPT_INTS), dtype=np.int32)
    op = np.full((B, L), -1, dtype=np.int32)
    ms = np.broadcast_to(np.arange(M), (B, M))
    for fields, pos, keep in ((post, pos1, valid), (out, out_pos, valid),
                              (recompute, re_pos, inner)):
        bs, m = np.nonzero(keep)
        sched[bs, pos[bs, m]] = fields[bs, m]
        op[bs, pos[bs, m]] = ms[bs, m]
    return CkptSchedule(sched, op, R + 3, slots)


def ckpt_tape(post_dst: np.ndarray, child: np.ndarray, post_e: np.ndarray,
              post_src: np.ndarray, device, ops: int = CKPT_OPS) -> CkptTape:
    """ckpt_schedule of the paired tapes, its entries put on `device`."""
    s = ckpt_schedule(post_dst, child, post_e, post_src, ops)
    return CkptTape(torch.as_tensor(s.sched, device=device), s.rows,
                    s.slots)


SMEM_BYTES = 232_448  # shared memory one block can take on an H100 (227 KB)
MAX_THREADS = 512     # threads per block, csrc/onchip.cuh kMaxThreads
MAX_THREADS_K = 256   # the grad body's past 32 categories (kMaxThreadsK)
WARP = 32


def lanes(C: int) -> int:
    """Lanes per pattern: the power of two at or above C, at most a warp
    (past ONCHIP_CATEGORIES a lane holds lane_categories(C))."""
    return min(1 << (C - 1).bit_length(), WARP)


def lane_categories(C: int) -> int:
    """Categories a lane holds: 1 up to ONCHIP_CATEGORIES, past it K =
    ceil(C / 32), categories g, g + 32, ... on lane g (the on-chip bodies'
    places, csrc/onchip.cuh; the global bodies' wide_categories,
    csrc/paired_lanes.cuh)."""
    return -(-C // WARP)


def smem_bytes(kernel: str, rows: int, M: int, N1: int, C: int, cols: int,
               ring: bool) -> int:
    """Dynamic shared memory of one block, laid out as the kernels lay it
    out (csrc/onchip.cuh, `onchip::smem_bytes`): rows of 16-byte lane
    slices (K = lane_categories(C) a lane and row), then the matrices
    (rows of every category), then the tape."""
    G = lanes(C) * lane_categories(C)  # a row's float4s across the lanes
    mats_per_op = 2 if kernel == "ll" else 4  # P (and dP) of both children
    if ring:  # two buffers of one op's matrices
        mats = 2 * mats_per_op
    else:     # the tree's P (and dP) for every edge
        mats = N1 * mats_per_op // 2
    tape_ints = 6 * M if kernel == "ll" else 7 * M
    return (rows * cols * G * 16 + mats * G * 4 * 16
            + _rup(tape_ints * 4, 16))


@dataclass(frozen=True)
class OnchipPlan:
    lanes: int     # G lanes per pattern, one per rate category (or K)
    cols: int      # patterns per block
    ring: bool     # matrices double-buffered per op, else staged all at once
    smem: int      # bytes of dynamic shared memory per block
    op_lanes: int = 1  # ops a pattern runs side by side (chunked.py's grad)
    categories_per_lane: int = 1  # K: past 32, categories g + 32 k a lane


# The choice between the stagings and the global body, set from times on
# an H100 (chip_smoke.py phase 4, 64-400 taxa, PERF.md): the staged body
# is the fastest where a block holds FULL_WARPS warps of patterns; below
# that the one with more warps wins; under MIN_WARPS warps the global body
# is faster.  A block takes one SM's shared memory, so its warps are the
# SM's.
FULL_WARPS = 8
MIN_WARPS = 3
# Past 32 categories the on-chip bodies (K categories a lane, the ring)
# take a tape where a block holds K_MIN_WARPS[kernel] warps, below that
# the wide kernels of the global bodies: the least warps at which each
# body beat every wide kernel at K = 2 and 4, on H100 times at the
# flagship (chip_smoke.py phase 4, k_warps_times: each body at forced
# blocks of 1 warp up, PERF.md).  The time falls about as 1 / warps: at
# K = 2 the grad body took 29.40 ms at 3 warps against the paired and
# chunked wide kernels' 31.50 and 27.97, 25.19 at 4; at K = 4 63.77 at 3
# against 61.40 and 54.81.  The LL body took 5.87 ms at 5 warps at K = 2
# against 7.52 and 6.79, but 14.86 at K = 4 against 15.26 and 13.22,
# 11.98 at 6.  The per-node grad kernel's wide kernel is the slowest
# (43.49 and 85.65 ms), so the per-node ops' tape takes the grad body at
# MIN_WARPS (pernode.paired_plan).
K_MIN_WARPS = {"ll": 6, "grad": 4}


def _warps(kernel, rows, M, N1, C, ring) -> int:
    """Whole warps of patterns a block of that staging holds."""
    fixed = smem_bytes(kernel, 0, M, N1, C, 0, ring)
    if fixed >= SMEM_BYTES:
        return 0
    per_warp = smem_bytes(kernel, rows, M, N1, C, WARP // lanes(C),
                          ring) - fixed
    threads = (MAX_THREADS_K if kernel == "grad" and lane_categories(C) > 1
               else MAX_THREADS)
    return min((SMEM_BYTES - fixed) // per_warp, threads // WARP)


def onchip_plan(kernel: str, rows: int, M: int, N1: int, C: int,
                ring: bool | None = None, full_warps: int = FULL_WARPS,
                min_warps: int = MIN_WARPS,
                k_min_warps: int | None = None) -> OnchipPlan | None:
    """How an on-chip body launches, or None where the global body takes
    the tape (past ONCHIP_MAX_CATEGORIES categories always).  A block
    takes as many whole warps of patterns as fit in SMEM_BYTES, up to
    MAX_THREADS threads.  `ring` None chooses as the
    card's times say: all matrices staged where that leaves `full_warps`
    warps (FULL_WARPS on the paired tape; a tape whose times say
    otherwise passes its own), else the staging with more warps (staged
    on a tie), and None below `min_warps` (MIN_WARPS; a tape whose global
    body is the faster sooner passes its own).  True or False asks for
    one staging at any number of warps, to measure it.  Past
    ONCHIP_CATEGORIES the bodies hold K = lane_categories(C) categories a
    lane on the ring alone: None for ring=False, and for ring None the
    ring where `k_min_warps` warps fit (K_MIN_WARPS[kernel] where None; a
    tape whose wide kernel is slower passes its own)."""
    if kernel not in ("ll", "grad"):
        raise ValueError(f"kernel must be 'll' or 'grad', got {kernel!r}")
    check_categories(C)
    if C > ONCHIP_MAX_CATEGORIES:
        return None
    K = lane_categories(C)
    if K > 1:
        if ring is False:
            return None
        warps = _warps(kernel, rows, M, N1, C, True)
        least = K_MIN_WARPS[kernel] if k_min_warps is None else k_min_warps
        if warps < (least if ring is None else 1):
            return None
        return OnchipPlan(WARP, warps, True,
                          smem_bytes(kernel, rows, M, N1, C, warps, True),
                          categories_per_lane=K)
    if ring is None:
        staged = _warps(kernel, rows, M, N1, C, False)
        ringed = _warps(kernel, rows, M, N1, C, True)
        ring = staged < full_warps and ringed > staged
        warps, least = (ringed if ring else staged), min_warps
    else:
        warps, least = _warps(kernel, rows, M, N1, C, ring), 1
    if warps < least:
        return None
    G = lanes(C)
    cols = warps * (WARP // G)
    return OnchipPlan(G, cols, ring,
                      smem_bytes(kernel, rows, M, N1, C, cols, ring))


def ckpt_plan(rows: int, C: int) -> OnchipPlan:
    """How the checkpointed grad body launches at C <= COMPILED_CATEGORIES
    categories on `rows` rows a pattern (CkptTape.rows): as many whole
    warps of patterns as SMEM_BYTES holds, up to MAX_THREADS threads, a
    warp's rows and its own ring of one entry's P and dP double-buffered
    (the kernel's byte count, csrc/paired_grad_ckpt.cu: no tape in shared
    memory).  Raises where no warp fits."""
    if not 1 <= C <= COMPILED_CATEGORIES:
        raise ValueError(f"the checkpointed body takes 1..."
                         f"{COMPILED_CATEGORIES} categories, got {C}")
    G = lanes(C)
    per_warp = rows * WARP * 16 + 8 * G * 4 * 16  # rows, then the ring
    warps = min(SMEM_BYTES // per_warp, MAX_THREADS // WARP)
    if warps < 1:
        raise ValueError(f"{rows} rows a pattern leave no warp of the "
                         "checkpointed body a block")
    return OnchipPlan(G, warps * (WARP // G), True, warps * per_warp)


# ---------------------------------------------------------------------------
# Plain torch versions
# ---------------------------------------------------------------------------

def _rescale(x: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """x / max over dims (1 where the max is not positive), and the max."""
    mx = x.amax(dim=dims, keepdim=True)
    mx = torch.where(mx > 0, mx, torch.ones_like(mx))
    return x / mx, mx


def _postorder(post_dst, tip_slot, post_e, P, tips):
    """Run the postorder over the paired slots.  Returns the slot buffer
    [B, 2M+3, C, A, S] and log scales [B, 2M+3, S]."""
    B, M = post_dst.shape
    T = tip_slot.shape[1]
    C, A = P.shape[2], P.shape[3]
    S = tips.shape[-1]
    kw = dict(device=P.device, dtype=P.dtype)
    b = torch.arange(B, device=P.device)
    buf = torch.ones((B, 2 * M + 3, C, A, S), **kw)
    ls = torch.zeros((B, 2 * M + 3, S), **kw)
    buf[b[:, None], tip_slot.long()] = tips.to(P.dtype)[None, :, None].expand(
        B, T, C, A, S)
    dst_all, e_all = post_dst.long(), post_e.long()
    for m in range(M):
        ev = P[b[:, None], e_all[:, m]] @ buf[:, 2 * m:2 * m + 2]  # [B,2,C,A,S]
        prod, mx = _rescale(ev[:, 0] * ev[:, 1], (1, 2))
        buf[b, dst_all[:, m]] = prod
        ls[b, dst_all[:, m]] = (ls[:, 2 * m] + ls[:, 2 * m + 1]
                                + torch.log(mx[:, 0, 0]))
    return buf, ls


def _root_rows(buf, ls, root, pi, props):
    site = torch.einsum("c,a,bcas->bs", props.to(buf.dtype), pi.to(buf.dtype),
                        buf[:, root])
    return torch.log(site) + ls[:, root]


def paired_log_likelihoods_ref(post_dst, tip_slot, post_e, P, tips, pi,
                               props, weights) -> torch.Tensor:
    """Plain torch version of the LL kernel: per-tree log likelihoods [B]."""
    buf, ls = _postorder(post_dst, tip_slot, post_e, P, tips)
    root = 2 * post_dst.shape[1]
    return _root_rows(buf, ls, root, pi, props) @ weights.to(P.dtype)


def paired_ll_and_gradients_ref(post_dst, tip_slot, post_src, post_e,
                                edge_mask, P, dP, tips, pi, props, weights):
    """Plain torch version of the LL+gradient kernel: (ll [B],
    branch gradients [B, N])."""
    B, M = post_dst.shape
    N1, C, A = P.shape[1], P.shape[2], P.shape[3]
    S = tips.shape[-1]
    dtype = P.dtype
    w, pi, props = weights.to(dtype), pi.to(dtype), props.to(dtype)
    buf, ls = _postorder(post_dst, tip_slot, post_e, P, tips)
    root = 2 * M
    ll = _root_rows(buf, ls, root, pi, props) @ w
    # Seed the outside pass: the root's outside value is pi.
    buf[:, root] = pi[None, None, :, None].expand(B, C, A, S)
    b = torch.arange(B, device=P.device)
    grad_rows = torch.zeros((B, N1, S), device=P.device, dtype=dtype)
    dst_all, e_all, src_all = post_dst.long(), post_e.long(), post_src.long()
    for m in range(M - 1, -1, -1):
        e = e_all[:, m]
        P2, dP2 = P[b[:, None], e], dP[b[:, None], e]      # [B, 2, C, A, A]
        pair = buf[:, 2 * m:2 * m + 2]                      # [B, 2, C, A, S]
        ev, dv = P2 @ pair, dP2 @ pair
        up = buf[b, dst_all[:, m]]                           # [B, C, A, S]
        o, _ = _rescale(up[:, None] * ev.flip(1), (1, 2, 3))  # o_j = up*ev_sib
        den = torch.einsum("c,bjcas->bjs", props, o * ev)
        num = torch.einsum("c,bjcas->bjs", props, o * dv)
        den = torch.where(den > 0, den, torch.ones_like(den))
        grad_rows[b[:, None], src_all[:, m]] = w * num / den
        buf[:, 2 * m:2 * m + 2] = P2.transpose(-1, -2) @ o
    N = edge_mask.shape[1]
    return ll, grad_rows.sum(dim=-1)[:, :N] * edge_mask.to(dtype)


def _pow2_exponent(mx: torch.Tensor) -> torch.Tensor:
    """The kernels' rescale exponent (csrc/onchip.cuh scale_exponent): e
    that puts mx in [0.5, 1), at most 126; 0 where mx is not positive."""
    e = torch.frexp(mx).exponent.clamp(max=126)
    return torch.where(mx > 0, e, torch.zeros_like(e))


def paired_grad_ckpt_ref(sched: torch.Tensor, rows: int, slots: int, P, dP,
                         tips, pi, props, weights):
    """Plain torch version of the checkpointed grad body: the schedule
    `sched` [B, L, CKPT_INTS] (ckpt_schedule) interpreted entry by entry in
    the operands' dtype, every tree at once, as the kernel runs it: rows
    and tier slots a pattern, each entry's tier and tip operands fetched
    before the entry before it stores, the rescales by powers of two.
    (LL rows [B, S], weighted gradient rows [B, N1, S], zero where no
    entry writes): finish_rows sums them."""
    B, L, _ = sched.shape
    N1, C, A = P.shape[1], P.shape[2], P.shape[3]
    T, S = tips.shape[0], tips.shape[-1]
    kw = dict(device=P.device, dtype=P.dtype)
    w, pi, props = weights.to(P.dtype), pi.to(P.dtype), props.to(P.dtype)
    tips = tips.to(P.dtype)
    on_chip = torch.zeros((B, rows, C, A, S), **kw)
    tier = torch.zeros((B, slots, C, A, S), **kw)
    ll_rows = torch.zeros((B, S), **kw)
    grad_rows = torch.zeros((B, N1, S), **kw)
    lsc = torch.zeros((B, S), dtype=torch.int64, device=P.device)
    b = torch.arange(B, device=P.device)
    sched = sched.long()

    def is_row(code):
        return (code >= 0) & (code < CKPT_TIER)

    def fetch(code):  # the operands that are not rows, at the fetch
        t = (-1 - code).clamp(0, T - 1)
        v = torch.where(((code < 0) & (code >= -T))[:, None, None, None],
                        tips[t][:, None].expand(B, C, A, S),
                        torch.ones((), **kw))
        v = torch.where((code == CKPT_PI)[:, None, None, None],
                        pi[None, None, :, None], v)
        at = (code - CKPT_TIER).clamp(0, slots - 1)
        return torch.where((code >= CKPT_TIER)[:, None, None, None],
                           tier[b, at], v)

    def operand(code, fetched):
        return torch.where(is_row(code)[:, None, None, None],
                           on_chip[b, code.clamp(0, rows - 1)], fetched)

    def put(code, value, mask):
        row, at = mask & is_row(code), mask & (code >= CKPT_TIER)
        on_chip[b[row], code[row]] = value[row]
        tier[b[at], code[at] - CKPT_TIER] = value[at]

    def evolve(edges, x, mats=P):  # M[edge] x over [B, C, A, S]
        return mats[b, edges] @ x

    fetched = [fetch(sched[:, 0, f]) for f in (2, 3, 4)]
    for i in range(L):
        nxt = sched[:, min(i + 1, L - 1)]
        ahead = [fetch(nxt[:, f]) for f in (2, 3, 4)]
        e = sched[:, i]
        kind, e0, e1 = e[:, 0], e[:, 1] & 0xFFFF, (e[:, 1] >> 16) & 0xFFFF
        p0, p1 = operand(e[:, 2], fetched[0]), operand(e[:, 3], fetched[1])
        ev0, ev1 = evolve(e0, p0), evolve(e1, p1)
        # a postorder entry: the product, rescaled
        post = (kind == CKPT_POST) | (kind == CKPT_ROOT)
        prod = ev0 * ev1
        ex = _pow2_exponent(prod.amax(dim=(1, 2)))
        prod = torch.ldexp(prod, -ex[:, None, None])
        lsc = torch.where(post[:, None], lsc + ex, lsc)
        site = torch.einsum("c,a,bcas->bs", props, pi, prod)
        at_root = kind == CKPT_ROOT
        ll_rows[at_root] = (torch.log(site) + lsc.to(P.dtype)
                            * math.log(2.0))[at_root]
        put(e[:, 5], prod, kind == CKPT_POST)
        put(e[:, 6], prod, kind == CKPT_POST)
        # an outside entry: both children's gradient rows and outside values
        out = kind == CKPT_OUT
        upv = operand(e[:, 4], fetched[2])
        o0, o1 = upv * ev1, upv * ev0
        inv = _pow2_exponent(torch.maximum(o0, o1).amax(dim=(1, 2)))
        o = [torch.ldexp(x, -inv[:, None, None]) for x in (o0, o1)]
        for j, (edges, p, ev) in enumerate(((e0, p0, ev0), (e1, p1, ev1))):
            num = torch.einsum("c,bcas->bs", props,
                               o[j] * evolve(edges, p, dP))
            den = torch.einsum("c,bcas->bs", props, o[j] * ev)
            den = torch.where(den > 0, den, torch.ones_like(den))
            src = (e[:, 7] >> (16 * j)) & 0xFFFF
            grad_rows[b[out], src[out]] = (w * num / den)[out]
            put(e[:, 5 + j], P[b, edges].transpose(-1, -2) @ o[j], out)
        fetched = ahead
    return ll_rows, grad_rows


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 as cvt.rna.tf32.f32 rounds it: 10
    explicit mantissa bits, ties away from zero (on the magnitude's bits,
    by integer view)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def tf32_mm(a: torch.Tensor, b: torch.Tensor, passes: int = 3):
    """a @ b in float32 as the A=64 kernels form it on the tensor cores:
    each operand split as hi = tf32(x), lo = tf32(x - hi); for each block
    of 8 along K, acc += lo hi, then hi lo, then hi hi (passes=3, 3xTF32),
    or hi hi alone (passes=1, one TF32 pass).  A product of two TF32
    values is exact in float32; the sums round in float32."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    a, b = a.float(), b.float()
    ahi, bhi = tf32_round(a), tf32_round(b)
    alo, blo = tf32_round(a - ahi), tf32_round(b - bhi)
    acc = 0.0
    for k in range(0, a.shape[-1], 8):
        ks = slice(k, k + 8)
        if passes == 3:
            acc = acc + alo[..., ks] @ bhi[..., ks, :]
            acc = acc + ahi[..., ks] @ blo[..., ks, :]
        acc = acc + ahi[..., ks] @ bhi[..., ks, :]
    return acc


def paired_ll_and_gradients_tf32(post_dst, tip_slot, post_src, post_e,
                                 edge_mask, P, dP, tips, pi, props, weights,
                                 passes: int = 3):
    """The A=64 kernels' arithmetic in plain torch, for the tests: the walk
    of paired_ll_and_gradients_ref in float32 on the CPU with every P p,
    dP p and P^T o through tf32_mm(passes), rescaled as the kernels
    rescale (csrc/paired_a64.cuh): each category of an output stored
    scaled by 2^-e, e the exponent of its largest entry, the slot's E the
    largest e over the categories, and a reader's factor 2^(e - E).
    (ll [B], branch gradients [B, N])."""
    B, M = post_dst.shape
    T = tip_slot.shape[1]
    N1, C, A = P.shape[1], P.shape[2], P.shape[3]
    S = tips.shape[-1]
    f = dict(dtype=torch.float32)
    P, dP, tips = P.float(), dP.float(), tips.float()
    w, pi, props = weights.float(), pi.float(), props.float()
    mm = partial(tf32_mm, passes=passes)
    b = torch.arange(B)

    def exponent(x, dims):  # e of x's largest entry over dims, >= -126
        mx = x.amax(dim=dims)
        return torch.frexp(mx).exponent.clamp(min=-126).masked_fill(
            mx <= 0, -126)

    def scale(x, e):  # x [..., C, A, S] by 2^e, e [..., C, S]
        return torch.ldexp(x, e.unsqueeze(-2).float())

    NS = 2 * M + 3
    buf = torch.ones((B, NS, C, A, S), **f)
    e_cat = torch.zeros((B, NS, C, S), dtype=torch.int32)
    E = torch.zeros((B, NS, S), dtype=torch.int32)
    ls = torch.zeros((B, NS, S), **f)
    buf[b[:, None], tip_slot.long()] = tips[None, :, None].expand(
        B, T, C, A, S)
    dst_all, e_all, src_all = post_dst.long(), post_e.long(), post_src.long()
    root = 2 * M
    site = torch.zeros((B, S), **f)
    for m in range(M):
        pair = slice(2 * m, 2 * m + 2)
        ev = scale(mm(P[b[:, None], e_all[:, m]], buf[:, pair]),
                   e_cat[:, pair] - E[:, pair, None])
        q = ev[:, 0] * ev[:, 1]
        dst = dst_all[:, m]
        at_root = (dst == root)[:, None]
        site = torch.where(at_root, torch.einsum("c,a,bcas->bs", props, pi,
                                                 q), site)
        e = exponent(q, 2)
        buf[b, dst] = scale(q, -e)
        e_cat[b, dst] = e
        E[b, dst] = torch.where(at_root, 0, e.amax(dim=1))
        ls[b, dst] = ls[:, pair].sum(dim=1) + E[b, dst]
    ll = (torch.log(site) + ls[:, root] * math.log(2.0)) @ w
    buf[:, root] = pi[None, None, :, None].expand(B, C, A, S)
    e_cat[:, root] = 0
    grad_rows = torch.zeros((B, N1, S), **f)
    for m in range(M - 1, -1, -1):
        pair = slice(2 * m, 2 * m + 2)
        e = e_all[:, m]
        P2, dP2 = P[b[:, None], e], dP[b[:, None], e]
        rel = e_cat[:, pair] - E[:, pair, None]
        ev, dv = scale(mm(P2, buf[:, pair]), rel), scale(mm(dP2, buf[:, pair]),
                                                        rel)
        dst = dst_all[:, m]
        up = scale(buf[b, dst], e_cat[b, dst] - E[b, dst][:, None])
        o = up[:, None] * ev.flip(1)
        eo = exponent(o, (1, 3))  # [B, C, S]
        os = scale(o, -eo[:, None])
        rel_o = (eo - eo.amax(dim=1, keepdim=True))[:, None, :, None]
        den = torch.einsum("c,bjcas->bjs", props,
                           torch.ldexp(os * ev, rel_o.float()))
        num = torch.einsum("c,bjcas->bjs", props,
                           torch.ldexp(os * dv, rel_o.float()))
        den = torch.where(den > 0, den, torch.ones_like(den))
        grad_rows[b[:, None], src_all[:, m]] = w * num / den
        buf[:, pair] = mm(P2.transpose(-1, -2), os)
        e_cat[:, pair] = eo[:, None]
        E[:, pair] = eo.amax(dim=1)[:, None]
    N = edge_mask.shape[1]
    return ll, grad_rows.sum(dim=-1)[:, :N] * edge_mask.float()


# ---------------------------------------------------------------------------
# Public wrappers and the bodies' launchers
# ---------------------------------------------------------------------------

def on_cpu(t: torch.Tensor) -> bool:
    """Whether a wrapper given `t` runs its kernel's plain version: only
    because the tensor lies on the CPU.  On the card it launches a body or
    raises."""
    return t.device.type == "cpu"


def check_categories(C: int) -> None:
    """Raise unless C is a category count: the kernels take any C >= 1;
    what bounds it is the card's memory, which their launchers check."""
    if C < 1:
        raise ValueError(f"the kernels take 1 or more rate categories, "
                         f"got {C}")


def _check_cuda_operands(ints, floats, C, A, states=(4,)):
    """Raise unless every operand is a contiguous CUDA tensor of its
    dtype (int32 or float32), A is one of `states` and C is a category
    count (check_categories)."""
    _check_cuda_tensors(ints, floats)
    if A not in states:
        raise ValueError(f"the kernels take {' or '.join(map(str, states))}"
                         f"-state models, got A={A}")
    check_categories(C)


def _check_cuda_tensors(ints, floats):
    """Raise unless every tensor is a contiguous CUDA tensor of its dtype
    (int32 or float32)."""
    for name, t in {**ints, **floats}.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, the kernel needs CUDA")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def _check_shapes(post_dst, tip_slot, post_e, P, tips, pi, props, weights):
    B, M = post_dst.shape
    T = tip_slot.shape[1]
    N1, C, A = P.shape[1], P.shape[2], P.shape[3]
    S = tips.shape[-1]
    expect = {
        "tip_slot": (tip_slot, (B, T)), "post_e": (post_e, (B, M, 2)),
        "P": (P, (B, N1, C, A, A)), "tips": (tips, (T, A, S)),
        "pi": (pi, (A,)), "props": (props, (C,)), "weights": (weights, (S,)),
    }
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    return B, M, T, N1, C, A, S


def _check_onchip(onchip: OnchipTape, post_dst, tips, mats):
    B, M = post_dst.shape
    if tuple(onchip.child.shape) != (B, M, 2) or tuple(
            onchip.live_row.shape) != (B, M):
        raise ValueError("the on-chip tape does not match post_dst")
    if tips.numel() >= 2**31:  # the kernels index tips with 32-bit offsets
        raise ValueError(f"tips has {tips.numel()} entries, the on-chip "
                         "bodies take fewer than 2**31")
    _check_cuda_tensors(dict(child=onchip.child, live_row=onchip.live_row),
                        {})
    for name, t in mats.items():  # cp.async copies 16-byte rows
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _onchip_plan(kernel, onchip, M, N1, C):
    """The plan of a launch of `kernel` ("ll" or "grad"): None where the
    global body takes the tape."""
    if onchip is None:
        raise ValueError("the paired kernels need the tape's OnchipTape on "
                         "the card: pass onchip=paired.onchip_tape(...)")
    rows = onchip.ll_rows if kernel == "ll" else onchip.grad_rows
    return onchip_plan(kernel, rows, M, N1, C)


def finish_rows(ll_rows, grad_rows, edge_mask, weights):
    """(ll [B], grads [B, N]) from a body's per-pattern rows: the weighted
    sums over patterns.  Gradient rows of nodes without a branch (the
    root's, the trash row) are masked out, whatever they hold."""
    sums = grad_rows.sum(dim=-1)[:, : edge_mask.shape[1]]
    return ll_rows @ weights, torch.where(
        edge_mask != 0, sums * edge_mask, torch.zeros((), device=sums.device))


def paired_log_likelihoods(post_dst, tip_slot, post_e, P, tips, pi, props,
                           weights, *,
                           onchip: OnchipTape | None = None) -> torch.Tensor:
    """Per-tree log likelihoods [B] over the paired-slot tape.

    On the card it launches, at 4 states, the on-chip body where
    onchip_plan gives a plan, else the global body, and `onchip`, the
    tape's OnchipTape, is required there; at 64 states the A=64 body,
    which needs none.  The CPU runs the plain version."""
    if on_cpu(P):
        with timing.span("launch"):
            return paired_log_likelihoods_ref(post_dst, tip_slot, post_e, P,
                                              tips, pi, props, weights)
    with timing.span("launch"):
        B, M, T, N1, C, A, S = _check_shapes(post_dst, tip_slot, post_e, P,
                                             tips, pi, props, weights)
        _check_cuda_operands(
            dict(post_dst=post_dst, tip_slot=tip_slot, post_e=post_e),
            dict(P=P, tips=tips, pi=pi, props=props, weights=weights), C, A,
            KERNEL_STATES)
        if A == 64:
            ll_rows = paired_ll_a64(post_dst, tip_slot, post_e, P, tips, pi,
                                    props)
        elif (plan := _onchip_plan("ll", onchip, M, N1, C)) is None:
            ll_rows = paired_ll_global(post_dst, tip_slot, post_e, P, tips,
                                       pi, props)
        else:
            ll_rows = paired_ll_onchip(post_dst, onchip, post_e, P, tips, pi,
                                       props, plan)
    with timing.span("finish"):
        return ll_rows @ weights


def paired_ll_and_gradients(post_dst, tip_slot, post_src, post_e, edge_mask,
                            P, dP, tips, pi, props, weights, *,
                            onchip: OnchipTape | None = None):
    """Per-tree (log likelihood [B], branch gradients [B, N]), by the body
    and with the `onchip` tape as in paired_log_likelihoods."""
    if on_cpu(P):
        with timing.span("launch"):
            return paired_ll_and_gradients_ref(post_dst, tip_slot, post_src,
                                               post_e, edge_mask, P, dP, tips,
                                               pi, props, weights)
    with timing.span("launch"):
        B, M, T, N1, C, A, S = _check_shapes(post_dst, tip_slot, post_e, P,
                                             tips, pi, props, weights)
        if (tuple(post_src.shape) != (B, M, 2)
                or tuple(dP.shape) != tuple(P.shape)):
            raise ValueError("post_src or dP does not match the tape and P")
        if tuple(edge_mask.shape) != (B, N1 - 1):
            raise ValueError(f"edge_mask has shape {tuple(edge_mask.shape)}, "
                             f"expected {(B, N1 - 1)}")
        _check_cuda_operands(
            dict(post_dst=post_dst, tip_slot=tip_slot, post_src=post_src,
                 post_e=post_e),
            dict(P=P, dP=dP, tips=tips, pi=pi, props=props, weights=weights,
                 edge_mask=edge_mask),
            C, A, KERNEL_STATES)
        if A == 64:
            rows = paired_grad_a64(post_dst, tip_slot, post_src, post_e, P,
                                   dP, tips, pi, props, weights)
        elif (plan := _onchip_plan("grad", onchip, M, N1, C)) is not None:
            rows = paired_grad_onchip(post_dst, onchip, post_src, post_e, P,
                                      dP, tips, pi, props, weights, plan)
        elif C <= COMPILED_CATEGORIES and N1 <= CKPT_MAX_EDGES:
            if onchip.ckpt is None or onchip.ckpt.sched.shape[0] != B:
                raise ValueError("the on-chip tape carries no checkpointed "
                                 "schedule of these tapes: build it with "
                                 "paired.onchip_tape from them and P's "
                                 "edges")
            rows = paired_grad_ckpt(onchip.ckpt, P, dP, tips, pi, props,
                                    weights)
        else:  # past 8 categories, or past the schedule's 16-bit fields
            rows = paired_grad_global(post_dst, tip_slot, post_src, post_e, P,
                                      dP, tips, pi, props, weights)
    with timing.span("finish"):
        return finish_rows(*rows, edge_mask, weights)


def paired_log_likelihoods_sharded(group, post_dst, tip_slot, post_e, P,
                                   tips, pi, props, weights, *,
                                   onchip: OnchipTape | None = None
                                   ) -> torch.Tensor:
    """Pattern-sharded paired_log_likelihoods: `tips` [T, A, S_r] and
    `weights` [S_r] are this rank's slice of the pattern axis
    (TreeLikelihoodEngine.shard_patterns), the rest whole on every rank.
    The same body runs on the slice, and one all_reduce over `group` sums
    the per-tree totals: every rank gets the whole alignment's LL [B]."""
    return mesh.all_reduce_sum(paired_log_likelihoods(
        post_dst, tip_slot, post_e, P, tips, pi, props, weights,
        onchip=onchip), group)


def paired_ll_and_gradients_sharded(group, post_dst, tip_slot, post_src,
                                    post_e, edge_mask, P, dP, tips, pi,
                                    props, weights, *,
                                    onchip: OnchipTape | None = None):
    """Pattern-sharded paired_ll_and_gradients, as
    paired_log_likelihoods_sharded: one all_reduce of LL [B] and one of
    the gradients [B, N] over `group`."""
    ll, grads = paired_ll_and_gradients(
        post_dst, tip_slot, post_src, post_e, edge_mask, P, dP, tips, pi,
        props, weights, onchip=onchip)
    return mesh.all_reduce_sum(ll, group), mesh.all_reduce_sum(grads, group)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def launch_ll_onchip(post_dst, onchip, post_e, P, tips, pi, props,
                     plan: OnchipPlan) -> torch.Tensor:
    """Launch csrc/paired_ll_onchip.cu as `plan` says on any tape of the
    paired layout walked one op at a time (operands checked by the
    caller): per-pattern LL rows [B, S].  `onchip` gives the child codes,
    the rows by liveness and their count (`child`, `live_row`, `ll_rows`).
    It counts no launch: each launcher that calls it counts its own."""
    _check_onchip(onchip, post_dst, tips, dict(P=P))
    B, M = post_dst.shape
    T, S = tips.shape[0], tips.shape[-1]
    N1, C = P.shape[1], P.shape[2]
    ll_rows = torch.empty((B, S), device=P.device, dtype=torch.float32)
    with torch.cuda.device(P.device):
        rc = _kernels.library().bito_paired_ll_onchip(
            post_dst.data_ptr(), onchip.child.data_ptr(),
            onchip.live_row.data_ptr(), post_e.data_ptr(), P.data_ptr(),
            tips.data_ptr(), pi.data_ptr(), props.data_ptr(),
            ll_rows.data_ptr(), B, M, T, N1, C, S, onchip.ll_rows,
            plan.cols, int(plan.ring), _stream())
    _kernels.check(rc, "bito_paired_ll_onchip")
    return ll_rows


def paired_ll_onchip(post_dst, onchip, post_e, P, tips, pi, props,
                     plan: OnchipPlan) -> torch.Tensor:
    """Launch csrc/paired_ll_onchip.cu on the paired tape as `plan` says
    (operands checked by the wrapper): per-pattern LL rows [B, S]."""
    ll_rows = launch_ll_onchip(post_dst, onchip, post_e, P, tips, pi, props,
                               plan)
    paired_ll_onchip.launches += 1
    return ll_rows


paired_ll_onchip.launches = 0


def launch_grad_onchip(post_dst, onchip, post_src, post_e, P, dP, tips, pi,
                       props, weights, plan: OnchipPlan):
    """Launch csrc/paired_grad_onchip.cu as `plan` says on any tape of the
    paired layout (operands checked by the caller): (LL rows [B, S],
    weighted gradient rows [B, N1, S], row post_src[m, j] for child j of
    op m; rows that no op writes are not written).  `onchip` gives the
    child codes and the rows a pattern (`child`, `grad_rows`).  It counts
    no launch: each launcher that calls it counts its own."""
    _check_onchip(onchip, post_dst, tips, dict(P=P, dP=dP))
    _check_cuda_tensors(dict(post_src=post_src), {})
    B, M = post_dst.shape
    T, S = tips.shape[0], tips.shape[-1]
    N1, C = P.shape[1], P.shape[2]
    kw = dict(device=P.device, dtype=torch.float32)
    ll_rows = torch.empty((B, S), **kw)
    grad_rows = torch.empty((B, N1, S), **kw)
    with torch.cuda.device(P.device):
        rc = _kernels.library().bito_paired_grad_onchip(
            post_dst.data_ptr(), onchip.child.data_ptr(),
            post_src.data_ptr(), post_e.data_ptr(), P.data_ptr(),
            dP.data_ptr(), tips.data_ptr(), pi.data_ptr(), props.data_ptr(),
            weights.data_ptr(), ll_rows.data_ptr(), grad_rows.data_ptr(),
            B, M, T, N1, C, S, onchip.grad_rows, plan.cols, int(plan.ring),
            _stream())
    _kernels.check(rc, "bito_paired_grad_onchip")
    return ll_rows, grad_rows


def paired_grad_onchip(post_dst, onchip, post_src, post_e, P, dP, tips, pi,
                       props, weights, plan: OnchipPlan):
    """Launch csrc/paired_grad_onchip.cu as `plan` says (operands checked
    by the wrapper): (LL rows [B, S], weighted gradient rows [B, N1, S];
    rows that no op writes are not written)."""
    rows = launch_grad_onchip(post_dst, onchip, post_src, post_e, P, dP,
                              tips, pi, props, weights, plan)
    paired_grad_onchip.launches += 1
    return rows


paired_grad_onchip.launches = 0


# Threads a block of the global bodies' lane layout (past 8 categories,
# csrc/paired_lanes.cuh kThreads): 128 / G patterns a block.
GLOBAL_THREADS = 128
SCRATCH_HEADROOM = 256 << 20  # device bytes left free beside the scratch
GRID_TREES = 65535  # trees one launch takes: the grid's y extent


def tree_slices(B: int, tree_bytes: int,
                budget: int) -> list[tuple[int, int]]:
    """The launchers' slices of a batch of B trees: consecutive [start,
    stop) ranges that cover it in order, each of as many trees as
    `budget` bytes hold at `tree_bytes` a tree (and at most GRID_TREES),
    so one slice where the whole batch fits.  Raises where one tree does
    not fit."""
    if tree_bytes > budget:
        raise torch.cuda.OutOfMemoryError(
            f"the kernels' scratch takes {tree_bytes} bytes a tree; "
            f"{budget} bytes of device memory are free for it")
    n = min(budget // tree_bytes, GRID_TREES)
    return [(b, min(b + n, B)) for b in range(0, B, n)]


def scratch_budget(device) -> int:
    """Bytes of `device`'s memory a launcher's scratch may take: what the
    card has free, with what torch's cache holds unused and can release
    (not the unused parts of split segments), less SCRATCH_HEADROOM."""
    stats = torch.cuda.memory_stats(device)
    cached = (stats.get("reserved_bytes.all.current", 0)
              - stats.get("allocated_bytes.all.current", 0)
              - stats.get("inactive_split_bytes.all.current", 0))
    return torch.cuda.mem_get_info(device)[0] + cached - SCRATCH_HEADROOM


def launch_sliced(entry, B, alloc, launch, device,
                  tree_bytes: int | None = None) -> int:
    """Launch `entry` (a C entry point's name) over B trees: once a
    GRID_TREES trees where the scratch of that many can be allocated, else
    once a slice of tree_slices under scratch_budget, into one scratch
    sized for the largest slice.  alloc(n, device) returns the scratch
    tensors of n trees; a tree's bytes are `tree_bytes`, or where None
    reckoned from the allocation itself, alloc(1) on the meta device;
    launch(b0, b1, *scratch) launches trees [b0, b1) and returns its
    code.  The allocation is the
    test of what fits: it costs the call no query of the card
    (cudaMemGetInfo or torch's statistics), host time that a call waiting
    on the host pays.  Returns the launches."""
    try:
        slices = [(b, min(b + GRID_TREES, B))
                  for b in range(0, B, GRID_TREES)]
        scratch = alloc(min(B, GRID_TREES), device)
    except torch.cuda.OutOfMemoryError:
        if tree_bytes is None:
            tree_bytes = sum(t.numel() * t.element_size()
                             for t in alloc(1, "meta"))
        slices = tree_slices(B, tree_bytes, scratch_budget(device))
        scratch = alloc(max(b1 - b0 for b0, b1 in slices), device)
    with torch.cuda.device(device):
        for b0, b1 in slices:
            _kernels.check(launch(b0, b1, *scratch), entry)
    return len(slices)


def global_scratch(NS: int, C: int, S: int):
    """alloc(n, device) of the global bodies' scratch over NS slots a
    tree: at 1..8 categories the slots [n, NS, C*4, S] and their log
    scales [n, NS, S]; past 8 the lane layout's slots [n, NS, Sp, G, 4]
    (Sp = S rounded up to a block's GLOBAL_THREADS // G patterns), and
    past 32 [n, NS, Sp, K, 32, 4] (K = lane_categories(C)), with no log
    scales (csrc/paired_lanes.cuh)."""
    def alloc(n, device):
        kw = dict(device=device, dtype=torch.float32)
        if C <= COMPILED_CATEGORIES:
            return (torch.empty((n, NS, C * 4, S), **kw),
                    torch.empty((n, NS, S), **kw))
        G = lanes(C)
        Sp = _rup(S, GLOBAL_THREADS // G)
        shape = ((n, NS, Sp, G, 4) if C <= ONCHIP_CATEGORIES
                 else (n, NS, Sp, lane_categories(C), G, 4))
        return torch.empty(shape, **kw), torch.empty(0, **kw)
    return alloc


def paired_ll_global(post_dst, tip_slot, post_e, P, tips, pi, props):
    """Launch csrc/paired_ll.cu (operands checked by the wrapper):
    per-pattern LL rows [B, S].  Its scratch (global_scratch) is
    allocated here, for the batch where it can be, else over slices of
    trees (launch_sliced), each a launch."""
    B, M = post_dst.shape
    T, S = tips.shape[0], tips.shape[-1]
    N1, C = P.shape[1], P.shape[2]
    ll_rows = torch.empty((B, S), device=P.device, dtype=torch.float32)
    lib = _kernels.library()
    n = launch_sliced(
        "bito_paired_ll", B, global_scratch(2 * M + 3, C, S),
        lambda b0, b1, buf, ls: lib.bito_paired_ll(
            post_dst[b0:b1].data_ptr(), tip_slot[b0:b1].data_ptr(),
            post_e[b0:b1].data_ptr(), P[b0:b1].data_ptr(), tips.data_ptr(),
            pi.data_ptr(), props.data_ptr(), buf.data_ptr(), ls.data_ptr(),
            ll_rows[b0:b1].data_ptr(), b1 - b0, M, T, N1, C, S, _stream()),
        P.device)
    paired_ll_global.launches += n
    timing.count("global_launches", n)
    return ll_rows


paired_ll_global.launches = 0


def paired_grad_global(post_dst, tip_slot, post_src, post_e, P, dP, tips, pi,
                       props, weights):
    """Launch csrc/paired_grad.cu (operands checked by the wrapper): (LL
    rows [B, S], weighted gradient rows [B, N1, S], zero where no op
    writes), with the scratch and the slices of paired_ll_global."""
    B, M = post_dst.shape
    T, S = tips.shape[0], tips.shape[-1]
    N1, C = P.shape[1], P.shape[2]
    kw = dict(device=P.device, dtype=torch.float32)
    ll_rows = torch.empty((B, S), **kw)
    grad_rows = torch.zeros((B, N1, S), **kw)
    lib = _kernels.library()
    n = launch_sliced(
        "bito_paired_grad", B, global_scratch(2 * M + 3, C, S),
        lambda b0, b1, buf, ls: lib.bito_paired_grad(
            post_dst[b0:b1].data_ptr(), tip_slot[b0:b1].data_ptr(),
            post_src[b0:b1].data_ptr(), post_e[b0:b1].data_ptr(),
            P[b0:b1].data_ptr(), dP[b0:b1].data_ptr(), tips.data_ptr(),
            pi.data_ptr(), props.data_ptr(), weights.data_ptr(),
            buf.data_ptr(), ls.data_ptr(), ll_rows[b0:b1].data_ptr(),
            grad_rows[b0:b1].data_ptr(), b1 - b0, M, T, N1, C, S,
            _stream()),
        P.device)
    paired_grad_global.launches += n
    timing.count("global_launches", n)
    return ll_rows, grad_rows


paired_grad_global.launches = 0


def ckpt_scratch(slots: int, S: int, C: int, plan: OnchipPlan):
    """alloc(n, device) of the checkpointed body's device tier: float4
    [n, slots, Sp, G] (Sp = S rounded up to the plan's patterns a block,
    so each thread of the grid owns its slices; G = lanes(C)), a lane's 16
    bytes beside its neighbours' for coalesced loads."""
    Sp = _rup(S, plan.cols)

    def alloc(n, device):
        return (torch.empty((n, slots, Sp, lanes(C), 4), device=device,
                            dtype=torch.float32),)
    return alloc


def paired_grad_ckpt(ckpt: CkptTape, P, dP, tips, pi, props, weights):
    """Launch csrc/paired_grad_ckpt.cu over the schedule `ckpt` as
    ckpt_plan says (operands checked by the wrapper): (LL rows [B, S],
    weighted gradient rows [B, N1, S]; rows that no entry writes are not
    written).  Its device tier (ckpt_scratch) is allocated here,
    for the batch where it can be, else over slices of trees
    (launch_sliced), each a launch, counted in `.launches` and as the
    program's counter `checkpoint_launches`."""
    B, L, _ = ckpt.sched.shape
    T, S = tips.shape[0], tips.shape[-1]
    N1, C = P.shape[1], P.shape[2]
    plan = ckpt_plan(ckpt.rows, C)
    if ckpt.slots * _rup(S, plan.cols) * plan.lanes >= 2**31:
        raise ValueError("the checkpointed body indexes a tree's tier with "
                         "32-bit offsets: too many slots and patterns")
    if tips.numel() >= 2**31:  # the kernel indexes tips with 32-bit offsets
        raise ValueError(f"tips has {tips.numel()} entries, the "
                         "checkpointed body takes fewer than 2**31")
    _check_cuda_tensors(dict(sched=ckpt.sched), {})
    for name, t in dict(sched=ckpt.sched, P=P, dP=dP).items():
        if t.data_ptr() % 16:  # int4 loads and cp.async of 16-byte rows
            raise ValueError(f"{name} is not 16-byte aligned")
    kw = dict(device=P.device, dtype=torch.float32)
    ll_rows = torch.empty((B, S), **kw)
    grad_rows = torch.empty((B, N1, S), **kw)
    lib = _kernels.library()
    n = launch_sliced(
        "bito_paired_grad_ckpt", B, ckpt_scratch(ckpt.slots, S, C, plan),
        lambda b0, b1, tier: lib.bito_paired_grad_ckpt(
            ckpt.sched[b0:b1].data_ptr(), P[b0:b1].data_ptr(),
            dP[b0:b1].data_ptr(), tips.data_ptr(), pi.data_ptr(),
            props.data_ptr(), weights.data_ptr(), tier.data_ptr(),
            ll_rows[b0:b1].data_ptr(), grad_rows[b0:b1].data_ptr(), b1 - b0,
            L, T, N1, C, S, ckpt.slots, ckpt.rows, plan.cols, _stream()),
        P.device)
    paired_grad_ckpt.launches += n
    timing.count("checkpoint_launches", n)
    return ll_rows, grad_rows


paired_grad_ckpt.launches = 0


def _a64_operands(tips, weights=None, **mats):
    """(tips, weights, S) for the A=64 kernels: tips (and weights) with the
    pattern axis padded to a multiple of 4 where it is not one, since the
    kernels copy [64, S] rows in 16-byte pieces (padded patterns: tips of
    ones, weight 0; their rows are cut off by the caller); S the true
    pattern count.  Raises where an operand is not 16-byte aligned."""
    S = tips.shape[-1]
    pad = -S % 4
    if pad:
        tips = torch.nn.functional.pad(tips, (0, pad), value=1.0)
        if weights is not None:
            weights = torch.nn.functional.pad(weights, (0, pad))
    for name, t in dict(tips=tips, **mats).items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    return tips, weights, S


A64_TILE = 128  # patterns a block of the A=64 kernels (bito_paired_a64_tile)


def _a64_tree_words(M, S, C):
    """One tree's 4-byte words in the A=64 kernels' scratch, laid out as
    csrc/paired_a64.cuh says: (buf [NS, C, 64, S] floats, then the scales
    [NS, 2 + C, S] floats and the slot codes [tiles, NS] ints, tiles the
    blocks' pattern tiles of A64_TILE), NS = 2M + 3."""
    NS = 2 * M + 3
    return NS * C * 64 * S, NS * (2 + C) * S + -(-S // A64_TILE) * NS


def _a64_scratch(B, M, S, C, device):
    """The A=64 kernels' scratch for B trees: the partials buf [B, 2M+3,
    C, 64, S] and one float32 block of the scales and slot codes."""
    _, rest = _a64_tree_words(M, S, C)
    kw = dict(device=device, dtype=torch.float32)
    return (torch.empty((B, 2 * M + 3, C, 64, S), **kw),
            torch.empty(B * rest, **kw))


def a64_tree_bytes(M: int, S: int, C: int) -> int:
    """Bytes of the A=64 kernels' scratch for one tree of M padded ops over
    S patterns (a multiple of 4) at C categories: its slice of
    _a64_scratch."""
    return 4 * sum(_a64_tree_words(M, S, C))


@functools.cache
def _a64_library():
    """The kernel library, once its A=64 kernels' tile is A64_TILE."""
    lib = _kernels.library()
    tile = lib.bito_paired_a64_tile()
    if tile != A64_TILE:
        raise RuntimeError(f"the A=64 kernels take {tile} patterns a "
                           f"block; paired.A64_TILE is {A64_TILE}")
    return lib


def _launch_a64(entry, B, M, S, C, device, launch) -> int:
    """launch_sliced of `entry` over B trees with the A=64 kernels'
    scratch (_a64_scratch, looked up at each call; a64_tree_bytes a
    tree).  Returns the launches."""
    return launch_sliced(
        entry, B, lambda n, dev: _a64_scratch(n, M, S, C, dev), launch,
        device, a64_tree_bytes(M, S, C))


def paired_ll_a64(post_dst, tip_slot, post_e, P, tips, pi, props):
    """Launch csrc/paired_ll_a64.cu (operands checked by the wrapper):
    per-pattern LL rows [B, S] at 64 states.  Its scratch is allocated
    here (_a64_scratch), for the trees of one launch: one for the batch
    where it can be allocated, else one a slice of trees (_launch_a64)."""
    B, M = post_dst.shape
    T = tips.shape[0]
    N1, C = P.shape[1], P.shape[2]
    tips, _, S = _a64_operands(tips, P=P)
    Sp = tips.shape[-1]
    ll_rows = torch.empty((B, Sp), device=P.device, dtype=torch.float32)
    lib = _a64_library()
    paired_ll_a64.launches += _launch_a64(
        "bito_paired_ll_a64", B, M, Sp, C, P.device,
        lambda b0, b1, buf, scratch: lib.bito_paired_ll_a64(
            post_dst[b0:b1].data_ptr(), tip_slot[b0:b1].data_ptr(),
            post_e[b0:b1].data_ptr(), P[b0:b1].data_ptr(), tips.data_ptr(),
            pi.data_ptr(), props.data_ptr(), buf.data_ptr(),
            scratch.data_ptr(), ll_rows[b0:b1].data_ptr(), b1 - b0, M, T,
            N1, C, Sp, _stream()))
    return ll_rows[:, :S]


paired_ll_a64.launches = 0


def paired_grad_a64(post_dst, tip_slot, post_src, post_e, P, dP, tips, pi,
                    props, weights):
    """Launch csrc/paired_grad_a64.cu (operands checked by the wrapper):
    (LL rows [B, S], weighted gradient rows [B, N1, S], zero where no op
    writes) at 64 states, with the scratch and the slices of trees of
    paired_ll_a64."""
    B, M = post_dst.shape
    T = tips.shape[0]
    N1, C = P.shape[1], P.shape[2]
    tips, weights, S = _a64_operands(tips, weights, P=P, dP=dP)
    Sp = tips.shape[-1]
    kw = dict(device=P.device, dtype=torch.float32)
    ll_rows = torch.empty((B, Sp), **kw)
    grad_rows = torch.zeros((B, N1, Sp), **kw)
    lib = _a64_library()
    paired_grad_a64.launches += _launch_a64(
        "bito_paired_grad_a64", B, M, Sp, C, P.device,
        lambda b0, b1, buf, scratch: lib.bito_paired_grad_a64(
            post_dst[b0:b1].data_ptr(), tip_slot[b0:b1].data_ptr(),
            post_src[b0:b1].data_ptr(), post_e[b0:b1].data_ptr(),
            P[b0:b1].data_ptr(), dP[b0:b1].data_ptr(), tips.data_ptr(),
            pi.data_ptr(), props.data_ptr(), weights.data_ptr(),
            buf.data_ptr(), scratch.data_ptr(), ll_rows[b0:b1].data_ptr(),
            grad_rows[b0:b1].data_ptr(), b1 - b0, M, T, N1, C, Sp,
            _stream()))
    return ll_rows[:, :S], grad_rows[..., :S]


paired_grad_a64.launches = 0
