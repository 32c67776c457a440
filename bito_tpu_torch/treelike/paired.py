"""Paired-slot tapes and the two tree-likelihood kernels of the main path.

Counterpart of bito_tpu.treelike.pallas_paired.  The paired-slot layout is
kept: the partial of a node lives in the slot where its parent's op reads
it, so op m's two children are always slots (2m, 2m+1), and the outside
pass can write each op's up pair over those slots in place.
`build_paired_encoding` is a numpy copy of bito_tpu's, pinned equal to it
by tests/test_torch_encode.py.

Each kernel has three functions here:
  - the plain torch version (`*_ref`), which computes the same numbers and
    is what the CPU runs and what the kernel is checked against;
  - the public wrapper (`paired_log_likelihoods`, `paired_ll_and_gradients`):
    a CPU tensor goes to the plain version; a CUDA tensor goes to the
    hand-written kernel (csrc/paired_ll.cu, csrc/paired_grad.cu), and the
    call raises if the kernel cannot take the inputs or fails to launch;
  - a launch count, `wrapper.launches`, that the wrapper raises by one
    where it launches the kernel and nowhere else.

Operands (built by treelike/prep.py):
  post_dst [B, M], tip_slot [B, T], post_src / post_e [B, M, 2] int32 tapes;
  P, dP [B, N+1, C, 4, 4]; tips [T, 4, S]; pi [4]; props [C]; weights [S];
  edge_mask [B, N].

Both versions rescale after every op (bito_tpu's kernel: every fourth);
the log scales keep the log likelihoods exact and the gradient rows are
ratios that no scale changes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import _kernels

RESK = 4  # the tape is padded to a multiple of this many ops, as in bito_tpu
MAX_CATEGORIES = 8  # the category counts the kernels are compiled for


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


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------

def _check_cuda_operands(ints, floats, C, A):
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
    if A != 4:
        raise ValueError(f"the kernels take 4-state models, got A={A}")
    if not 1 <= C <= MAX_CATEGORIES:
        raise ValueError(f"the kernels take 1..{MAX_CATEGORIES} rate "
                         f"categories, got {C}")


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


def paired_log_likelihoods(post_dst, tip_slot, post_e, P, tips, pi, props,
                           weights) -> torch.Tensor:
    """Per-tree log likelihoods [B] over the paired-slot tape."""
    if P.device.type == "cpu":
        return paired_log_likelihoods_ref(post_dst, tip_slot, post_e, P,
                                          tips, pi, props, weights)
    B, M, T, N1, C, A, S = _check_shapes(post_dst, tip_slot, post_e, P, tips,
                                         pi, props, weights)
    _check_cuda_operands(
        dict(post_dst=post_dst, tip_slot=tip_slot, post_e=post_e),
        dict(P=P, tips=tips, pi=pi, props=props, weights=weights), C, A)
    NS = 2 * M + 3
    kw = dict(device=P.device, dtype=torch.float32)
    buf = torch.empty((B, NS, C * A, S), **kw)
    ls = torch.empty((B, NS, S), **kw)
    ll_rows = torch.empty((B, S), **kw)
    lib = _kernels.library()
    with torch.cuda.device(P.device):
        rc = lib.bito_paired_ll(
            post_dst.data_ptr(), tip_slot.data_ptr(), post_e.data_ptr(),
            P.data_ptr(), tips.data_ptr(), pi.data_ptr(), props.data_ptr(),
            buf.data_ptr(), ls.data_ptr(), ll_rows.data_ptr(),
            B, M, T, N1, C, S, torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "bito_paired_ll")
    paired_log_likelihoods.launches += 1
    return ll_rows @ weights


paired_log_likelihoods.launches = 0


def paired_ll_and_gradients(post_dst, tip_slot, post_src, post_e, edge_mask,
                            P, dP, tips, pi, props, weights):
    """Per-tree (log likelihood [B], branch gradients [B, N])."""
    if P.device.type == "cpu":
        return paired_ll_and_gradients_ref(post_dst, tip_slot, post_src,
                                           post_e, edge_mask, P, dP, tips,
                                           pi, props, weights)
    B, M, T, N1, C, A, S = _check_shapes(post_dst, tip_slot, post_e, P, tips,
                                         pi, props, weights)
    if tuple(post_src.shape) != (B, M, 2) or tuple(dP.shape) != tuple(P.shape):
        raise ValueError("post_src or dP does not match the tape and P")
    if tuple(edge_mask.shape) != (B, N1 - 1):
        raise ValueError(f"edge_mask has shape {tuple(edge_mask.shape)}, "
                         f"expected {(B, N1 - 1)}")
    _check_cuda_operands(
        dict(post_dst=post_dst, tip_slot=tip_slot, post_src=post_src,
             post_e=post_e),
        dict(P=P, dP=dP, tips=tips, pi=pi, props=props, weights=weights,
             edge_mask=edge_mask),
        C, A)
    NS = 2 * M + 3
    kw = dict(device=P.device, dtype=torch.float32)
    buf = torch.empty((B, NS, C * A, S), **kw)
    ls = torch.empty((B, NS, S), **kw)
    ll_rows = torch.empty((B, S), **kw)
    grad_rows = torch.zeros((B, N1, S), **kw)
    lib = _kernels.library()
    with torch.cuda.device(P.device):
        rc = lib.bito_paired_grad(
            post_dst.data_ptr(), tip_slot.data_ptr(), post_src.data_ptr(),
            post_e.data_ptr(), P.data_ptr(), dP.data_ptr(), tips.data_ptr(),
            pi.data_ptr(), props.data_ptr(), weights.data_ptr(),
            buf.data_ptr(), ls.data_ptr(), ll_rows.data_ptr(),
            grad_rows.data_ptr(), B, M, T, N1, C, S,
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "bito_paired_grad")
    paired_ll_and_gradients.launches += 1
    ll = ll_rows @ weights
    grads = grad_rows.sum(dim=-1)[:, : N1 - 1] * edge_mask
    return ll, grads


paired_ll_and_gradients.launches = 0
