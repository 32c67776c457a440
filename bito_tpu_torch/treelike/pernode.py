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

Each kernel has three functions here, as in paired.py:
  - the plain torch version (`*_ref`): the scan tape's own postorder,
    root and fused preorder (pruning.py) on the kernels' compact operands;
  - the public wrapper: a CPU tensor goes to the plain version; a CUDA
    tensor goes to the hand-written kernel (csrc/pernode_ll.cu,
    csrc/pernode_grad.cu), and the call raises if the kernel cannot take
    the inputs or fails to launch;
  - a launch count, `wrapper.launches`.

Operands: post_ops, pre_ops, root int32; P, dP [B, N+1, C, 4, 4]; tips
[T, 4, S]; pi [4]; props [C]; weights [S]; edge_mask [B, N].
"""
from __future__ import annotations

import torch

from . import _kernels, pruning
from .paired import _check_cuda_operands


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
    grads = pruning.preorder_gradients_fused(pre_ops.long(), P, dP, buf, root,
                                             pi_b, props_b, w)
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


def pernode_log_likelihoods(post_ops, root, P, tips, pi, props,
                            weights) -> torch.Tensor:
    """Per-tree log likelihoods [B] over the per-node tape."""
    if P.device.type == "cpu":
        return pernode_log_likelihoods_ref(post_ops, root, P, tips, pi, props,
                                           weights)
    B, M, T, N1, C, A, S = _check_shapes(post_ops, root, P, tips, pi, props,
                                         weights)
    _check_cuda_operands(
        dict(post_ops=post_ops, root=root),
        dict(P=P, tips=tips, pi=pi, props=props, weights=weights), C, A)
    kw = dict(device=P.device, dtype=torch.float32)
    buf = torch.empty((B, N1, C * A, S), **kw)
    ls = torch.empty((B, N1, S), **kw)
    ll_rows = torch.empty((B, S), **kw)
    lib = _kernels.library()
    with torch.cuda.device(P.device):
        rc = lib.bito_pernode_ll(
            post_ops.data_ptr(), root.data_ptr(), P.data_ptr(),
            tips.data_ptr(), pi.data_ptr(), props.data_ptr(), buf.data_ptr(),
            ls.data_ptr(), ll_rows.data_ptr(), B, M, T, N1, C, S,
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "bito_pernode_ll")
    pernode_log_likelihoods.launches += 1
    return ll_rows @ weights


pernode_log_likelihoods.launches = 0


def pernode_ll_and_gradients(post_ops, pre_ops, root, edge_mask, P, dP, tips,
                             pi, props, weights):
    """Per-tree (log likelihood [B], branch gradients [B, N])."""
    if P.device.type == "cpu":
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
        C, A)
    kw = dict(device=P.device, dtype=torch.float32)
    buf = torch.empty((B, N1, C * A, S), **kw)
    up = torch.empty((B, N1, C * A, S), **kw)
    ls = torch.empty((B, N1, S), **kw)
    ll_rows = torch.empty((B, S), **kw)
    grad_rows = torch.zeros((B, N1, S), **kw)
    lib = _kernels.library()
    with torch.cuda.device(P.device):
        rc = lib.bito_pernode_grad(
            post_ops.data_ptr(), pre_ops.data_ptr(), root.data_ptr(),
            P.data_ptr(), dP.data_ptr(), tips.data_ptr(), pi.data_ptr(),
            props.data_ptr(), weights.data_ptr(), buf.data_ptr(),
            up.data_ptr(), ls.data_ptr(), ll_rows.data_ptr(),
            grad_rows.data_ptr(), B, M, Mp, T, N1, C, S,
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "bito_pernode_grad")
    pernode_ll_and_gradients.launches += 1
    ll = ll_rows @ weights
    grads = grad_rows.sum(dim=-1)[:, : N1 - 1] * edge_mask
    return ll, grads


pernode_ll_and_gradients.launches = 0
