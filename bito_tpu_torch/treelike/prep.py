"""Operand preparation for the kernels (plain torch, outside them).

Counterpart of bito_tpu.treelike.pallas_pruning.prepare_inputs /
prepare_inputs_grad_q / prepare_inputs_grad (pallas_pruning.py:350-448),
which XLA ran around the Pallas kernels.  What differs: P and dP stay
compact, [B, N+1, C, A, A], where bito_tpu assembled the 75%-zero
[C*A, C*A] block diagonal for the TPU's matrix unit; tips stay [T, A, S]
(the engine's padded tips, transposed), where bito_tpu broadcast them over
categories; and pi and the category proportions stay [A] and [C].

As in bito_tpu:
  - index N of P is the identity edge and index N of dP is zero (the
    multifurcating-root accumulator ops and the tape's padding use it);
  - prepare_inputs_grad_q takes dP = rate_c * clock * Q @ P, with
    Q = U diag(lambda) U^-1 (the paired route), or the shared Q passed in
    (`Q=`, codon models: P is then uniformized, pruning.
    transition_matrices_ext, and dP comes from that Q, not from the
    eigensystem, whose reconstruction cancels small entries away);
    prepare_inputs_grad takes
    dP from the eigen derivative (the chunked route, and the per-node
    kernels as scripts/bench_kernel_race.py drives them);
  - the kernel operands are float32.  `dtype` gives the plain versions
    their operands in float64 (the engine on the CPU, and the tests).
    P and dP are computed in the model ingredients' dtype (float64 from
    the engine) and cast to `dtype` last.

prepare_inputs_grad_q on the card, at 4 states on the eigen route with
float32 operands, launches one hand-written kernel that forms P and dP
(transition_prep, models/csrc/transition_prep.cu) with the torch ops'
float64 arithmetic in their order; everywhere else, and on the CPU, it
runs those torch ops, transition_prep_plain.
"""
from __future__ import annotations

import torch

from ..models.substitution import EigenDecomp, rate_matrix_of
from ..utils import timing
from . import _kernels, paired, pruning

KERNEL_DTYPE = torch.float32


def kernel_model(eig: EigenDecomp, category_proportions: torch.Tensor,
                 dtype=KERNEL_DTYPE):
    """(pi [A], proportions [C]) float32 of a shared model (row 0 of the
    batch-broadcast ingredients)."""
    with timing.span("ingredients"):
        return (eig.pi[0].to(dtype).contiguous(),
                category_proportions[0].to(dtype).contiguous())


def prepare_inputs(eig: EigenDecomp, category_rates, clock_rate,
                   branch_lengths, dtype=KERNEL_DTYPE, Q=None) -> torch.Tensor:
    """Transition matrices P [B, N+1, C, A, A] float32, identity at N;
    uniformized from the shared [A, A] `Q` where one is given."""
    with timing.span("prep"):
        P = pruning.transition_matrices_ext(eig, branch_lengths,
                                            category_rates, clock_rate, Q=Q)
        return P.to(dtype).contiguous()


def prepare_inputs_grad_q(eig: EigenDecomp, category_rates, clock_rate,
                          branch_lengths, dtype=KERNEL_DTYPE, Q=None):
    """(P, dP), both [B, N+1, C, A, A] float32, with dP from the
    dP = rate*clock * Q P identity and zero at the identity edge N.  Q:
    the shared [A, A] rate matrix of the uniformized route, else None
    (Q from the eigensystem, P by the eigen route).  On the card, with Q
    None, A = 4, float32 operands and the operands transition_prep takes
    (float32 or float64 branch lengths [B, N], float64 ingredients of B
    rows), one launch of transition_prep; otherwise transition_prep_plain."""
    with timing.span("prep"):
        if (Q is None and dtype == KERNEL_DTYPE
                and not paired.on_cpu(branch_lengths)
                and _refusal(eig, category_rates, clock_rate,
                             branch_lengths) is None):
            return _launch(eig, category_rates, clock_rate, branch_lengths)
        return transition_prep_plain(eig, category_rates, clock_rate,
                                     branch_lengths, dtype, Q)


def transition_prep_plain(eig: EigenDecomp, category_rates, clock_rate,
                          branch_lengths, dtype=KERNEL_DTYPE, Q=None):
    """prepare_inputs_grad_q's torch ops, in the ingredients' dtype, cast
    to `dtype` last: transition_prep's plain version, and the route of
    every input outside its domain."""
    P = pruning.transition_matrices_ext(eig, branch_lengths, category_rates,
                                        clock_rate, Q=Q)
    Qb = (rate_matrix_of(eig) if Q is None
          else Q.to(P.dtype).expand(P.shape[0], *Q.shape))  # [B, A, A]
    QC = ((category_rates * clock_rate[:, None])[:, :, None, None]
          * Qb[:, None])                                     # [B, C, A, A]
    dP = QC[:, None] @ P                                     # [B, N+1, C, A, A]
    dP[:, -1] = 0.0
    return P.to(dtype).contiguous(), dP.to(dtype).contiguous()


def _refusal(eig: EigenDecomp, category_rates, clock_rate, branch_lengths):
    """(exception type, message) for operands that transition_prep does not
    take, whatever their device; None for those it takes."""
    bl, A = branch_lengths, eig.U.shape[-1]
    if A != 4:
        return ValueError, f"transition_prep takes 4-state models, got A={A}"
    # float32: the engine's operands; float64: graft_entry's training batch.
    if bl.dtype not in (torch.float32, torch.float64):
        return TypeError, (f"branch_lengths must be float32 or float64, got "
                           f"{bl.dtype}")
    if bl.dim() != 2:
        return ValueError, (f"branch_lengths must be [B, N], got shape "
                            f"{tuple(bl.shape)}")
    B, C = bl.shape[0], category_rates.shape[-1]
    if C < 1:
        return ValueError, f"transition_prep takes C >= 1, got C={C}"
    for name, t, shape in (("U", eig.U, (B, 4, 4)),
                           ("U_inv", eig.U_inv, (B, 4, 4)),
                           ("values", eig.values, (B, 4)),
                           ("category_rates", category_rates, (B, C)),
                           ("clock_rate", clock_rate, (B,))):
        if t.dtype != torch.float64:
            return TypeError, f"{name} must be float64, got {t.dtype}"
        if tuple(t.shape) != shape:
            return ValueError, (f"{name} has shape {tuple(t.shape)}, "
                                f"expected {shape}")
        if t.device != bl.device:
            return ValueError, (f"{name} is on {t.device}, branch_lengths "
                                f"on {bl.device}")
    return None


def transition_prep(eig: EigenDecomp, category_rates, clock_rate,
                    branch_lengths):
    """Launch models/csrc/transition_prep.cu: (P, dP), both
    [B, N+1, C, 4, 4] float32 and contiguous, what transition_prep_plain
    gives at Q None, computed in float64 in its order.  branch_lengths
    [B, N], float32 or float64; the ingredients float64 (eig's U, U_inv
    [B, 4, 4] and values [B, 4], rates [B, C], clock [B]); every operand
    is read through its strides (a shared model's rows expanded over the
    trees have a tree stride of 0).  Raises on what the kernel does not
    take; counts `.launches` and the span's `prep_launches`."""
    refused = _refusal(eig, category_rates, clock_rate, branch_lengths)
    if refused is not None:
        raise refused[0](refused[1])
    if branch_lengths.device.type != "cuda":
        raise ValueError(f"branch_lengths is on {branch_lengths.device}, the "
                         f"kernel needs CUDA")
    return _launch(eig, category_rates, clock_rate, branch_lengths)


def _launch(eig: EigenDecomp, category_rates, clock_rate, branch_lengths):
    """transition_prep's launch, on operands _refusal takes, on the card."""
    bl, U, lam, U_inv = branch_lengths, eig.U, eig.values, eig.U_inv
    B, N = bl.shape
    C = category_rates.shape[-1]
    kw = dict(device=bl.device, dtype=KERNEL_DTYPE)
    P = torch.empty((B, N + 1, C, 4, 4), **kw)
    dP = torch.empty((B, N + 1, C, 4, 4), **kw)
    with torch.cuda.device(bl.device):
        rc = _kernels.library().bito_transition_prep(
            bl.data_ptr(), U.data_ptr(), U_inv.data_ptr(), lam.data_ptr(),
            category_rates.data_ptr(), clock_rate.data_ptr(), P.data_ptr(),
            dP.data_ptr(), B, N, C, int(bl.dtype == torch.float64),
            *bl.stride(), *U.stride(), *U_inv.stride(), *lam.stride(),
            *category_rates.stride(), *clock_rate.stride(),
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "bito_transition_prep")
    transition_prep.launches += 1
    timing.count("prep_launches")
    return P, dP


transition_prep.launches = 0


def prepare_inputs_grad(eig: EigenDecomp, category_rates, clock_rate,
                        branch_lengths, dtype=KERNEL_DTYPE):
    """(P, dP), both [B, N+1, C, A, A] float32, with dP from the eigen
    derivative of P (transition_matrices_ext(..., derivative=True)), zero
    at the identity edge N."""
    with timing.span("prep"):
        P = prepare_inputs(eig, category_rates, clock_rate, branch_lengths,
                           dtype)
        dP = pruning.transition_matrices_ext(eig, branch_lengths,
                                             category_rates, clock_rate,
                                             derivative=True)
        return P, dP.to(dtype).contiguous()
