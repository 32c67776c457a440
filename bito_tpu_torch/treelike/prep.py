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
"""
from __future__ import annotations

import torch

from ..models.substitution import EigenDecomp, rate_matrix_of
from ..utils import timing
from . import pruning

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
    (Q from the eigensystem, P by the eigen route)."""
    with timing.span("prep"):
        P = pruning.transition_matrices_ext(eig, branch_lengths,
                                            category_rates, clock_rate, Q=Q)
        Qb = (rate_matrix_of(eig) if Q is None
              else Q.to(P.dtype).expand(P.shape[0], *Q.shape))  # [B, A, A]
        QC = ((category_rates * clock_rate[:, None])[:, :, None, None]
              * Qb[:, None])                                 # [B, C, A, A]
        dP = QC[:, None] @ P                                 # [B, N+1, C, A, A]
        dP[:, -1] = 0.0
        return P.to(dtype).contiguous(), dP.to(dtype).contiguous()


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
