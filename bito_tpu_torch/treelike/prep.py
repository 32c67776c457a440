"""Operand preparation for the paired kernels (plain torch, outside them).

Counterpart of bito_tpu.treelike.pallas_pruning.prepare_inputs /
prepare_inputs_grad_q (pallas_pruning.py:350-423), which XLA ran around the
Pallas kernels.  What differs: P and dP stay compact, [B, N+1, C, A, A],
where bito_tpu assembled the 75%-zero [C*A, C*A] block diagonal for the
TPU's matrix unit; tips stay [T, A, S] (the engine's padded tips,
transposed), where bito_tpu broadcast them over categories; and pi and the
category proportions stay [A] and [C].

As in bito_tpu:
  - index N of P is the identity edge and index N of dP is zero (the
    multifurcating-root accumulator ops and the tape's padding use it);
  - dP = rate_c * clock * Q @ P, with Q = U diag(lambda) U^-1;
  - the kernel operands are float32.
"""
from __future__ import annotations

import torch

from ..models.substitution import EigenDecomp, rate_matrix_of
from . import pruning

KERNEL_DTYPE = torch.float32


def kernel_model(eig: EigenDecomp, category_proportions: torch.Tensor):
    """(pi [A], proportions [C]) float32 of a shared model (row 0 of the
    batch-broadcast ingredients)."""
    return (eig.pi[0].to(KERNEL_DTYPE).contiguous(),
            category_proportions[0].to(KERNEL_DTYPE).contiguous())


def prepare_inputs(eig: EigenDecomp, category_rates, clock_rate,
                   branch_lengths) -> torch.Tensor:
    """Transition matrices P [B, N+1, C, A, A] float32, identity at N."""
    P = pruning.transition_matrices_ext(eig, branch_lengths,
                                        category_rates, clock_rate)
    return P.to(KERNEL_DTYPE).contiguous()


def prepare_inputs_grad_q(eig: EigenDecomp, category_rates, clock_rate,
                          branch_lengths):
    """(P, dP), both [B, N+1, C, A, A] float32, with dP from the
    dP = rate*clock * Q P identity and zero at the identity edge N."""
    P = prepare_inputs(eig, category_rates, clock_rate, branch_lengths)
    Q = rate_matrix_of(eig)                                  # [B, A, A]
    QC = ((category_rates * clock_rate[:, None])[:, :, None, None]
          * Q[:, None]).to(KERNEL_DTYPE)                     # [B, C, A, A]
    dP = QC[:, None] @ P                                     # [B, N+1, C, A, A]
    dP[:, -1] = 0.0
    return P, dP.contiguous()
