"""Substitution models: JC69, HKY, GTR (torch).

Port of bito_tpu.models.substitution (reference:
src/substitution_model.cpp:20-210).  Each model gives an eigensystem
(U, lambda, U^-1, pi) of its rate matrix Q, normalised to unit expected
substitution rate; P(t) = U diag(exp(lambda t)) U^-1.

Every function takes parameters with any leading batch shape: a shared
model passes [6] GTR rates, per-tree rows pass [B, 6], and the eigensystem
fields follow with the same leading shape.  Models without parameters
(JC69) take an explicit device and dtype.

Conventions (matching the reference):
  - GTR rates: 6 exchangeabilities in upper-triangle row-major order
    (AC, AG, AT, CG, CT, GT), constrained to sum to 1.
  - HKY rates: a single kappa.
  - frequencies sum to 1; states ordered A, C, G, T.

MG94 (codon), the uniformized transition route and `rate_matrix` wait for
the codon slice of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class EigenDecomp(NamedTuple):
    """Eigendecomposition of Q: Q = U @ diag(values) @ U_inv, plus the
    stationary distribution pi.  Fields carry any common leading shape."""

    U: torch.Tensor        # [..., 4, 4]
    values: torch.Tensor   # [..., 4]
    U_inv: torch.Tensor    # [..., 4, 4]
    pi: torch.Tensor       # [..., 4]


def jc69_eigen(*, device, dtype) -> EigenDecomp:
    """Analytic JC69 eigensystem (reference src/substitution_model.cpp:20-26)."""
    U = torch.tensor(
        [
            [1.0, 2.0, 0.0, 0.5],
            [1.0, -2.0, 0.5, 0.0],
            [1.0, 2.0, 0.0, -0.5],
            [1.0, -2.0, -0.5, 0.0],
        ],
        device=device, dtype=dtype,
    )
    U_inv = torch.tensor(
        [
            [0.25, 0.25, 0.25, 0.25],
            [0.125, -0.125, 0.125, -0.125],
            [0.0, 1.0, 0.0, -1.0],
            [1.0, 0.0, -1.0, 0.0],
        ],
        device=device, dtype=dtype,
    )
    values = torch.tensor([0.0, -4.0 / 3.0, -4.0 / 3.0, -4.0 / 3.0],
                          device=device, dtype=dtype)
    pi = torch.full((4,), 0.25, device=device, dtype=dtype)
    return EigenDecomp(U, values, U_inv, pi)


_IU = (0, 0, 0, 1, 1, 2)
_JU = (1, 2, 3, 2, 3, 3)


def build_gtr_q(rates: torch.Tensor, frequencies: torch.Tensor) -> torch.Tensor:
    """Normalised GTR rate matrix [..., 4, 4] (reference
    GTRModel/HKYModel::UpdateQMatrix, src/substitution_model.cpp:49-76):
    Q[i,j] = rate[ij] * pi[j] off-diagonal, rows sum to zero, scaled so the
    expected substitution rate -sum_i pi_i Q_ii equals 1."""
    pi = frequencies
    iu = torch.tensor(_IU, device=pi.device)
    ju = torch.tensor(_JU, device=pi.device)
    Q = torch.zeros(pi.shape[:-1] + (4, 4), device=pi.device, dtype=pi.dtype)
    Q[..., iu, ju] = rates * pi[..., ju]
    Q[..., ju, iu] = rates * pi[..., iu]
    row_sums = Q.sum(dim=-1)
    Q = Q - torch.diag_embed(row_sums)
    total_rate = (row_sums * pi).sum(dim=-1)
    return Q / total_rate[..., None, None]


def gtr_eigen(rates: torch.Tensor, frequencies: torch.Tensor) -> EigenDecomp:
    """GTR eigensystem by pi-symmetrisation: S = diag(sqrt pi) Q
    diag(1/sqrt pi) is symmetric for a reversible Q, so `eigh` applies;
    U = diag(1/sqrt pi) V and U^-1 = V^T diag(sqrt pi)."""
    pi = frequencies
    Q = build_gtr_q(rates, pi)
    sqrt_pi = torch.sqrt(pi)
    S = (sqrt_pi[..., :, None] * Q) / sqrt_pi[..., None, :]
    S = 0.5 * (S + S.transpose(-1, -2))  # exact symmetry for eigh
    values, V = torch.linalg.eigh(S)
    U = V / sqrt_pi[..., :, None]
    U_inv = V.transpose(-1, -2) * sqrt_pi[..., None, :]
    return EigenDecomp(U, values, U_inv, pi)


def hky_eigen(kappa: torch.Tensor, frequencies: torch.Tensor) -> EigenDecomp:
    """Closed-form HKY85 eigensystem (reference
    src/substitution_model.cpp:80-120; Hasegawa, Kishino & Yano 1985).
    kappa: [...]; frequencies: [..., 4]."""
    pi = frequencies
    pi_a, pi_c, pi_g, pi_t = pi.unbind(dim=-1)
    pi_r = pi_a + pi_g
    pi_y = pi_c + pi_t
    beta = -1.0 / (2.0 * (pi_r * pi_y + kappa * (pi_a * pi_g + pi_c * pi_t)))
    zero = torch.zeros_like(pi_a)
    one = torch.ones_like(pi_a)
    values = torch.stack(
        [zero, beta, beta * (1.0 + pi_y * (kappa - 1.0)),
         beta * (1.0 + pi_r * (kappa - 1.0))], dim=-1)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    U_inv = mat([
        [pi_a, pi_c, pi_g, pi_t],
        [pi_a * pi_y, -pi_c * pi_r, pi_g * pi_y, -pi_t * pi_r],
        [zero, one, zero, -one],
        [one, zero, -one, zero],
    ])
    U = mat([
        [one, 1.0 / pi_r, zero, pi_g / pi_r],
        [one, -1.0 / pi_y, pi_t / pi_y, zero],
        [one, 1.0 / pi_r, zero, -pi_a / pi_r],
        [one, -1.0 / pi_y, -pi_c / pi_y, zero],
    ])
    return EigenDecomp(U, values, U_inv, pi)


def transition_matrices(eig: EigenDecomp, t: torch.Tensor) -> torch.Tensor:
    """P(t) = U exp(Lambda t) U^-1 for scaled times t [...]: returns
    [..., 4, 4].  The eigensystem fields broadcast against t's leading
    shape (pass them with singleton axes for batched use)."""
    expvals = torch.exp(eig.values * t[..., None])          # [..., 4]
    P = (eig.U * expvals[..., None, :]) @ eig.U_inv
    # Transition probabilities are nonnegative; in f32 an eigen
    # reconstruction can round a small entry slightly negative, which would
    # turn a partial product negative and the root log into NaN.  An exact
    # no-op in f64 for 4-state models.
    return torch.clamp_min(P, 0.0)


def transition_derivatives(eig: EigenDecomp, t: torch.Tensor) -> torch.Tensor:
    """dP/dt = U Lambda exp(Lambda t) U^-1 (reference
    GPEngine::SetTransitionAndDerivativeMatricesToHaveBranchLength)."""
    expvals = torch.exp(eig.values * t[..., None]) * eig.values
    return (eig.U * expvals[..., None, :]) @ eig.U_inv


def rate_matrix_of(eig: EigenDecomp) -> torch.Tensor:
    """Q = U diag(values) U^-1, [..., 4, 4]."""
    return (eig.U * eig.values[..., None, :]) @ eig.U_inv


# ---------------------------------------------------------------------------
# Model parameter containers (host-facing facade)
# ---------------------------------------------------------------------------
class SubstitutionModelSpec:
    """Factory matching reference SubstitutionModel::OfSpecification
    (src/substitution_model.cpp:6-18)."""

    def __init__(self, name: str):
        if name == "MG94":
            raise ValueError("MG94 is not ported to bito_tpu_torch yet")
        if name not in ("JC69", "HKY", "GTR"):
            raise ValueError(f"Substitution model not known: {name}")
        self.name = name

    @property
    def num_states(self) -> int:
        return 4

    @property
    def param_counts(self):
        """Block sizes matching reference BlockSpecification keys."""
        if self.name == "JC69":
            return {}
        if self.name == "HKY":
            return {"substitution_model_rates": 1,
                    "substitution_model_frequencies": 4}
        return {"substitution_model_rates": 6,
                "substitution_model_frequencies": 4}

    def default_params(self, *, device, dtype):
        if self.name == "JC69":
            return {}
        rates = (torch.ones(1, device=device, dtype=dtype)
                 if self.name == "HKY"
                 else torch.full((6,), 1.0 / 6.0, device=device, dtype=dtype))
        return {
            "substitution_model_rates": rates,
            "substitution_model_frequencies": torch.full(
                (4,), 0.25, device=device, dtype=dtype),
        }

    def eigen(self, params, *, device, dtype) -> EigenDecomp:
        if self.name == "JC69":
            return jc69_eigen(device=device, dtype=dtype)
        rates = params["substitution_model_rates"]
        freqs = params["substitution_model_frequencies"]
        if self.name == "HKY":
            return hky_eigen(rates[..., 0], freqs)
        return gtr_eigen(rates, freqs)
