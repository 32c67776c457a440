"""Substitution models: JC69, HKY, GTR and MG94 (torch).

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

MG94 (codon, models/codon.py) runs on 64 padded states.  Its transition
matrices take the uniformized route (`uniformized_stack`,
`uniformized_transition_matrices`) from the padded Q that `rate_matrix`
gives, for a shared model; per-tree rows take the eigen route.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils import timing


class EigenDecomp(NamedTuple):
    """Eigendecomposition of Q: Q = U @ diag(values) @ U_inv, plus the
    stationary distribution pi.  Fields carry any common leading shape."""

    U: torch.Tensor        # [..., A, A]
    values: torch.Tensor   # [..., A]
    U_inv: torch.Tensor    # [..., A, A]
    pi: torch.Tensor       # [..., A]


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
    with timing.span("host_sync"):
        timing.count("host_syncs", 2)  # two copies from the host
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
    with timing.span("host_sync"):
        timing.count("host_syncs")  # the solver's error code, read back
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


# The Poisson tail past the last power of the uniformized series, and the
# largest q*t the series is summed for (its K is then about 1,300 terms).
UNIFORMIZED_TAIL = 2.0 ** -53
MAX_UNIFORMIZED_QT = 1000.0


def uniformized_terms(qt: float) -> int:
    """The least K whose Poisson(qt) tail past K, sum_{k > K} e^-qt qt^k /
    k!, is under UNIFORMIZED_TAIL: the series' last power for scaled
    times up to qt / q.  The tail grows with qt, so one K serves every
    smaller time.  Raises past MAX_UNIFORMIZED_QT.

    bito_tpu stops at K = 40 whatever qt is, which leaves P's rows 5.5%
    short at qt = 31; this K leaves them short by less than float64
    rounding."""
    if not 0.0 <= qt <= MAX_UNIFORMIZED_QT:
        raise ValueError(f"uniformized transition matrices take q*t in "
                         f"[0, {MAX_UNIFORMIZED_QT:g}], got {qt!r}")
    if qt == 0.0:
        return 0
    log_qt = math.log(qt)
    k = 0
    while True:
        # The tail past k is at most pmf(k + 1) / (1 - qt / (k + 2)) once
        # k + 2 > qt: the terms after k + 1 fall by that ratio or faster.
        log_next = -qt + (k + 1) * log_qt - math.lgamma(k + 2)
        if k + 2 > qt and (log_next - math.log1p(-qt / (k + 2))
                           < math.log(UNIFORMIZED_TAIL)):
            return k
        k += 1


def uniformized_stack(Q: torch.Tensor, t_max: float):
    """Powers M^k of the uniformized matrix M = I + Q/q (q = max |Q_ii|),
    k = 0..K with K = uniformized_terms(q * t_max), and q: the ingredients
    of positivity-preserving transition matrices for scaled times up to
    t_max.  Q: one shared [A, A] rate matrix.

    Why (bito_tpu's finding): P(t) = U e^{Lambda t} U^-1 rebuilds small
    entries by signed cancellation; in float32 a conflicting codon site's
    likelihood is such an entry chain (a 54x error on a site likelihood of
    1.8e-10 on DS1 codon data, and 18x on the summed branch gradient).  The
    series P(t) = e^{-qt} sum_k (qt)^k/k! M^k has only nonnegative terms.

    Returns (stack [K+1, A, A], q as a 0-dim tensor).  The stack is built
    by doubling, stack[n:2n] = stack[:n] @ M^n, in log2(K) products."""
    with timing.span("host_sync"):
        timing.count("host_syncs")
        q = float((-torch.diagonal(Q, dim1=-2, dim2=-1)).max())
    K = uniformized_terms(q * float(t_max))
    A = Q.shape[-1]
    eye = torch.eye(A, device=Q.device, dtype=Q.dtype)
    Mn = eye + Q / max(q, 1e-30)
    stack = eye[None]
    while stack.shape[0] < K + 1:
        stack = torch.cat([stack, stack @ Mn])
        Mn = Mn @ Mn
    with timing.span("host_sync"):
        timing.count("host_syncs")  # a copy from pageable host memory
        q_t = torch.tensor(q, device=Q.device, dtype=Q.dtype)
    return stack[:K + 1], q_t


def uniformized_transition_matrices(stack: torch.Tensor, q: torch.Tensor,
                                    t: torch.Tensor) -> torch.Tensor:
    """P(t) = sum_k poisson_k(qt) M^k from a power stack [K+1, A, A]:
    scaled times t [...] -> [..., A, A].  The Poisson weights are taken in
    log space; qt == 0 gives the identity through the k == 0 term."""
    K1, A = stack.shape[0], stack.shape[-1]
    qt = (q * t)[..., None]                                   # [..., 1]
    k = torch.arange(K1, device=t.device, dtype=stack.dtype)
    safe = torch.clamp_min(qt, 1e-30)
    logc = -qt + k * torch.log(safe) - torch.lgamma(k + 1.0)
    c = torch.where(qt > 0, torch.exp(logc), (k == 0).to(stack.dtype))
    return (c.reshape(-1, K1) @ stack.reshape(K1, A * A)).reshape(
        t.shape + (A, A))


def transition_matrices(eig: EigenDecomp, t: torch.Tensor) -> torch.Tensor:
    """P(t) = U exp(Lambda t) U^-1 for scaled times t [...]: returns
    [..., A, A].  The eigensystem fields broadcast against t's leading
    shape (pass them with singleton axes for batched use)."""
    expvals = torch.exp(eig.values * t[..., None])          # [..., A]
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
    """Q = U diag(values) U^-1, [..., A, A]."""
    return (eig.U * eig.values[..., None, :]) @ eig.U_inv


# ---------------------------------------------------------------------------
# Model parameter containers (host-facing facade)
# ---------------------------------------------------------------------------
class SubstitutionModelSpec:
    """Factory matching reference SubstitutionModel::OfSpecification
    (src/substitution_model.cpp:6-18)."""

    def __init__(self, name: str):
        if name not in ("JC69", "HKY", "GTR", "MG94"):
            raise ValueError(f"Substitution model not known: {name}")
        self.name = name

    @property
    def num_states(self) -> int:
        """Per-state dimension A: MG94 runs on the 61 sense codons padded
        to 64 (models/codon.py's padding contract); nucleotide models are
        A=4."""
        return 64 if self.name == "MG94" else 4

    @property
    def param_counts(self):
        """Block sizes matching reference BlockSpecification keys.  MG94:
        rates = [kappa, omega], frequencies = the 4 nucleotide frequencies
        (TCAG order) of its F1x4 codon frequencies."""
        if self.name == "JC69":
            return {}
        if self.name == "HKY":
            return {"substitution_model_rates": 1,
                    "substitution_model_frequencies": 4}
        if self.name == "MG94":
            return {"substitution_model_rates": 2,
                    "substitution_model_frequencies": 4}
        return {"substitution_model_rates": 6,
                "substitution_model_frequencies": 4}

    def default_params(self, *, device, dtype):
        if self.name == "JC69":
            return {}
        rates = {"HKY": [1.0], "MG94": [2.0, 0.2]}.get(self.name,
                                                      [1.0 / 6.0] * 6)
        return {
            "substitution_model_rates": torch.tensor(rates, device=device,
                                                     dtype=dtype),
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
        if self.name == "MG94":
            from .codon import mg94_eigen

            return mg94_eigen(rates[..., 0], rates[..., 1], freqs)
        return gtr_eigen(rates, freqs)

    def rate_matrix(self, params, *, device, dtype):
        """The padded rate matrix Q of a model whose transition matrices go
        through the positivity-preserving uniformized route (MG94, whose
        eigen reconstruction cancels small entries away; see
        uniformized_stack), [..., 64, 64]; None for the 4-state models,
        whose eigen route is exact enough."""
        if self.name != "MG94":
            return None
        from .codon import mg94_q_padded

        rates = params["substitution_model_rates"]
        return mg94_q_padded(rates[..., 0], rates[..., 1],
                             params["substitution_model_frequencies"])
