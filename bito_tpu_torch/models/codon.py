"""Codon-state substitution models: MG94-style 61-state models on the same
batched tape as the 4-state models, padded to A=64 (torch).

Port of bito_tpu.models.codon.  The numpy parts (the genetic code, the
MG94 rate matrix, F1x4 frequencies, the padded eigensystem, codon tip
partials and the structural masks) are copies of bito_tpu's, pinned equal
to them by AST in tests/test_torch_codon.py.  The jnp parts are torch
here: `mg94_q_padded`, `mg94_eigen`, `CodonModel.eigen_decomp`,
`codon_log_likelihoods` and `codon_ll_and_gradients` (on the port's scan
tape, treelike/pruning.py).

A flows from the tip-partial and eigenvector shapes, so the tape and the
paired kernels' wrappers (treelike/paired.py, which launch their A=64
kernels on the card) take codon models as they take the 4-state ones.

Padding contract (states 61..63), as in bito_tpu:
  - pi is zero on pad states, so the root contraction ignores them;
  - the eigensystem is embedded with an identity block on the pad states
    (eigenvalue 0 -> P(t) acts as the identity there), so pad lanes carry
    harmless constants through the recursion;
  - tip partials are zero on pad states (gap columns are all-ones over
    the 61 sense states only).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import PRODUCT_DEVICE, PRODUCT_DTYPE, resolve
from ..utils import timing

# Universal genetic code: codon -> amino acid (stop codons excluded below).
_BASES = "TCAG"
_CODE = (
    "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
)


def sense_codons():
    """The 61 sense codons of the universal code, in TCAG order (the
    conventional codon-model state order)."""
    out = []
    for i, b1 in enumerate(_BASES):
        for j, b2 in enumerate(_BASES):
            for k, b3 in enumerate(_BASES):
                if _CODE[16 * i + 4 * j + k] != "*":
                    out.append(b1 + b2 + b3)
    return out


SENSE_CODONS = sense_codons()
CODON_INDEX = {c: i for i, c in enumerate(SENSE_CODONS)}
NUM_CODONS = len(SENSE_CODONS)  # 61
PADDED_STATES = 64


def _aa(codon: str) -> str:
    i = _BASES.index(codon[0])
    j = _BASES.index(codon[1])
    k = _BASES.index(codon[2])
    return _CODE[16 * i + 4 * j + k]


def _is_transition(a: str, b: str) -> bool:
    purines = {"A", "G"}
    return (a in purines) == (b in purines)


def mg94_rate_matrix(kappa: float, omega: float,
                     pi: np.ndarray) -> np.ndarray:
    """Muse-Gaut (1994)-style codon rate matrix [61, 61]: single-nucleotide
    changes only, x kappa for transitions, x omega for nonsynonymous
    changes, x target-codon frequency; rows sum to zero and the matrix is
    scaled to one expected substitution per unit time."""
    n = NUM_CODONS
    Q = np.zeros((n, n))
    for i, ci in enumerate(SENSE_CODONS):
        for j, cj in enumerate(SENSE_CODONS):
            if i == j:
                continue
            diffs = [(a, b) for a, b in zip(ci, cj) if a != b]
            if len(diffs) != 1:
                continue
            a, b = diffs[0]
            rate = pi[j]
            if _is_transition(a, b):
                rate *= kappa
            if _aa(ci) != _aa(cj):
                rate *= omega
            Q[i, j] = rate
    Q[np.diag_indices(n)] = -Q.sum(axis=1)
    scale = -np.dot(pi, np.diag(Q))
    return Q / scale


def codon_frequencies_f1x4(nuc_freqs) -> np.ndarray:
    """F1x4 codon frequencies from nucleotide frequencies (TCAG order),
    renormalized over the 61 sense codons."""
    f = {b: float(p) for b, p in zip(_BASES, nuc_freqs)}
    pi = np.array([f[c[0]] * f[c[1]] * f[c[2]] for c in SENSE_CODONS])
    return pi / pi.sum()


def padded_eigen(Q: np.ndarray, pi: np.ndarray):
    """Eigendecomposition of a reversible Q via pi-symmetrization, embedded
    into the 64-state padded system (identity on the pad block).  Returns
    (U, values, U_inv, pi_pad) as float64 [64,...] arrays satisfying
    U diag(values) U_inv == Q_pad and expm(Q_pad t) == identity on pads."""
    n = Q.shape[0]
    s = np.sqrt(pi)
    Sym = (s[:, None] * Q) / s[None, :]
    Sym = (Sym + Sym.T) / 2.0
    lam, V = np.linalg.eigh(Sym)
    U = V / s[:, None]
    U_inv = V.T * s[None, :]
    A = PADDED_STATES
    Up = np.eye(A)
    Up[:n, :n] = U
    Uip = np.eye(A)
    Uip[:n, :n] = U_inv
    vals = np.zeros(A)
    vals[:n] = lam
    pip = np.zeros(A)
    pip[:n] = pi
    return Up, vals, Uip, pip


def codon_tip_partials(sequences: Dict[str, str], taxon_order) -> np.ndarray:
    """[T, sites/3, 64] one-hot codon tip partials; codons containing
    ambiguity (or stop codons, treated as missing data) get all-ones over
    the 61 sense states and zeros on pads."""
    T = len(taxon_order)
    L = len(next(iter(sequences.values())))
    assert L % 3 == 0, "codon data length must be a multiple of 3"
    S = L // 3
    out = np.zeros((T, S, PADDED_STATES))
    for t, name in enumerate(taxon_order):
        seq = sequences[name].upper().replace("U", "T")
        for s in range(S):
            codon = seq[3 * s:3 * s + 3]
            idx = CODON_INDEX.get(codon)
            if idx is None:
                out[t, s, :NUM_CODONS] = 1.0
            else:
                out[t, s, idx] = 1.0
    return out


# -- structural masks for the torch MG94 Q build ----------------------------
# Precomputed once (host, bool): which codon pairs differ by exactly one
# nucleotide, whether that change is a transition, and whether it is
# nonsynonymous, so Q(kappa, omega, pi) is elementwise torch math.
def _structure_masks():
    n = NUM_CODONS
    single = np.zeros((n, n), bool)
    ti = np.zeros((n, n), bool)
    nonsyn = np.zeros((n, n), bool)
    for i, ci in enumerate(SENSE_CODONS):
        for j, cj in enumerate(SENSE_CODONS):
            if i == j:
                continue
            diffs = [(a, b) for a, b in zip(ci, cj) if a != b]
            if len(diffs) != 1:
                continue
            single[i, j] = True
            a, b = diffs[0]
            ti[i, j] = _is_transition(a, b)
            nonsyn[i, j] = _aa(ci) != _aa(cj)
    return single, ti, nonsyn


SINGLE_MASK, TI_MASK, NONSYN_MASK = _structure_masks()
# Nucleotide index (TCAG order) of each codon position, for F1x4.
CODON_NT_IDX = np.array(
    [[_BASES.index(c[k]) for k in range(3)] for c in SENSE_CODONS])


def _mg94_q61(kappa: torch.Tensor, omega: torch.Tensor,
              nuc_freqs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q [..., 61, 61], F1x4 pi [..., 61]) from kappa [...], omega [...]
    and nucleotide frequencies [..., 4] in TCAG order, as bito_tpu's jnp
    build: every off-diagonal entry is a product of positive factors
    (pi_j, kappa^ti, omega^nonsyn), so no entry comes from cancellation."""
    dev = nuc_freqs.device
    with timing.span("host_sync"):
        timing.count("host_syncs", 4)  # four copies from the host
        nt_idx, ti, nonsyn, single = (
            torch.as_tensor(x, device=dev)
            for x in (CODON_NT_IDX, TI_MASK, NONSYN_MASK, SINGLE_MASK))
    pi61 = nuc_freqs[..., nt_idx].prod(-1)
    pi61 = pi61 / pi61.sum(-1, keepdim=True)
    rate = (torch.where(ti, kappa[..., None, None], 1.0)
            * torch.where(nonsyn, omega[..., None, None], 1.0))
    Q = torch.where(single, rate * pi61[..., None, :], 0.0)
    Q = Q - torch.diag_embed(Q.sum(-1))
    scale = -(pi61 * torch.diagonal(Q, dim1=-2, dim2=-1)).sum(-1)
    return Q / scale[..., None, None], pi61


def _pad(x: torch.Tensor, diagonal: float) -> torch.Tensor:
    """[..., 61, 61] -> [..., 64, 64], `diagonal` on the pad block."""
    A, n = PADDED_STATES, NUM_CODONS
    out = torch.zeros(x.shape[:-2] + (A, A), device=x.device, dtype=x.dtype)
    out[..., :n, :n] = x
    with timing.span("host_sync"):
        # the two index vectors and the value, copied from the host
        timing.count("host_syncs", 3)
        out[..., range(n, A), range(n, A)] = diagonal
    return out


def mg94_q_padded(kappa, omega, nuc_freqs) -> torch.Tensor:
    """Padded [..., 64, 64] MG94 rate matrix (zero rows and columns on the
    3 pad states) from kappa [...], omega [...] and nucleotide frequencies
    [..., 4] (TCAG order): the uniformized transition route's Q
    (models/substitution.py uniformized_stack)."""
    Q, _ = _mg94_q61(kappa, omega, nuc_freqs)
    return _pad(Q, 0.0)


def _plain(*xs: torch.Tensor) -> bool:
    """True for values that no autograd or torch.func transform follows:
    bito_tpu's concrete (untraced) inputs."""
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    return not any(x.requires_grad or wrapped(x) for x in xs)


def mg94_eigen(kappa, omega, nuc_freqs):
    """MG94 padded-64 eigensystem as an EigenDecomp from kappa [...], omega
    [...] and nucleotide frequencies [..., 4] (TCAG order), in their
    device and dtype.

    One plain row (no leading axes, no autograd) takes bito_tpu's float64
    host path: the numpy rate matrix and `eigh` (padded_eigen).  Rows a
    tree, or values that autograd follows, take the torch build from the
    structural masks and a batched torch `eigh`, as bito_tpu's traced
    inputs take its jnp build."""
    from .substitution import EigenDecomp

    kw = dict(device=nuc_freqs.device, dtype=nuc_freqs.dtype)
    if kappa.dim() == 0 and _plain(kappa, omega, nuc_freqs):
        with timing.span("host_sync"):
            timing.count("host_syncs", 3)  # the frequencies, kappa, omega
            freqs = nuc_freqs.detach().cpu().numpy().astype(np.float64)
            kappa, omega = float(kappa), float(omega)
        pi61 = codon_frequencies_f1x4(freqs)
        Q61 = mg94_rate_matrix(kappa, omega, pi61)
        eig = padded_eigen(Q61, pi61)
        with timing.span("host_sync"):
            timing.count("host_syncs", 4)  # four copies from the host
            return EigenDecomp(*(torch.as_tensor(x, **kw) for x in eig))
    Q, pi61 = _mg94_q61(kappa, omega, nuc_freqs)
    s = torch.sqrt(pi61)
    Sym = (s[..., :, None] * Q) / s[..., None, :]
    Sym = 0.5 * (Sym + Sym.transpose(-1, -2))
    with timing.span("host_sync"):
        timing.count("host_syncs")  # the solver's error code, read back
        lam, V = torch.linalg.eigh(Sym)
    U = V / s[..., :, None]
    U_inv = V.transpose(-1, -2) * s[..., None, :]
    n = NUM_CODONS
    vals = torch.zeros(lam.shape[:-1] + (PADDED_STATES,), **kw)
    vals[..., :n] = lam
    pip = torch.zeros_like(vals)
    pip[..., :n] = pi61
    return EigenDecomp(U=_pad(U, 1.0), values=vals, U_inv=_pad(U_inv, 1.0),
                       pi=pip)


class CodonModel:
    """MG94 codon model facade: eigen ingredients shaped like the 4-state
    models' EigenDecomp, so the scan tape (treelike/pruning.py) runs
    unchanged at A=64."""

    def __init__(self, kappa: float = 2.0, omega: float = 0.2,
                 nuc_freqs=(0.25, 0.25, 0.25, 0.25),
                 codon_freqs: Optional[np.ndarray] = None):
        self.pi61 = (np.asarray(codon_freqs) if codon_freqs is not None
                     else codon_frequencies_f1x4(nuc_freqs))
        self.Q61 = mg94_rate_matrix(kappa, omega, self.pi61)
        self.U, self.values, self.U_inv, self.pi = padded_eigen(
            self.Q61, self.pi61)

    def eigen_decomp(self, *, device, dtype):
        from .substitution import EigenDecomp

        return EigenDecomp(*(torch.as_tensor(x, device=device, dtype=dtype)
                             for x in (self.U, self.values, self.U_inv,
                                       self.pi)))


def _tape_inputs(topologies, branch_lengths, tip_partials, weights,
                 model: CodonModel, category_rates, category_proportions,
                 device, dtype):
    """The scan tape's operands for the codon functions: (encoding,
    tips, weights, branch lengths, eig, rates, proportions, clock, pad).
    The model ingredients are float64 and the tape runs in `dtype`, as in
    the engine (treelike/engine.py, _model_ingredients)."""
    from ..treelike import pruning
    from ..treelike.encode import encode_trees
    from .substitution import EigenDecomp

    device, dtype = resolve(device, dtype)
    kw, kw64 = (dict(device=device, dtype=dt)
                for dt in (dtype, torch.float64))
    B = len(topologies)
    enc = encode_trees(topologies)
    eig = EigenDecomp(*(x.expand((B,) + x.shape)
                        for x in model.eigen_decomp(**kw64)))

    def rows(x):
        x = torch.ones(1, **kw64) if x is None else torch.as_tensor(x, **kw64)
        return x.expand(B, x.shape[-1])

    rates, props = rows(category_rates), rows(category_proportions)
    S0 = tip_partials.shape[1]
    pad = pruning.pad_patterns(S0)
    w = torch.zeros(pad, **kw)
    w[:S0] = torch.as_tensor(np.asarray(weights), **kw)
    return (enc, torch.as_tensor(np.asarray(tip_partials), **kw), w,
            torch.as_tensor(np.asarray(branch_lengths), **kw), eig, rates,
            props, torch.ones(B, **kw64), pad)


def codon_log_likelihoods(topologies, branch_lengths, tip_partials,
                          weights, model: CodonModel,
                          category_rates=None,
                          category_proportions=None, *,
                          device=PRODUCT_DEVICE, dtype=PRODUCT_DTYPE):
    """Batched codon log likelihoods [B] on the scan tape.

    topologies: list of core.tree.Topology; branch_lengths [B, N];
    tip_partials [T, S0, 64] (codon_tip_partials); weights [S0]."""
    from ..treelike import pruning

    enc, tips, w, bl, eig, rates, props, clock, pad = _tape_inputs(
        topologies, branch_lengths, tip_partials, weights, model,
        category_rates, category_proportions, device, dtype)
    post_ops, root = (torch.as_tensor(x, dtype=torch.long, device=w.device)
                      for x in (enc.post_ops, enc.root))
    return pruning.log_likelihoods_impl(
        post_ops, root, tips, w, bl, eig, rates, props, clock,
        num_slots=enc.num_slots, pattern_pad=pad,
        category_count=rates.shape[-1])


def codon_ll_and_gradients(topologies, branch_lengths, tip_partials,
                           weights, model: CodonModel,
                           category_rates=None,
                           category_proportions=None, *,
                           device=PRODUCT_DEVICE, dtype=PRODUCT_DTYPE):
    """Batched codon (log likelihoods [B], branch gradients [B, N]) on the
    scan tape, the arguments as codon_log_likelihoods'."""
    from ..treelike import pruning

    enc, tips, w, bl, eig, rates, props, clock, pad = _tape_inputs(
        topologies, branch_lengths, tip_partials, weights, model,
        category_rates, category_proportions, device, dtype)
    post_ops, pre_ops, root = (
        torch.as_tensor(x, dtype=torch.long, device=w.device)
        for x in (enc.post_ops, enc.pre_ops, enc.root))
    return pruning.ll_and_branch_gradients_impl(
        post_ops, pre_ops, root,
        torch.as_tensor(enc.edge_mask, dtype=w.dtype, device=w.device),
        tips, w, bl, eig, rates, props, clock,
        num_slots=enc.num_slots, pattern_pad=pad,
        category_count=rates.shape[-1])
