"""Substitution and rate-category models, in numpy float64.

GTR (Tavare 1986) over ACGT with its six exchangeabilities in the order
AC, AG, AT, CG, CT, GT, and MG94 (Muse & Gaut 1994) over the 61 sense
codons with F1x4 frequencies from nucleotide frequencies in TCAG order.
Each rate matrix is scaled to one expected substitution per unit time.
Rate categories: Gamma+K by the median of each of K equal-probability
bins, normalised to mean 1 (Yang 1994), or one constant category.

The MG94 matrix is a frozen copy of the program's
bito_tpu_torch/models/codon.py:70-102 (`mg94_rate_matrix`,
`codon_frequencies_f1x4`); the GTR matrix follows
bito_tpu_torch/models/substitution.py:72-86 (`build_gtr_q`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .patterns import SENSE_CODONS

_BASES = "TCAG"
_CODE = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
_GTR_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def gtr(rates, frequencies) -> Tuple[np.ndarray, np.ndarray]:
    """(Q [4, 4], pi [4]): Q[i, j] = rate_ij pi_j off the diagonal."""
    pi = np.asarray(frequencies, dtype=np.float64)
    Q = np.zeros((4, 4))
    for r, (i, j) in zip(np.asarray(rates, dtype=np.float64), _GTR_PAIRS):
        Q[i, j] = r * pi[j]
        Q[j, i] = r * pi[i]
    Q[np.diag_indices(4)] = -Q.sum(axis=1)
    return Q / -np.dot(pi, np.diag(Q)), pi


def _aa(codon: str) -> str:
    i, j, k = (_BASES.index(c) for c in codon)
    return _CODE[16 * i + 4 * j + k]


def mg94(rates, frequencies) -> Tuple[np.ndarray, np.ndarray]:
    """(Q [61, 61], pi [61]) from rates [kappa, omega] and nucleotide
    frequencies [4] in TCAG order: single-nucleotide changes only, times
    kappa for a transition, times omega for a nonsynonymous change, times
    the target codon's frequency."""
    kappa, omega = (float(x) for x in rates)
    f = dict(zip(_BASES, (float(x) for x in frequencies)))
    pi = np.array([f[c[0]] * f[c[1]] * f[c[2]] for c in SENSE_CODONS])
    pi = pi / pi.sum()
    n = len(SENSE_CODONS)
    Q = np.zeros((n, n))
    for i, ci in enumerate(SENSE_CODONS):
        for j, cj in enumerate(SENSE_CODONS):
            diffs = [(a, b) for a, b in zip(ci, cj) if a != b]
            if len(diffs) != 1:
                continue
            a, b = diffs[0]
            rate = pi[j]
            if (a in "AG") == (b in "AG"):
                rate *= kappa
            if _aa(ci) != _aa(cj):
                rate *= omega
            Q[i, j] = rate
    Q[np.diag_indices(n)] = -Q.sum(axis=1)
    return Q / -np.dot(pi, np.diag(Q)), pi


SUBSTITUTION = {"GTR": gtr, "MG94": mg94}


def categories(site: str, params: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(rates [C], proportions [C]) of the site model `site`: "constant"
    or "gamma+K" with shape params["site_model_parameters"][0]."""
    if site == "constant":
        return np.ones(1), np.ones(1)
    kind, _, count = site.partition("+")
    if kind != "gamma" or not count.isdigit():
        raise ValueError(f"unknown site model {site!r}")
    from scipy.special import gammaincinv  # imported after the window

    C = int(count)
    a = float(params["site_model_parameters"][0])
    x = gammaincinv(a, (2.0 * np.arange(C) + 1.0) / (2.0 * C)) / a
    return x / x.mean(), np.full(C, 1.0 / C)
