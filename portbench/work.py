"""The work of one evaluation, counted from the configuration's shapes,
whatever implements it, and the least time the card could take for it.

FLOPs are frozen copies of chip_smoke.py's `tree_flops` (lines 1700-1711,
as bench.py:135-150 counts them: per branch one block-diagonal evolve of
C categories' A x A matrices over the true patterns, the combines at the
internal nodes and the root, and for the gradient a preorder evolve, a dP
evolve and a weighted reduction per branch) and `codon_flops` (lines
3325-3335: the same over the 61 sense states).  Bytes count each operand
read once and each result written once: P and dP of every branch, the
tip partials, the weights, the log likelihoods and the gradients, in
float32.  `least_s` is chip_smoke.py's `bound` (lines 1718-1722).  A
call that returns log likelihoods alone counts the postorder pass, P,
the tips, the weights and the log likelihoods.
"""
from __future__ import annotations

SENSE_STATES = 61


def states(config: dict) -> int:
    return 4 if config["alphabet"] == "nucleotide" else SENSE_STATES


def categories(config: dict) -> int:
    site = config["model"]["site"]
    return 1 if site == "constant" else int(site.partition("+")[2])


def flops_per_tree(config: dict, patterns: int,
                   gradients: bool = True) -> float:
    """LL, and with `gradients` the branch gradients, of one tree over
    `patterns` patterns."""
    T, A, C, S = config["taxa"], states(config), categories(config), patterns
    E = 2 * T - 3                  # branches of an unrooted binary tree
    internal = T - 2               # internal nodes, the root among them
    evolve = 2 * A * A * C * S
    ll = E * evolve + internal * A * C * S + 2 * A * C * S
    return ll + E * (2 * evolve + 3 * A * C * S) if gradients else ll


def bytes_per_call(config: dict, patterns: int, batch: int,
                   gradients: bool = True) -> float:
    T, A, C, S = config["taxa"], states(config), categories(config), patterns
    B, N = batch, 2 * T - 2
    E = N - 1
    mats = 2 if gradients else 1   # P, and dP for the gradients
    out = B + B * N if gradients else B
    return 4.0 * (mats * B * E * C * A * A + T * S * A + S + out)


def least_s(config: dict, patterns: int, batch: int,
            gradients: bool = True) -> float:
    """The least seconds one call of `batch` evaluations could take: its
    FLOPs at the configuration's peak, or its bytes at the card's
    bandwidth, whichever is longer."""
    flops = batch * flops_per_tree(config, patterns, gradients)
    return max(flops / config["peak_flops"],
               bytes_per_call(config, patterns, batch, gradients)
               / config["peak_bytes"])
