"""Site patterns of an alignment and their tip partials.

Columns are compressed to distinct patterns with their counts (any order:
the likelihood is a weighted sum over patterns).  A nucleotide tip is
one-hot over ACGT, a gap or unknown all ones; a codon tip is one-hot over
the 61 sense codons (TCAG order), a missing triplet or a stop codon all
ones over them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

NUCLEOTIDES = "ACGT"
SENSE_CODONS = [a + b + c for a in "TCAG" for b in "TCAG" for c in "TCAG"
                if a + b + c not in ("TAA", "TAG", "TGA")]


def _states(alignment: Dict[str, str], names: List[str], alphabet: str):
    """[taxa, columns] state ids; the alphabet's size means missing."""
    if alphabet == "nucleotide":
        index = {c: i for i, c in enumerate(NUCLEOTIDES)}
        width, A = 1, 4
    elif alphabet == "codon":
        index = {c: i for i, c in enumerate(SENSE_CODONS)}
        width, A = 3, len(SENSE_CODONS)
    else:
        raise ValueError(f"unknown alphabet {alphabet!r}")
    rows = []
    for name in names:
        seq = alignment[name].upper()
        rows.append([index.get(seq[k:k + width], A)
                     for k in range(0, len(seq) - width + 1, width)])
    return np.array(rows, dtype=np.int64), A


def site_patterns(alignment: Dict[str, str], names: List[str],
                  alphabet: str) -> Tuple[np.ndarray, np.ndarray]:
    """(tip partials [taxa, patterns, A] float64, weights [patterns])."""
    states, A = _states(alignment, names, alphabet)
    cols, counts = np.unique(states.T, axis=0, return_counts=True)
    table = np.vstack([np.eye(A), np.ones((1, A))])
    return table[cols.T], counts.astype(np.float64)
