"""Site-pattern compression and tip partials.

Host-side copy of bito_tpu.core.site_pattern (numpy only), the codon
pattern class included (pinned by AST in tests/test_torch_codon.py).
Rebuild of the reference SitePattern
(reference: src/site_pattern.cpp:15-120).  An alignment is compressed into
unique site-pattern columns with multiplicity weights; tips get one-hot
partials for A/C/G/T and all-ones for gaps/ambiguous codes (symbol 4), exactly
the reference's symbol table (src/site_pattern.cpp:16-46).

The device-facing products are numpy arrays:
  - patterns: int8 [num_taxa, num_patterns] symbols in 0..4
  - weights:  float [num_patterns] pattern multiplicities
  - tip_partials(): float [num_taxa, num_patterns, 4]
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

_SYMBOLS = {
    "A": 0, "C": 1, "G": 2, "T": 3,
    "a": 0, "c": 1, "g": 2, "t": 3,
    "-": 4, "N": 4, "X": 4, "?": 4,
    # Degenerate nucleotides are treated as gaps, as in the reference.
    "B": 4, "D": 4, "H": 4, "K": 4, "M": 4, "R": 4, "S": 4,
    "U": 4, "V": 4, "W": 4, "Y": 4,
    "n": 4, "x": 4, "b": 4, "d": 4, "h": 4, "k": 4, "m": 4, "r": 4,
    "s": 4, "u": 4, "v": 4, "w": 4, "y": 4,
}

_LOOKUP = np.full(256, -1, dtype=np.int8)
for ch, v in _SYMBOLS.items():
    _LOOKUP[ord(ch)] = v


class SitePattern:
    def __init__(self, alignment: Dict[str, str], taxon_names: Sequence[str]):
        """alignment: taxon name -> sequence; taxon_names defines row order."""
        missing = [t for t in taxon_names if t not in alignment]
        if missing:
            raise ValueError(f"Alignment missing taxa: {missing}")
        lengths = {len(alignment[t]) for t in taxon_names}
        if len(lengths) != 1:
            raise ValueError("Alignment sequences have unequal lengths")
        self.taxon_names = list(taxon_names)
        mat = np.vstack(
            [
                _LOOKUP[np.frombuffer(alignment[t].encode("latin1"), dtype=np.uint8)]
                for t in taxon_names
            ]
        )
        if (mat < 0).any():
            bad = sorted(
                set(
                    chr(b)
                    for t in taxon_names
                    for b in alignment[t].encode("latin1")
                    if _LOOKUP[b] < 0
                )
            )
            raise ValueError(f"Unknown symbols in alignment: {bad}")
        self.site_count = mat.shape[1]
        # Compress columns to unique patterns, first-occurrence order.
        cols = np.ascontiguousarray(mat.T)
        _, first_idx, inverse, counts = np.unique(
            cols.view([("", cols.dtype)] * cols.shape[1]),
            return_index=True,
            return_inverse=True,
            return_counts=True,
        )
        order = np.argsort(first_idx)
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        self.patterns = np.ascontiguousarray(cols[np.sort(first_idx)].T).astype(np.int8)
        self.weights = counts[order].astype(np.float64)
        self.site_to_pattern = rank[inverse.ravel()].astype(np.int32)

    @property
    def pattern_count(self) -> int:
        return self.patterns.shape[1]

    @property
    def num_taxa(self) -> int:
        return self.patterns.shape[0]

    def tip_partials(self, dtype=np.float64) -> np.ndarray:
        """[num_taxa, num_patterns, 4]; one-hot, gaps -> ones (reference
        SitePattern::GetPartials, src/site_pattern.cpp:115-133)."""
        table = np.vstack([np.eye(4), np.ones((1, 4))]).astype(dtype)
        return table[self.patterns]

    def tip_states(self) -> np.ndarray:
        """[num_taxa, num_patterns] int states (4 = gap)."""
        return self.patterns.copy()


class CodonSitePattern:
    """Codon-triplet site patterns for the A=64 MG94 path: the alignment
    is read three nucleotides at a time, codon columns are compressed to
    unique patterns with multiplicity weights, and tips get one-hot
    partials over the 61 sense codons (missing = any triplet containing a
    gap/ambiguity or a stop codon -> all-ones over sense states, zeros on
    the 3 pad states).  Same surface as SitePattern (`pattern_count`,
    `num_taxa`, `weights`, `tip_partials`) so TreeLikelihoodEngine works
    unchanged; the reference has no codon support to mirror (its engine
    is hard-wired to BEAGLE's 4-state kernels, src/fat_beagle.cpp)."""

    def __init__(self, alignment: Dict[str, str],
                 taxon_names: Sequence[str]):
        from ..models.codon import CODON_INDEX, NUM_CODONS, PADDED_STATES

        missing = [t for t in taxon_names if t not in alignment]
        if missing:
            raise ValueError(f"Alignment missing taxa: {missing}")
        lengths = {len(alignment[t]) for t in taxon_names}
        if len(lengths) != 1:
            raise ValueError("Alignment sequences have unequal lengths")
        L = lengths.pop()
        if L % 3:
            # Trailing partial codon is dropped (common in curated data).
            L -= L % 3
        self.taxon_names = list(taxon_names)
        self.site_count = L // 3
        self.num_sense = NUM_CODONS
        self.num_states = PADDED_STATES
        MISSING = NUM_CODONS  # sentinel state index
        mat = np.full((len(taxon_names), self.site_count), MISSING,
                      dtype=np.int8)
        for t, name in enumerate(taxon_names):
            seq = alignment[name].upper().replace("U", "T")
            for s in range(self.site_count):
                idx = CODON_INDEX.get(seq[3 * s:3 * s + 3])
                if idx is not None:
                    mat[t, s] = idx
        cols = np.ascontiguousarray(mat.T)
        _, first_idx, inverse, counts = np.unique(
            cols.view([("", cols.dtype)] * cols.shape[1]),
            return_index=True, return_inverse=True, return_counts=True)
        order = np.argsort(first_idx)
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        self.patterns = np.ascontiguousarray(
            cols[np.sort(first_idx)].T).astype(np.int8)
        self.weights = counts[order].astype(np.float64)
        self.site_to_pattern = rank[inverse.ravel()].astype(np.int32)

    @property
    def pattern_count(self) -> int:
        return self.patterns.shape[1]

    @property
    def num_taxa(self) -> int:
        return self.patterns.shape[0]

    def tip_partials(self, dtype=np.float64) -> np.ndarray:
        """[num_taxa, num_patterns, 64]: one-hot over sense codons;
        missing -> ones over the 61 sense states, zeros on pads."""
        table = np.zeros((self.num_sense + 1, self.num_states), dtype)
        table[np.arange(self.num_sense), np.arange(self.num_sense)] = 1.0
        table[self.num_sense, : self.num_sense] = 1.0
        return table[self.patterns]

    def tip_states(self) -> np.ndarray:
        """[num_taxa, num_patterns] int states (61 = missing)."""
        return self.patterns.copy()
