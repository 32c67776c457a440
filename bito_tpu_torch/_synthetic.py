"""Seeded synthetic inputs: random trees as Newick text and random
nucleotide alignments.

Used by the tests and by chip_smoke.py, and by no library code.  Every
function takes a seed for numpy's default_rng, so the JAX package and the
port can be handed the very same text and sequences.

DS1 shape (the flagship workload of bito_tpu's benchmark): 27 taxa and
1,949 alignment columns drawn from 934 distinct random columns, which
compress to 934 site patterns, padded to 1,024 by the engines.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

BRANCH_LENGTHS = (0.02, 0.4)
# GTR+Gamma4 parameters of bito_tpu's bench.py, keyed by model block.
GTR_GAMMA4_PARAMS = {
    "substitution_model_rates": np.array([0.1, 0.3, 0.1, 0.2, 0.25, 0.05]),
    "substitution_model_frequencies": np.array([0.3, 0.25, 0.2, 0.25]),
    "site_model_parameters": np.array([0.5]),
}
DS1_TAXA = 27
DS1_SITES = 1949
DS1_DISTINCT_COLUMNS = 934


def taxon_names(num_taxa: int) -> List[str]:
    return [f"t{i}" for i in range(num_taxa)]


def _random_newick(rng: np.random.Generator, names: List[str],
                   rooted: bool) -> str:
    """Join random pairs of subtrees until two (binary root) or three
    (trifurcating root, an unrooted tree) remain."""
    lo, hi = BRANCH_LENGTHS

    def edge(sub: str) -> str:
        return f"{sub}:{rng.uniform(lo, hi):.6f}"

    subtrees = list(names)
    stop = 2 if rooted else 3
    while len(subtrees) > stop:
        i, j = sorted(rng.choice(len(subtrees), size=2, replace=False))
        right = subtrees.pop(j)
        left = subtrees.pop(i)
        subtrees.append(f"({edge(left)},{edge(right)})")
    return "(" + ",".join(edge(s) for s in subtrees) + ");"


def random_trees_newick(seed: int, num_taxa: int, num_trees: int,
                        rooted: bool = False) -> str:
    """`num_trees` random topologies over taxa t0..t{n-1}, one Newick line
    each, with branch lengths uniform in BRANCH_LENGTHS.  Unrooted trees
    have a trifurcating root, rooted ones a binary root."""
    rng = np.random.default_rng(seed)
    names = taxon_names(num_taxa)
    return "\n".join(_random_newick(rng, names, rooted)
                     for _ in range(num_trees)) + "\n"


def random_alignment(seed: int, names: List[str], num_sites: int,
                     num_distinct: int | None = None,
                     gap_rate: float = 0.03,
                     ambiguous_rate: float = 0.01) -> Dict[str, str]:
    """Random nucleotide sequences with gaps ('-') and unknowns ('N').

    The alignment's columns are drawn from `num_distinct` random columns
    (all of `num_sites` distinct by default), each used at least once, so
    it compresses to that many site patterns (barring chance repeats)."""
    rng = np.random.default_rng(seed)
    D = num_distinct or num_sites
    if D > num_sites:
        raise ValueError("num_distinct exceeds num_sites")
    chars = np.array(list("ACGT"))[rng.integers(0, 4, size=(len(names), D))]
    u = rng.random((len(names), D))
    chars[u < gap_rate] = "-"
    chars[(u >= gap_rate) & (u < gap_rate + ambiguous_rate)] = "N"
    cols = np.concatenate([np.arange(D), rng.integers(0, D, num_sites - D)])
    rng.shuffle(cols)
    mat = chars[:, cols]
    return {name: "".join(mat[i]) for i, name in enumerate(names)}


def ds1_shaped(seed: int, num_trees: int) -> Tuple[str, Dict[str, str]]:
    """(Newick text of `num_trees` unrooted trees, alignment) in DS1's
    shape: 27 taxa, 1,949 columns, 934 distinct."""
    names = taxon_names(DS1_TAXA)
    return (random_trees_newick(seed, DS1_TAXA, num_trees),
            random_alignment(seed + 1, names, DS1_SITES,
                             DS1_DISTINCT_COLUMNS))
