"""Seeded inputs of a cell: random unrooted trees as parent arrays, and
nucleotide or codon alignments.

Frozen copies of bito_tpu_torch/_synthetic.py (`_random_newick`,
`random_trees_newick`: lines 31-57; `random_alignment`: lines 236-256;
`codon_alignment`: lines 259-295), kept here so that a change to the
program cannot change the benchmark's inputs.  The trees are built as the
copied generator builds its Newick text, draw for draw, and numbered as
the program's Newick reader numbers them (tips by taxon id, internal
nodes in postorder from the number of taxa, the root last), so the parent
arrays are the raw input that both the program and the reference read.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

BRANCH_LENGTHS = (0.02, 0.4)
# The 61 sense codons of the universal code, in TCAG order.
SENSE_CODONS = [a + b + c for a in "TCAG" for b in "TCAG" for c in "TCAG"
                if a + b + c not in ("TAA", "TAG", "TGA")]


@dataclass
class TreeSet:
    """`parents` [B, N] int64 (the root, node N - 1, has parent -1) and
    `lengths` [B, N] float64 (the root's entry 0) of B unrooted trees over
    `taxa` tips."""
    parents: np.ndarray
    lengths: np.ndarray
    taxa: int


def taxon_names(num_taxa: int) -> List[str]:
    return [f"t{i}" for i in range(num_taxa)]


def _random_tree(rng: np.random.Generator, num_taxa: int):
    """One random unrooted tree: random pairs of subtrees joined until
    three remain, which join at a trifurcating root.  A subtree is a taxon
    id or a list of (subtree, length) pairs; lengths are drawn, and rounded
    to the copied generator's six decimals, in its order."""
    lo, hi = BRANCH_LENGTHS

    def edge(sub):
        return sub, round(float(rng.uniform(lo, hi)), 6)

    subtrees = list(range(num_taxa))
    while len(subtrees) > 3:
        i, j = sorted(rng.choice(len(subtrees), size=2, replace=False))
        right = subtrees.pop(j)
        left = subtrees.pop(i)
        subtrees.append([edge(left), edge(right)])
    return [edge(s) for s in subtrees]


def _number(tree, num_taxa: int):
    """(parents, lengths) of a nested tree, internal nodes numbered in
    postorder from num_taxa."""
    n = 2 * num_taxa - 2
    parents = np.full(n, -1, dtype=np.int64)
    lengths = np.zeros(n)
    next_id = [num_taxa]

    def assign(node) -> int:
        if isinstance(node, int):
            return node
        kids = [(assign(sub), t) for sub, t in node]
        nid = next_id[0]
        next_id[0] += 1
        for k, t in kids:
            parents[k] = nid
            lengths[k] = t
        return nid

    root = assign(tree)
    if root != n - 1:
        raise ValueError(f"root numbered {root}, expected {n - 1}")
    return parents, lengths


def random_trees(seed: int, num_taxa: int, num_trees: int) -> TreeSet:
    """`num_trees` random unrooted topologies over `num_taxa` taxa, with
    branch lengths uniform in BRANCH_LENGTHS (random_trees_newick's)."""
    rng = np.random.default_rng(seed)
    rows = [_number(_random_tree(rng, num_taxa), num_taxa)
            for _ in range(num_trees)]
    return TreeSet(np.stack([p for p, _ in rows]),
                   np.stack([t for _, t in rows]), num_taxa)


def cycled(trees: TreeSet, batch: int) -> TreeSet:
    """The trees repeated in order to a batch of `batch`."""
    idx = np.arange(batch) % trees.parents.shape[0]
    return TreeSet(trees.parents[idx], trees.lengths[idx], trees.taxa)


def random_alignment(seed: int, names: List[str], num_sites: int,
                     num_distinct: int, gap_rate: float = 0.03,
                     ambiguous_rate: float = 0.01) -> Dict[str, str]:
    """Random nucleotide sequences with gaps ('-') and unknowns ('N'),
    whose columns are drawn from `num_distinct` random columns, each used
    at least once."""
    rng = np.random.default_rng(seed)
    D = num_distinct
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


def codon_alignment(seed: int, names: List[str], num_codons: int,
                    num_distinct: int,
                    missing_rate: float = 0.05) -> Dict[str, str]:
    """Random codon sequences over the 61 sense codons, with missing
    ('---') and stop ('TAA', read as missing) triplets at `missing_rate`
    in all, half each; columns drawn from `num_distinct` random codon
    columns, each used at least once."""
    rng = np.random.default_rng(seed)
    D = num_distinct
    if D > num_codons:
        raise ValueError("num_distinct exceeds num_codons")
    tokens = np.array(SENSE_CODONS + ["---", "TAA"])
    idx = rng.integers(0, len(SENSE_CODONS), size=(len(names), D))
    u = rng.random((len(names), D))
    idx[u < missing_rate / 2] = len(SENSE_CODONS)
    idx[(u >= missing_rate / 2) & (u < missing_rate)] = len(SENSE_CODONS) + 1
    cols = np.concatenate([np.arange(D), rng.integers(0, D, num_codons - D)])
    rng.shuffle(cols)
    mat = tokens[idx[:, cols]]
    return {name: "".join(mat[i]) for i, name in enumerate(names)}


@dataclass
class CellInputs:
    """What a cell's seed makes: the trees (the batch, or a pool that each
    call draws its batch from) and the alignment."""
    trees: TreeSet
    alignment: Dict[str, str]
    names: List[str]


def make_inputs(config: dict, seed: int, batch: int,
                pool: Optional[int] = None) -> CellInputs:
    """The configuration's trees (from `seed`) and alignment (from
    `seed + 1`), as _synthetic.ds1_shaped seeds them.  The trees are the
    configuration's topologies cycled to `batch`, or with `pool` that many
    topologies."""
    T = config["taxa"]
    names = taxon_names(T)
    if pool is None:
        trees = cycled(random_trees(seed, T, config["topologies"]), batch)
    else:
        trees = random_trees(seed, T, pool)
    if config["alphabet"] == "nucleotide":
        aln = random_alignment(seed + 1, names, config["columns"],
                               config["distinct_columns"])
    elif config["alphabet"] == "codon":
        aln = codon_alignment(seed + 1, names, config["columns"],
                              config["distinct_columns"])
    else:
        raise ValueError(f"unknown alphabet {config['alphabet']!r}")
    return CellInputs(trees, aln, names)
