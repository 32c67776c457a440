"""Seeded synthetic inputs: random trees as Newick text, random
nucleotide alignments and alignments simulated along a tree.

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


# A credible-set-like sample of rooted trees: one random rooted tree and,
# for each further tree, that tree after a few random rooted NNIs, so that
# the trees share most of their subsplits, as a posterior's credible set
# does.  CREDIBLE_TREES x CREDIBLE_NNIS over DS1's 27 taxa gives a subsplit
# DAG of the order of bito_tpu's config3 (DS1's credible set: 140 edges).
CREDIBLE_TREES = 12
CREDIBLE_NNIS = 2


def _rooted_nni(rng: np.random.Generator, tree):
    """One random rooted NNI of a nested-tuple tree: at an internal node c
    whose parent is internal, swap one of c's children with c's sibling."""
    paths = []  # paths to internal nodes that are not the root

    def walk(node, path):
        if isinstance(node, tuple):
            if path:
                paths.append(path)
            for i, child in enumerate(node):
                walk(child, path + (i,))

    walk(tree, ())
    path = paths[rng.integers(len(paths))]
    parent_path, side = path[:-1], path[-1]

    def get(node, p):
        for i in p:
            node = node[i]
        return node

    def put(node, p, value):
        if not p:
            return value
        items = list(node)
        items[p[0]] = put(node[p[0]], p[1:], value)
        return tuple(items)

    parent = get(tree, parent_path)
    child, sibling = parent[side], parent[1 - side]
    k = int(rng.integers(2))
    new_child = tuple(sibling if i == k else c for i, c in enumerate(child))
    new_parent = tuple(new_child if i == side else child[k]
                       for i in range(2))
    return put(tree, parent_path, new_parent)


def credible_set_newick(seed: int, num_taxa: int,
                        num_trees: int = CREDIBLE_TREES,
                        nnis: int = CREDIBLE_NNIS) -> str:
    """Newick text of `num_trees` rooted trees with branch lengths over
    taxa t0..t{n-1}: a random rooted tree, then that tree after `nnis`
    random rooted NNIs, a new draw each line; branch lengths uniform in
    BRANCH_LENGTHS, drawn anew for each tree."""
    rng = np.random.default_rng(seed)
    subtrees = list(taxon_names(num_taxa))
    while len(subtrees) > 1:
        i, j = sorted(rng.choice(len(subtrees), size=2, replace=False))
        right, left = subtrees.pop(j), subtrees.pop(i)
        subtrees.append((left, right))
    base = subtrees[0]
    lo, hi = BRANCH_LENGTHS

    def newick(node) -> str:
        if isinstance(node, str):
            return node
        return "(" + ",".join(f"{newick(c)}:{rng.uniform(lo, hi):.6f}"
                              for c in node) + ")"

    lines = []
    for t in range(num_trees):
        tree = base
        for _ in range(nnis if t else 0):
            tree = _rooted_nni(rng, tree)
        lines.append(newick(tree) + ";")
    return "\n".join(lines) + "\n"


# Dated taxa: dates in years with three decimals, node heights above their
# older child by an interval uniform in HEIGHT_STEPS years.
DATE_SPAN = 20.0
HEIGHT_STEPS = (0.5, 10.0)


def dated_taxon_names(seed: int, num_taxa: int,
                      date_span: float = DATE_SPAN) -> Dict[str, float]:
    """{name: date}: taxa t{i}_{date}, each date 2000 + uniform(0,
    date_span) years written with three decimals, so that a parser of
    the `_<date>` suffix reads the date back exactly; date_span 0 dates
    every taxon 2000.000."""
    rng = np.random.default_rng(seed)
    dates = np.round(2000.0 + rng.uniform(0.0, date_span, num_taxa), 3)
    return {f"t{i}_{d:.3f}": float(f"{d:.3f}") for i, d in enumerate(dates)}


def dated_trees_newick(seed: int, num_taxa: int, num_trees: int,
                       date_span: float = DATE_SPAN
                       ) -> Tuple[str, Dict[str, float]]:
    """(Newick text of `num_trees` random time-calibrated rooted trees, the
    taxa's dates).  A tip's height is the latest date less its own; random
    pairs of subtrees join at a height HEIGHT_STEPS above the older one,
    down to a binary root; each branch length is the height difference,
    written with 17 significant digits, so that heights rebuilt from the
    branch lengths agree below 1e-6 (rooted.BRANCH_LENGTH_TOLERANCE)."""
    rng = np.random.default_rng(seed)
    dates = dated_taxon_names(seed + 1, num_taxa, date_span)
    latest = max(dates.values())
    lo, hi = HEIGHT_STEPS

    def tree() -> str:
        subtrees = [(name, latest - date) for name, date in dates.items()]
        while len(subtrees) > 1:
            i, j = sorted(rng.choice(len(subtrees), size=2, replace=False))
            (right, h_r), (left, h_l) = subtrees.pop(j), subtrees.pop(i)
            h = max(h_l, h_r) + rng.uniform(lo, hi)
            subtrees.append((f"({left}:{h - h_l:.17g},{right}:{h - h_r:.17g})",
                             h))
        return subtrees[0][0] + ";"

    return "\n".join(tree() for _ in range(num_trees)) + "\n", dates


def dates_csv(dates: Dict[str, float]) -> str:
    """The dates as CSV text, one `name,date` row a taxon."""
    return "".join(f"{name},{date!r}\n" for name, date in dates.items())


def cherry_comb_newick(seed: int, num_cherries: int, num_trees: int) -> str:
    """`num_trees` copies of one rooted topology over 2 * num_cherries + 1
    taxa, ((t0,t1),((t2,t3),( ... ,t{2k}))), with random branch lengths.
    Its postorder keeps every cherry's partial until the spine below it
    is done: about a third of the taxa's partials are live at once."""
    rng = np.random.default_rng(seed)
    names = taxon_names(2 * num_cherries + 1)
    lo, hi = BRANCH_LENGTHS

    def tree() -> str:
        def edge(sub: str) -> str:
            return f"{sub}:{rng.uniform(lo, hi):.6f}"

        sub = names[-1]
        for i in range(num_cherries - 1, -1, -1):
            cherry = f"({edge(names[2 * i])},{edge(names[2 * i + 1])})"
            sub = f"({edge(cherry)},{edge(sub)})"
        return sub + ";"

    return "\n".join(tree() for _ in range(num_trees)) + "\n"


def balanced_newick(seed: int, num_taxa: int, num_trees: int) -> str:
    """`num_trees` copies of one rooted topology over `num_taxa` taxa, the
    taxa halved at every node (the first half gets the odd one), with
    random branch lengths.  The chunked schedule (treelike/chunked.py)
    runs it a level at a time, deepest first, so about half of the taxa's
    partials are live at once in its grid order."""
    rng = np.random.default_rng(seed)
    names = taxon_names(num_taxa)
    lo, hi = BRANCH_LENGTHS

    def sub(lo_i: int, hi_i: int) -> str:
        if hi_i - lo_i == 1:
            return names[lo_i]
        mid = (lo_i + hi_i + 1) // 2
        return "({},{})".format(
            *(f"{sub(a, b)}:{rng.uniform(lo, hi):.6f}"
              for a, b in ((lo_i, mid), (mid, hi_i))))

    return "\n".join(sub(0, num_taxa) + ";" for _ in range(num_trees)) + "\n"


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


# The 61 sense codons of the universal code, in TCAG order (as
# models/codon.py's SENSE_CODONS; this module imports no model code).
_SENSE_CODONS = [a + b + c for a in "TCAG" for b in "TCAG" for c in "TCAG"
                 if a + b + c not in ("TAA", "TAG", "TGA")]
# Codon config6's shape: DS1 read as codons, 649 triplets of which 573
# are distinct patterns.
DS1_CODONS = 649
DS1_DISTINCT_CODON_COLUMNS = 573


def codon_alignment(seed: int, names: List[str], num_codons: int,
                    num_distinct: int | None = None,
                    missing_rate: float = 0.05) -> Dict[str, str]:
    """Random codon sequences over the 61 sense codons, with missing
    ('---') and stop ('TAA', read as missing) triplets at `missing_rate`
    in all, half each, as bito_tpu's tests/test_codon.py makes them.

    The columns are drawn from `num_distinct` random codon columns (all
    of `num_codons` distinct by default), each used at least once, as
    random_alignment draws nucleotide columns."""
    rng = np.random.default_rng(seed)
    D = num_distinct or num_codons
    if D > num_codons:
        raise ValueError("num_distinct exceeds num_codons")
    tokens = np.array(_SENSE_CODONS + ["---", "TAA"])
    idx = rng.integers(0, len(_SENSE_CODONS), size=(len(names), D))
    u = rng.random((len(names), D))
    idx[u < missing_rate / 2] = len(_SENSE_CODONS)
    idx[(u >= missing_rate / 2) & (u < missing_rate)] = len(_SENSE_CODONS) + 1
    cols = np.concatenate([np.arange(D), rng.integers(0, D, num_codons - D)])
    rng.shuffle(cols)
    mat = tokens[idx[:, cols]]
    return {name: "".join(mat[i]) for i, name in enumerate(names)}


# Sense codons four at a time, each differing from the other three at all
# three positions.
_DISJOINT_CODONS = (("AAA", "CCC", "GGG", "TTT"), ("ACG", "CGT", "GTA", "TAC"),
                    ("AGT", "CTA", "GAC", "TCG"))


def disagreeing_codons(seed: int, num_cherries: int, num_codons: int,
                       branch_length: float) -> Tuple[str, Dict[str, str]]:
    """(Newick text of one unrooted tree, alignment) at the edge of float32's
    range: 2 * `num_cherries` taxa (at least 6) in cherries joined into a
    caterpillar, every branch `branch_length` long, and codon columns in
    which the two tips of each cherry differ at all three positions, so
    that each cherry's partial is of the order of `branch_length` cubed."""
    if num_cherries < 3:
        raise ValueError("num_cherries must be at least 3")
    rng = np.random.default_rng(seed)
    names = taxon_names(2 * num_cherries)
    t = repr(float(branch_length))
    nodes = [f"({names[2 * k]}:{t},{names[2 * k + 1]}:{t})"
             for k in range(num_cherries)]
    while len(nodes) > 3:
        nodes = [f"({nodes[0]}:{t},{nodes[1]}:{t})"] + nodes[2:]
    newick = "(" + ",".join(f"{x}:{t}" for x in nodes) + ");"
    seqs: Dict[str, List[str]] = {n: [] for n in names}
    for _ in range(num_codons):
        codons = _DISJOINT_CODONS[rng.integers(len(_DISJOINT_CODONS))]
        for k in range(num_cherries):
            i, j = rng.choice(4, 2, replace=False)
            seqs[names[2 * k]].append(codons[i])
            seqs[names[2 * k + 1]].append(codons[j])
    return newick, {n: "".join(v) for n, v in seqs.items()}


def ds1_shaped(seed: int, num_trees: int) -> Tuple[str, Dict[str, str]]:
    """(Newick text of `num_trees` unrooted trees, alignment) in DS1's
    shape: 27 taxa, 1,949 columns, 934 distinct."""
    names = taxon_names(DS1_TAXA)
    return (random_trees_newick(seed, DS1_TAXA, num_trees),
            random_alignment(seed + 1, names, DS1_SITES,
                             DS1_DISTINCT_COLUMNS))


def mcmc_nexus(seed: int, num_taxa: int, num_trees: int) -> str:
    """A Nexus tree file in the shape of an MCMC run's output: a translate
    table from keys 1..n to taxa t0..t{n-1}, then `num_trees` unrooted
    trees over the keys.  The trees are random_trees_newick's for the same
    seed, with each taxon written as its key."""
    rng = np.random.default_rng(seed)
    names = taxon_names(num_taxa)
    keys = [str(i + 1) for i in range(num_taxa)]
    lines = ["#NEXUS", "", "begin trees;", "  translate"]
    lines += [f"    {k} {name}" + ("," if i + 1 < num_taxa else ";")
              for i, (k, name) in enumerate(zip(keys, names))]
    lines += [f"  tree STATE_{i} = " + _random_newick(rng, keys, rooted=False)
              for i in range(num_trees)]
    return "\n".join(lines + ["end;", ""])


def fasta_text(alignment: Dict[str, str]) -> str:
    """The alignment as FASTA text, one line a sequence."""
    return "".join(f">{name}\n{seq}\n" for name, seq in alignment.items())


def write_vbpi_inputs(directory, seed: int, num_taxa: int, num_trees: int,
                      num_sites: int, num_distinct: int | None = None
                      ) -> Tuple[str, str]:
    """Write a VBPI run's two inputs into `directory`: mcmc.t
    (mcmc_nexus) and alignment.fasta (random_alignment over the same taxa,
    seeded with seed + 1).  Returns their paths."""
    import os

    nexus = os.path.join(directory, "mcmc.t")
    fasta = os.path.join(directory, "alignment.fasta")
    with open(nexus, "w") as f:
        f.write(mcmc_nexus(seed, num_taxa, num_trees))
    with open(fasta, "w") as f:
        f.write(fasta_text(random_alignment(
            seed + 1, taxon_names(num_taxa), num_sites, num_distinct)))
    return nexus, fasta


def _parse_nested(newick: str):
    """One Newick tree (names, branch lengths, no inner labels) as nested
    tuples: a leaf is its name, an inner node a tuple of (child, length)
    pairs."""
    text, pos = newick.strip(), 0

    def node():
        nonlocal pos
        if text[pos] != "(":
            start = pos
            while text[pos] not in ",):;":
                pos += 1
            return text[start:pos]
        pos += 1
        kids = [edge()]
        while text[pos] == ",":
            pos += 1
            kids.append(edge())
        pos += 1  # ')'
        return tuple(kids)

    def edge():
        nonlocal pos
        sub, length = node(), 0.0
        if text[pos] == ":":
            pos += 1
            start = pos
            while text[pos] not in ",);":
                pos += 1
            length = float(text[start:pos])
        return sub, length

    return node()


def simulated_alignment(seed: int, newick: str, num_sites: int,
                        num_distinct: int | None = None,
                        gap_rate: float = 0.03,
                        ambiguous_rate: float = 0.01) -> Dict[str, str]:
    """Nucleotide sequences simulated under JC69 along the first tree of
    `newick` (with branch lengths), with gaps ('-') and unknowns ('N').

    `num_distinct` columns (all of `num_sites` by default) are simulated:
    a uniform state at the root, and along an edge of length t each site
    keeps its state with probability exp(-4t/3) and otherwise takes a
    uniform one.  Gaps and unknowns then replace cells at random, and the
    alignment's columns are drawn from the simulated ones, each used at
    least once, as in random_alignment.  Unlike random_alignment's, the
    columns carry the tree's signal, so likelihoods tell topologies apart."""
    rng = np.random.default_rng(seed)
    D = num_distinct or num_sites
    if D > num_sites:
        raise ValueError("num_distinct exceeds num_sites")
    states: Dict[str, np.ndarray] = {}

    def walk(node, at):
        if isinstance(node, str):
            states[node] = at
            return
        for child, t in node:
            keep = rng.random(D) < np.exp(-4.0 * t / 3.0)
            walk(child, np.where(keep, at, rng.integers(0, 4, D)))

    walk(_parse_nested(newick.strip().splitlines()[0]),
         rng.integers(0, 4, D))
    names = list(states)
    chars = np.array(list("ACGT"))[np.stack([states[n] for n in names])]
    u = rng.random((len(names), D))
    chars[u < gap_rate] = "-"
    chars[(u >= gap_rate) & (u < gap_rate + ambiguous_rate)] = "N"
    cols = np.concatenate([np.arange(D), rng.integers(0, D, num_sites - D)])
    rng.shuffle(cols)
    mat = chars[:, cols]
    return {name: "".join(mat[i]) for i, name in enumerate(names)}


# The NNI search's inputs: the truth is the seed tree after TRUTH_NNIS
# random rooted NNIs, so that the search has somewhere to go.
TRUTH_NNIS = 3


def write_nni_inputs(directory, seed: int, num_taxa: int, num_sites: int,
                     num_distinct: int | None = None,
                     truth_nnis: int = TRUTH_NNIS) -> Dict[str, str]:
    """Write an NNI search's inputs into `directory` and return their
    paths by name:
      seed.nwk         the seed: credible_set_newick(seed, num_taxa)'s
                       first tree, a random rooted tree;
      credible.nwk     that credible set (CREDIBLE_TREES trees, the seed
                       and its CREDIBLE_NNIS-NNI neighbours);
      pp.csv           one posterior weight a credible tree, uniform;
      pcsp_pp.csv      each PCSP's summed weight over the credible trees
                       (index, parent, child, pcsp_pp; subsplits written
                       clade|clade);
      alignment.fasta  simulated_alignment(seed + 1, ...) along the truth,
                       the seed after `truth_nnis` random rooted NNIs."""
    import csv
    import os

    from .core.bitset import Subsplit
    from .core.newick import parse_newick_text

    credible = credible_set_newick(seed, num_taxa)
    first = credible.splitlines()[0]
    truth = credible_set_newick(seed, num_taxa, 2, truth_nnis).splitlines()[1]
    paths = {name: os.path.join(directory, name) for name in (
        "seed.nwk", "credible.nwk", "pp.csv", "pcsp_pp.csv",
        "alignment.fasta")}
    trees = parse_newick_text(credible).trees
    weight = 1.0 / len(trees)
    pcsp_pp: Dict[Tuple[str, str], float] = {}
    for tree in trees:
        topo = tree.topology
        n, cl, ch = topo.num_taxa, topo.clades(), topo.children()
        ss = {v: Subsplit.leaf(v, n) for v in range(n)}
        for v in range(n, topo.num_nodes):
            ss[v] = Subsplit.of_pair(cl[ch[v][0]], cl[ch[v][1]], n)
        for v in range(topo.num_nodes - 1):
            key = (ss[int(topo.parents[v])].pretty(), ss[v].pretty())
            pcsp_pp[key] = pcsp_pp.get(key, 0.0) + weight
    with open(paths["seed.nwk"], "w") as f:
        f.write(first + "\n")
    with open(paths["credible.nwk"], "w") as f:
        f.write(credible)
    with open(paths["pp.csv"], "w") as f:
        f.write("".join(f"{weight!r}\n" for _ in trees))
    with open(paths["pcsp_pp.csv"], "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "parent", "child", "pcsp_pp"])
        for i, ((parent, child), pp) in enumerate(sorted(pcsp_pp.items())):
            w.writerow([i, parent, child, repr(pp)])
    with open(paths["alignment.fasta"], "w") as f:
        f.write(fasta_text(simulated_alignment(
            seed + 1, truth, num_sites, num_distinct)))
    return paths
