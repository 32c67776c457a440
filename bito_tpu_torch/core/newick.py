"""Newick / Nexus tree parsing and FASTA reading.

Host-side copy of bito_tpu.core.newick (the port imports no module of
bito_tpu, whose package import pulls in jax), with both of its parsers:
parse_newick_file and parse_nexus_file parse in the port's native library
(bito_tpu_torch._native, bitocore's parser) unless the caller passes
`sort_taxa=True` (which the native parser does not take), and then in the
recursive-descent parser below, which parse_newick_text and
parse_nexus_text always use.  bito_tpu falls back to the Python parser
when its library is missing; the port does not: a native library that
fails to build raises.

Rebuild of the reference's flex/bison tree parser (src/parser.yy,
src/scanner.ll) and Alignment::ReadFasta (src/alignment.cpp).  A recursive-descent parser replaces
the generated LALR parser; semantics reproduced:

  - quoted taxon labels ('...' with '' escape), bracket comments skipped
    (BEAST-style [&...] metadata), branch lengths after ':',
  - taxon ids assigned by order of appearance in the first tree, or by the
    Nexus translate table, or alphabetically when sort_taxa=True
    (reference src/pybito.cpp:380-383),
  - gzip transparently handled for .gz paths (reference src/zlib_stream.hpp).
"""
from __future__ import annotations

import gzip
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import _native
from .tree import Topology, Tree, TreeCollection


def _open_text(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


class _ParsedNode:
    __slots__ = ("label", "length", "children")

    def __init__(self):
        self.label: Optional[str] = None
        self.length: Optional[float] = None
        self.children: List["_ParsedNode"] = []


def _parse_newick_string(s: str) -> _ParsedNode:
    i = 0
    n = len(s)

    def skip_ws_and_comments():
        nonlocal i
        while i < n:
            c = s[i]
            if c in " \t\r\n":
                i += 1
            elif c == "[":
                depth = 1
                i += 1
                while i < n and depth:
                    if s[i] == "[":
                        depth += 1
                    elif s[i] == "]":
                        depth -= 1
                    i += 1
            else:
                break

    def parse_label() -> Optional[str]:
        nonlocal i
        skip_ws_and_comments()
        if i < n and s[i] == "'":
            i += 1
            out = []
            while i < n:
                if s[i] == "'":
                    if i + 1 < n and s[i + 1] == "'":
                        out.append("'")
                        i += 2
                    else:
                        i += 1
                        break
                else:
                    out.append(s[i])
                    i += 1
            return "".join(out)
        start = i
        while i < n and s[i] not in "():,;[ \t\r\n":
            i += 1
        return s[start:i] if i > start else None

    def parse_node() -> _ParsedNode:
        nonlocal i
        node = _ParsedNode()
        skip_ws_and_comments()
        if i < n and s[i] == "(":
            i += 1
            while True:
                node.children.append(parse_node())
                skip_ws_and_comments()
                if i < n and s[i] == ",":
                    i += 1
                    continue
                break
            skip_ws_and_comments()
            if i >= n or s[i] != ")":
                raise ValueError(f"Expected ')' at position {i} in newick")
            i += 1
        node.label = parse_label()
        skip_ws_and_comments()
        if i < n and s[i] == ":":
            i += 1
            skip_ws_and_comments()
            start = i
            while i < n and (s[i].isdigit() or s[i] in ".+-eE"):
                i += 1
            node.length = float(s[start:i])
        return node

    root = parse_node()
    skip_ws_and_comments()
    if i < n and s[i] == ";":
        i += 1
    return root


def _build_tree(
    parsed: _ParsedNode, taxon_ids: Dict[str, int], allow_new: bool
) -> Tree:
    """Convert a parsed node into an array Tree, assigning internal ids in
    postorder (reference Node::Polish)."""
    # First pass: leaves.
    leaves: List[Tuple[_ParsedNode, int]] = []

    def visit_leaves(node: _ParsedNode):
        if not node.children:
            label = node.label
            if label is None:
                raise ValueError("Leaf without a label in newick")
            if label not in taxon_ids:
                if not allow_new:
                    raise ValueError(f"Unknown taxon {label!r}")
                taxon_ids[label] = len(taxon_ids)
            leaves.append((node, taxon_ids[label]))
        else:
            for c in node.children:
                visit_leaves(c)

    visit_leaves(parsed)
    num_taxa = len(taxon_ids)

    parents: List[int] = []
    lengths: List[float] = []
    # ids: leaves 0..num_taxa-1; internals assigned in postorder.
    n_internal = _count_internal(parsed)
    n_nodes = num_taxa + n_internal
    parent_arr = [-1] * n_nodes
    length_arr = [0.0] * n_nodes
    next_internal = [num_taxa]

    def assign(node: _ParsedNode) -> int:
        if not node.children:
            nid = taxon_ids[node.label]
        else:
            kids = [assign(c) for c in node.children]
            nid = next_internal[0]
            next_internal[0] += 1
            for k in kids:
                parent_arr[k] = nid
        length_arr[nid] = node.length if node.length is not None else 0.0
        return nid

    root_id = assign(parsed)
    parent_arr[root_id] = -1
    topo = Topology(parent_arr, num_taxa)
    return Tree(topo, np.asarray(length_arr))


def _count_internal(node: _ParsedNode) -> int:
    return (0 if not node.children else 1) + sum(
        _count_internal(c) for c in node.children
    )


def _native_collection(text: str, is_nexus: bool) -> TreeCollection:
    """Parse with the native bitocore parser."""
    taxa, raw_trees = _native.parse_trees(text, is_nexus)
    trees = [
        Tree(Topology(parents, len(taxa)), lengths)
        for parents, lengths in raw_trees
    ]
    return TreeCollection(trees, taxa)


def read_text(path: str) -> str:
    """A tree file's text (gzip is transparent)."""
    with _open_text(path) as f:
        return f.read()


def parse_newick_file(path: str, sort_taxa: bool = False) -> TreeCollection:
    text = read_text(path)
    if sort_taxa:
        return parse_newick_text(text, sort_taxa=True)
    return _native_collection(text, is_nexus=False)


def parse_newick_text(
    text: str, sort_taxa: bool = False, taxon_names: Optional[Sequence[str]] = None
) -> TreeCollection:
    lines = [ln.strip() for ln in text.split("\n")]
    tree_strings = [ln for ln in lines if ln and not ln.startswith("#")]
    taxon_ids: Dict[str, int] = {}
    if taxon_names is not None:
        taxon_ids = {name: i for i, name in enumerate(taxon_names)}
    parsed = [_parse_newick_string(tstr) for tstr in tree_strings]
    if taxon_names is None:
        # Assign by order of appearance in the first tree, as the reference does.
        def visit(node):
            if not node.children:
                if node.label not in taxon_ids:
                    taxon_ids[node.label] = len(taxon_ids)
            for c in node.children:
                visit(c)

        for p in parsed:
            visit(p)
        if sort_taxa:
            taxon_ids = {name: i for i, name in enumerate(sorted(taxon_ids))}
    trees = [_build_tree(p, taxon_ids, allow_new=False) for p in parsed]
    names = [None] * len(taxon_ids)
    for name, i in taxon_ids.items():
        names[i] = name
    return TreeCollection(trees, names)


def parse_nexus_file(path: str, sort_taxa: bool = False) -> TreeCollection:
    """Parse a Nexus tree file with a translate table, as the reference's
    ParseNexusFile does."""
    text = read_text(path)
    if sort_taxa:
        return parse_nexus_text(text, sort_taxa=True)
    return _native_collection(text, is_nexus=True)


def parse_nexus_text(text: str, sort_taxa: bool = False) -> TreeCollection:
    """parse_nexus_file's pure-Python parser, on the file's text."""
    lines = text.split("\n")
    if not lines or not lines[0].strip().upper().startswith("#NEXUS"):
        raise ValueError("Not a nexus file")
    translate: Dict[str, str] = {}
    tree_strings: List[str] = []
    in_translate = False
    for raw in lines:
        ln = raw.strip()
        low = ln.lower()
        if low.startswith("translate"):
            in_translate = True
            ln = ln[len("translate"):].strip()
            low = ln.lower()
            if not ln:
                continue
        if in_translate and ln.startswith("("):
            # Translate table without a terminating ';' followed directly by
            # a bare tree line (e.g. data/hello_out.t).
            in_translate = False
        if in_translate:
            ended = ln.endswith(";")
            body = ln.rstrip(";").rstrip(",")
            for entry in body.split(","):
                entry = entry.strip()
                if not entry:
                    continue
                parts = entry.split(None, 1)
                if len(parts) == 2:
                    translate[parts[0]] = parts[1].strip().strip("'")
            if ended:
                in_translate = False
            continue
        if low.startswith("tree "):
            # Find '=' outside bracket comments (BEAST lines carry
            # [&lnP=...] metadata before the '=').
            depth = 0
            eq = -1
            for idx, c in enumerate(ln):
                if c == "[":
                    depth += 1
                elif c == "]":
                    depth -= 1
                elif c == "=" and depth == 0:
                    eq = idx
                    break
            if eq >= 0:
                tree_strings.append(ln[eq + 1:].strip())
        elif ln.startswith("("):
            # Bare newick line inside the trees block (e.g. data/hello_out.t).
            tree_strings.append(ln)
    if not translate:
        raise ValueError("Nexus file has no translate table")
    # Taxon order: translate-table order (keys are typically 1..N), optionally
    # sorted by name (reference sort_taxa option).
    keys = list(translate.keys())
    names = [translate[k] for k in keys]
    if sort_taxa:
        order = sorted(range(len(names)), key=lambda i: names[i])
        names = [names[i] for i in order]
        keys = [keys[i] for i in order]
    key_to_id = {k: i for i, k in enumerate(keys)}
    taxon_ids = dict(key_to_id)  # trees reference the numeric keys
    trees = []
    for tstr in tree_strings:
        parsed = _parse_newick_string(tstr)
        trees.append(_build_tree(parsed, taxon_ids, allow_new=False))
    return TreeCollection(trees, names)


def read_fasta(path: str) -> Dict[str, str]:
    """Reference Alignment::ReadFasta (src/alignment.cpp): name -> sequence,
    preserving insertion order."""
    seqs: Dict[str, str] = {}
    name = None
    chunks: List[str] = []
    with _open_text(path) as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = "".join(chunks)
                name = line[1:].strip()
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        seqs[name] = "".join(chunks)
    return seqs
