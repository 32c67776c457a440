"""ctypes bindings for the native bitocore library (bitocore.cpp).

Port of bito_tpu._native: bitocore.cpp is a byte-for-byte copy of
bito_tpu's, and its three parts are bound here as they are there: the
Newick/Nexus parser (parse_trees), the unrooted rootsplit and PCSP
counters (unrooted_counters) and the PCSP indexer that builds a whole tree
set's indexer representations in one call (PCSPIndexer).

Build rules, where they differ from bito_tpu's:
  - g++ (`-O3 -shared -fPIC -std=c++17`, bito_tpu's flags) compiles the
    source at first use into bito_tpu_torch/_build/ (listed in
    .gitignore), never beside the source.  The library's file name carries
    a digest of the source, the flags and the compiler, so an edit builds
    anew.  Nothing is built at import.
  - Concurrent builders (test workers, say) take a file lock in the build
    directory; each compiles to a file of its own and renames it into
    place atomically, so a loader sees the whole library or none.
  - A failed build raises, with g++'s stderr in the message.  bito_tpu
    returns None instead and every consumer falls back to the pure-Python
    code without a word; here the pure-Python code runs only where the
    caller calls it itself (parse_newick_text, parse_nexus_text,
    sbn.maps), as an instance made with `native=False` does
    (api.instances).
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "bitocore.cpp"
BUILD = _HERE.parent / "_build"
CXX = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _compiler(cxx) -> str:
    cxx = cxx or CXX
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"the native library cannot be built: compiler "
                           f"{cxx!r} not found")
    return path


def library_path(build_dir=None, cxx=None) -> Path:
    """Where the library of the current source, flags and compiler lives."""
    h = hashlib.sha256(" ".join((cxx or CXX,) + FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return Path(build_dir or BUILD) / f"libbitocore_{h.hexdigest()[:16]}.so"


def build(build_dir=None, cxx=None) -> Path:
    """Compile bitocore.cpp unless a library of it exists in `build_dir`
    (default bito_tpu_torch/_build).  Raises RuntimeError with the
    compiler's stderr if the build fails."""
    so = library_path(build_dir, cxx)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / "libbitocore.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if so.exists():  # another process built it while we waited
            return so
        tmp = so.parent / f"{so.stem}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run(
                [_compiler(cxx), *FLAGS, str(SOURCE), "-o", str(tmp)],
                capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"the native library failed to build ({proc.returncode}):"
                    f" {' '.join(proc.args)}\n{proc.stderr}")
            os.replace(tmp, so)  # atomic: a loader sees all or nothing
        finally:
            tmp.unlink(missing_ok=True)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures (bito_tpu/_native/__init__.py's)."""
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    signatures = {  # name -> (restype, argtypes)
        "bc_parse": (P, [ctypes.c_char_p, I]),
        "bc_error": (ctypes.c_char_p, [P]),
        "bc_num_trees": (I, [P]),
        "bc_num_taxa": (I, [P]),
        "bc_taxon_name": (ctypes.c_char_p, [P, I]),
        "bc_tree_size": (I, [P, I]),
        "bc_tree_data": (None, [P, I, i32p, ctypes.POINTER(ctypes.c_double)]),
        "bc_free": (None, [P]),
        "bc_unrooted_counters": (P, [i32p, i32p, i64p, I, I]),
        "bc_counter_error": (ctypes.c_char_p, [P]),
        "bc_counter_rootsplit_count": (I, [P]),
        "bc_counter_pcsp_count": (I, [P]),
        "bc_counter_data": (None, [P, u64p, i64p, u64p, i64p]),
        "bc_counter_free": (None, [P]),
        "bc_pcsp_indexer": (P, [u64p, i64p, I, I]),
        "bc_pcsp_indexer_free": (None, [P]),
        "bc_indexer_error": (ctypes.c_char_p, [P]),
        "bc_unrooted_representations": (I, [P, i32p, i32p, I, I, I64, i64p]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use.  Raises if it cannot be
    built or loaded."""
    return _bind(ctypes.CDLL(str(build())))


def _ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def parse_trees(text: str, is_nexus: bool):
    """(taxon_names, [(parents int32, branch lengths float64)]) of every
    tree in a Newick or Nexus text.  Raises ValueError on a parse error."""
    lib = get_lib()
    h = lib.bc_parse(text.encode("utf-8"), 1 if is_nexus else 0)
    try:
        err = lib.bc_error(h)
        if err:
            raise ValueError(err.decode())
        taxa = [lib.bc_taxon_name(h, i).decode()
                for i in range(lib.bc_num_taxa(h))]
        trees = []
        for t in range(lib.bc_num_trees(h)):
            n = lib.bc_tree_size(h, t)
            parents = np.empty(n, dtype=np.int32)
            lengths = np.empty(n, dtype=np.float64)
            lib.bc_tree_data(h, t, _ptr(parents, ctypes.c_int32),
                             _ptr(lengths, ctypes.c_double))
            trees.append((parents, lengths))
        return taxa, trees
    finally:
        lib.bc_free(h)


def _blocks_to_int(blocks: np.ndarray) -> int:
    out = 0
    for i, b in enumerate(blocks):
        out |= int(b) << (64 * i)
    return out


def _int_to_blocks(v: int, nb: int, out: np.ndarray):
    mask = (1 << 64) - 1
    for j in range(nb):
        out[j] = (v >> (64 * j)) & mask


def unrooted_counters(parent_arrays: List[np.ndarray],
                      topo_counts: List[int], n_taxa: int):
    """(rootsplit counter, PCSP counter) with integer-bitset keys:
    rootsplits as (clade0, clade1), PCSPs as (sister, focal, child)."""
    lib = get_lib()
    parents = np.concatenate(parent_arrays).astype(np.int32)
    sizes = np.asarray([len(p) for p in parent_arrays], dtype=np.int32)
    counts = np.asarray(topo_counts, dtype=np.int64)
    h = lib.bc_unrooted_counters(
        _ptr(parents, ctypes.c_int32), _ptr(sizes, ctypes.c_int32),
        _ptr(counts, ctypes.c_int64), len(parent_arrays), n_taxa)
    try:
        err = lib.bc_counter_error(h)
        if err:
            raise ValueError(err.decode())
        nb = (n_taxa + 63) // 64
        n_rs = lib.bc_counter_rootsplit_count(h)
        n_pcsp = lib.bc_counter_pcsp_count(h)
        rs_blocks = np.empty((n_rs, 2 * nb), dtype=np.uint64)
        rs_counts = np.empty(n_rs, dtype=np.int64)
        pcsp_blocks = np.empty((n_pcsp, 3 * nb), dtype=np.uint64)
        pcsp_counts = np.empty(n_pcsp, dtype=np.int64)
        lib.bc_counter_data(
            h, _ptr(rs_blocks, ctypes.c_uint64), _ptr(rs_counts, ctypes.c_int64),
            _ptr(pcsp_blocks, ctypes.c_uint64),
            _ptr(pcsp_counts, ctypes.c_int64))
        rs = {tuple(_blocks_to_int(row[k * nb:(k + 1) * nb])
                    for k in range(2)): int(c)
              for row, c in zip(rs_blocks, rs_counts)}
        pcsp = {tuple(_blocks_to_int(row[k * nb:(k + 1) * nb])
                      for k in range(3)): int(c)
                for row, c in zip(pcsp_blocks, pcsp_counts)}
        return rs, pcsp
    finally:
        lib.bc_counter_free(h)


class PCSPIndexer:
    """Native PCSP-string -> index map for building indexer
    representations (the reference's SBNSupport indexer_,
    src/sbn_support.hpp:4-60)."""

    def __init__(self, indexer: Dict[str, int], n_taxa: int):
        from ..core.bitset import bits_of_string

        lib = get_lib()
        self._lib = lib
        self.n_taxa = n_taxa
        self.nb = (n_taxa + 63) // 64
        count = len(indexer)
        blocks = np.zeros((count, 3 * self.nb), dtype=np.uint64)
        indices = np.empty(count, dtype=np.int64)
        for i, (key, idx) in enumerate(indexer.items()):
            for part in range(3):
                v = bits_of_string(key[part * n_taxa:(part + 1) * n_taxa])
                _int_to_blocks(v, self.nb,
                               blocks[i, part * self.nb:(part + 1) * self.nb])
            indices[i] = idx
        self._h = lib.bc_pcsp_indexer(_ptr(blocks, ctypes.c_uint64),
                                      _ptr(indices, ctypes.c_int64), count,
                                      self.nb)

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.bc_pcsp_indexer_free(h)

    def unrooted_representations(self, parent_arrays: List[np.ndarray],
                                 default_index: int) -> List[List[List[int]]]:
        """Per tree, one row per virtual rooting: [rootsplit index, sorted
        PCSP indices...], exactly sbn.maps.unrooted_representation's
        output, `default_index` for what lies outside the support."""
        sizes = np.asarray([len(p) for p in parent_arrays], dtype=np.int32)
        if not (sizes == sizes[0]).all():
            raise ValueError("the trees must share the taxon set")
        N = int(sizes[0])
        row_len = 1 + (N - self.n_taxa)
        rows_per_tree = N - 1
        parents = np.ascontiguousarray(np.concatenate(parent_arrays),
                                       dtype=np.int32)
        out = np.empty((len(parent_arrays) * rows_per_tree, row_len),
                       dtype=np.int64)
        rc = self._lib.bc_unrooted_representations(
            self._h, _ptr(parents, ctypes.c_int32),
            _ptr(sizes, ctypes.c_int32), len(parent_arrays), self.n_taxa,
            default_index, _ptr(out, ctypes.c_int64))
        if rc != 0:
            err = self._lib.bc_indexer_error(self._h)
            raise ValueError(err.decode() if err else
                             "native representations failed")
        return [block.tolist()
                for block in out.reshape(len(parent_arrays), rows_per_tree,
                                         row_len)]
