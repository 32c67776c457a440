"""Build and bind the hand-written CUDA kernels of treelike/csrc,
models/csrc and perflab/csrc.

The sources are compiled with nvcc into one shared library with a plain C
interface, at first use, under bito_tpu_torch/_build/ (listed in
.gitignore): one nvcc per source, all started together, then one link.
The library's file name carries a hash of the sources and flags, so an
edit to any source builds a new library.  It is loaded with ctypes: every
pointer, and the stream, is passed as c_void_p and every int as c_int.
Each C entry point returns cudaGetLastError() after its launch, and the
caller raises when that is not 0.

Nothing here runs at import: the CPU tests import every module of the
port, and a machine without nvcc must still be able to import them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent  # the package
_BUILD = _ROOT / "_build"
# Paths relative to the package.  perflab's sources include
# ../../treelike/csrc/common.cuh.
_SOURCES = tuple(f"treelike/csrc/{name}" for name in (
    "paired_ll.cu", "paired_grad.cu", "paired_ll_onchip.cu",
    "paired_grad_onchip.cu", "paired_grad_ckpt.cu", "paired_ll_a64.cu",
    "paired_grad_a64.cu",
    "chunked_ll.cu", "chunked_grad.cu",
    "chunked_grad_onchip.cu", "pernode_ll.cu", "pernode_grad.cu",
    "pernode_grad_onchip.cu")) + (
    "models/csrc/transition_prep.cu",) + tuple(
    f"perflab/csrc/{name}" for name in (
        "variant_grad.cu", "pipe_cell.cu", "stream_sum.cu", "static_chain.cu",
        "chunk_variant.cu"))
_HEADERS = ("treelike/csrc/common.cuh", "treelike/csrc/onchip.cuh",
            "treelike/csrc/pernode_onchip.cuh",
            "treelike/csrc/paired_ll_onchip.cuh",
            "treelike/csrc/paired_lanes.cuh",
            "treelike/csrc/pernode_lanes.cuh",
            "treelike/csrc/paired_a64.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # post_dst, tip_slot, post_e, P, tips, pi, props, buf, ls, ll_rows,
    # B, M, T, N1, C, S, stream
    "bito_paired_ll": [_P] * 10 + [_I] * 6 + [_P],
    # post_dst, tip_slot, post_src, post_e, P, dP, tips, pi, props, weights,
    # buf, ls, ll_rows, grad_rows, B, M, T, N1, C, S, stream
    "bito_paired_grad": [_P] * 14 + [_I] * 6 + [_P],
    # post_dst, child, live_row, post_e, P, tips, pi, props, ll_rows,
    # B, M, T, N1, C, S, rows, cols, ring, stream
    "bito_paired_ll_onchip": [_P] * 9 + [_I] * 9 + [_P],
    # as bito_paired_ll, at 64 states
    "bito_paired_ll_a64": [_P] * 10 + [_I] * 6 + [_P],
    # as bito_paired_grad, at 64 states
    "bito_paired_grad_a64": [_P] * 14 + [_I] * 6 + [_P],
    # patterns a block of the A=64 kernels takes (no arguments)
    "bito_paired_a64_tile": [],
    # post_dst, child, post_src, post_e, P, dP, tips, pi, props, weights,
    # ll_rows, grad_rows, B, M, T, N1, C, S, rows, cols, ring, stream
    "bito_paired_grad_onchip": [_P] * 12 + [_I] * 9 + [_P],
    # sched, P, dP, tips, pi, props, weights, tier, ll_rows, grad_rows,
    # B, L, T, N1, C, S, slots, rows, cols, stream
    "bito_paired_grad_ckpt": [_P] * 10 + [_I] * 9 + [_P],
    # post_dst, tip_slot, child, post_e, P, tips, pi, props, buf, ls,
    # ll_rows, B, MW, W, T, N1, C, S, stream
    "bito_chunked_ll": [_P] * 11 + [_I] * 7 + [_P],
    # post_dst, tip_slot, child, post_e, P, dP, tips, pi, props, weights,
    # buf, ls, ll_rows, grad_rows, B, MW, W, T, N1, C, S, stream
    "bito_chunked_grad": [_P] * 14 + [_I] * 7 + [_P],
    # post_dst, child, post_e, P, dP, tips, pi, props, weights, ll_rows,
    # grad_rows, B, MW, W, T, N1, C, S, rows, cols, op_lanes, stream
    "bito_chunked_grad_onchip": [_P] * 11 + [_I] * 10 + [_P],
    # post_ops, root, P, tips, pi, props, buf, ls, ll_rows,
    # B, M, T, N1, C, S, stream
    "bito_pernode_ll": [_P] * 9 + [_I] * 6 + [_P],
    # post_ops, pre_ops, root, P, dP, tips, pi, props, weights, buf, up, ls,
    # ll_rows, grad_rows, B, M, Mp, T, N1, C, S, stream
    "bito_pernode_grad": [_P] * 14 + [_I] * 7 + [_P],
    # post, groups, zero, root, P, dP, tips, pi, props, weights, ll_rows,
    # grad_rows, B, M, NG, Z, T, N1, C, S, rows, cols, stream
    "bito_pernode_grad_onchip": [_P] * 12 + [_I] * 10 + [_P],
    # post, groups, zero, root, P, dP, tips, pi, props, weights, ll_rows,
    # grad_rows, B, M, Mp, NG, Z, T, N1, C, S, rows, cols, unroll, resk,
    # nodot, stream
    "bito_variant_grad": [_P] * 12 + [_I] * 14 + [_P],
    # post_dst, child, live_row, post_e, P, tips, pi, props, ll_rows,
    # B, M, T, N1, C, S, rows, cols, ring, variant, stream
    "bito_chunk_variant": [_P] * 9 + [_I] * 10 + [_P],
    # bl, U, U_inv, lambda, rates, clock, P, dP, B, N, C, bl_f64, bl's
    # strides (2), U's (3), U_inv's (3), lambda's (2), rates' (2), clock's,
    # stream
    "bito_transition_prep": [_P] * 8 + [_I] * 17 + [_P],
    # idx, big, out, cells, block_rows, scratch_rows, S, init, loops,
    # stores, T, stage_rows, stream
    "bito_pipe_cell": [_P] * 3 + [_I] * 9 + [_P],
    # big, out, cells, nslices, rows, cols, slices, stream
    "bito_stream_sum": [_P] * 2 + [_I] * 5 + [_P],
    # tape, L, out, S, R, dynamic, overlap, warps, stream
    "bito_static_chain": [_P] * 3 + [_I] * 5 + [_P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise FileNotFoundError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_ROOT / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return _BUILD / f"libbito_kernels_{_digest()}.so"


def _run(cmds):
    """Run the commands side by side; raise with the first failure's
    stderr.  Returns their combined stdout and stderr."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [proc.communicate() for proc in procs]  # waits for every one
    for cmd, proc, (_, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{err}")
    return "".join(out + err for out, err in outs)


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists.
    Writes nvcc's messages (ptxas register and spill counts) beside the
    library as <name>.log.  Raises with nvcc's stderr if the build fails."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.parent / f"{so.stem}.{os.getpid()}.tmp"
    tmp.mkdir()
    try:
        objs = [tmp / f"{Path(s).stem}.o" for s in _SOURCES]
        log = _run([[nvcc, *COMPILE_FLAGS, "-o", str(o), str(_ROOT / s)]
                    for s, o in zip(_SOURCES, objs)])
        lib = tmp / so.name
        log += _run([[nvcc, *LINK_FLAGS, "-o", str(lib), *map(str, objs)]])
        so.with_suffix(".log").write_text(log)
        os.replace(lib, so)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
