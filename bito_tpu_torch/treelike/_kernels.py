"""Build and bind the hand-written CUDA kernels of treelike/csrc.

The sources are compiled with nvcc into one shared library with a plain C
interface, at first use, under bito_tpu_torch/_build/ (listed in
.gitignore).  The library's file name carries a hash of the sources and
flags, so an edit to any source builds a new library.  It is loaded with
ctypes: every pointer, and the stream, is passed as c_void_p and every
int as c_int.  Each C entry point returns cudaGetLastError() after its
launch, and the caller raises when that is not 0.

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

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_SOURCES = ("paired_ll.cu", "paired_grad.cu")
_HEADERS = ("paired_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # post_dst, tip_slot, post_e, P, tips, pi, props, buf, ls, ll_rows,
    # B, M, T, N1, C, S, stream
    "bito_paired_ll": [_P] * 10 + [_I] * 6 + [_P],
    # post_dst, tip_slot, post_src, post_e, P, dP, tips, pi, props, weights,
    # buf, ls, ll_rows, grad_rows, B, M, T, N1, C, S, stream
    "bito_paired_grad": [_P] * 14 + [_I] * 6 + [_P],
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return _BUILD / f"libbito_paired_{_digest()}.so"


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists.
    Writes nvcc's messages (ptxas register and spill counts) beside the
    library as <name>.log.  Raises with nvcc's stderr if the build fails."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(_CSRC / s) for s in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
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
