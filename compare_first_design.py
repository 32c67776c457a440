"""The pipe cell and the static chain in their first design, built from the
sources of another checkout, timed beside the current kernels in one
process, the same way: operands and outputs allocated once, each kernel's
launches captured in a CUDA graph and its replays timed with CUDA events
(perflab.graph_ms), in turns first, current, current, first.  The chain is
timed at every layout of the current kernel (1, 2 and 4 warps a column).

The first design kept each pipe cell's scratch in device memory (the
caller allocates it) and gave a static-chain column one warp.  Its C entry
points, which this script checks in the other checkout's sources before it
loads them (it refuses any other signature):
    int bito_pipe_cell(const int* idx, const void* big, float* scratch,
                       float* out, int cells, int block_rows,
                       int scratch_rows, int S, int init, int loops,
                       int stores, void* stream)
    int bito_static_chain(const int* tape, const float* L, float* out,
                          int S, int R, int dynamic, void* stream)

Last, it prints the SASS instructions of one chained op of every
static_chain kernel of both libraries (perf_static_probe.sass_per_op).

    python3 compare_first_design.py CHECKOUT [reps]

CHECKOUT is the root of the other checkout, or a directory holding its
bito_tpu_torch/perflab/csrc/pipe_cell.cu and static_chain.cu (`git
archive <commit> bito_tpu_torch/perflab/csrc | tar -x -C CHECKOUT`);
nothing of it is imported.  Needs a card and nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import re
import subprocess
import sys
from pathlib import Path

import torch

from bito_tpu_torch.perflab import (GRAPH_TIMING, card_line, graph_ms,
                                    max_sm_clock_mhz, require_card)
from bito_tpu_torch.perflab import perf_pipe_lab as pipe
from bito_tpu_torch.perflab import perf_static_probe as chain
from bito_tpu_torch.treelike import _kernels

_P, _I = ctypes.c_void_p, ctypes.c_int
# The first design's parameter types, in order, and their ctypes.
SIGNATURES = {
    "pipe_cell.cu": ("bito_pipe_cell", ["const int*", "const void*", "float*",
                                        "float*"] + ["int"] * 7 + ["void*"]),
    "static_chain.cu": ("bito_static_chain", ["const int*", "const float*",
                                              "float*"] + ["int"] * 3
                        + ["void*"]),
}


def parameter_types(source: str, name: str) -> list:
    """The parameter types of `extern "C" int name(...)` in `source`, each
    without its name and with single spaces."""
    match = re.search(r'extern\s+"C"\s+int\s+' + name + r"\s*\(([^)]*)\)",
                      source)
    if match is None:
        raise ValueError(f"no extern \"C\" int {name}(...) in the source")
    types = []
    for param in match.group(1).split(","):
        words = " ".join(param.split())
        types.append(re.sub(r"\s*\w+$", "", words).replace(" *", "*"))
    return types


def build_first(root: Path) -> Path:
    """The first design's two kernels in one library under _build/, named
    by their sources' hash, after checking their entry points' signatures;
    nvcc's ptxas lines beside it (.log)."""
    srcs = []
    for file, (name, want) in SIGNATURES.items():
        path = root / "bito_tpu_torch/perflab/csrc" / file
        got = parameter_types(path.read_text(), name)
        if got != want:
            raise ValueError(f"{path}: {name} takes ({', '.join(got)}), not "
                             f"the first design's ({', '.join(want)})")
        srcs.append(path)
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in srcs))
    so = _kernels._BUILD / f"libfirst_design_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(
            [_kernels._nvcc(), *_kernels.ARCH_FLAGS, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o",
             str(so), *map(str, srcs)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed: {proc.stderr}")
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return so


def load_first(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for name, types in SIGNATURES.values():
        fn = getattr(lib, name)
        fn.argtypes = [_I if t == "int" else _P for t in types]
        fn.restype = ctypes.c_int
    return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def in_turns(first, current, reps: int):
    """(first ms, current ms): graph_ms of each, first, current, current,
    first, each side's mean of its two."""
    f1, c1 = graph_ms(first, reps), graph_ms(current, reps)
    c2, f2 = graph_ms(current, reps), graph_ms(first, reps)
    return (f1 + f2) / 2, (c1 + c2) / 2


def compare_pipe(lib, dev, reps: int, cells: int = pipe.CELLS) -> dict:
    """Every experiment: {name: (first us/cell, current us/cell, device
    memory bound us/cell, shared-memory bound us/cell)}; the filled
    experiments' outputs must agree exactly."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = max_sm_clock_mhz()
    rows = {}
    for name, exp in pipe.EXPS.items():
        block_rows, scratch_rows, init, loops, stores = exp
        kw = dict(scratch_rows=scratch_rows, init=init, loops=loops,
                  stores=stores)
        idx, big = pipe.pipe_inputs(block_rows, scratch_rows, cells, dev)
        want = pipe.pipe_cell(idx, big, **kw)  # checks the operands
        plan = pipe.pipe_plan(block_rows, scratch_rows)
        scratch = torch.empty((cells, scratch_rows, pipe.S),
                              dtype=torch.float32, device=dev)
        out_first, out_cur = torch.empty_like(want), torch.empty_like(want)

        def first():
            rc = lib.bito_pipe_cell(
                idx.data_ptr(), big.data_ptr(), scratch.data_ptr(),
                out_first.data_ptr(), cells, block_rows, scratch_rows,
                pipe.S, int(init), loops, stores, _stream())
            _kernels.check(rc, "first-design bito_pipe_cell")

        def current():
            pipe.launch_pipe_cell(idx, big, out_cur, plan, **kw)

        f_ms, c_ms = in_turns(first, current, reps)
        if init:
            torch.cuda.synchronize()
            if not (torch.equal(out_first, want) and torch.equal(out_cur,
                                                                 want)):
                raise RuntimeError(f"pipe {name}: the designs disagree")
        hbm, smem = pipe.pipe_bound_ms(*exp, cells=cells, sms=sms,
                                       clock_mhz=clock)
        rows[name] = tuple(x * 1e3 / cells for x in (f_ms, c_ms, hbm, smem))
        print(f"pipe {name:28s} first {rows[name][0]:8.4f} current "
              f"{rows[name][1]:8.4f} us/cell (T={plan.tile}); bound: device "
              f"memory {rows[name][2]:.4f}, shared memory {rows[name][3]:.4f}",
              flush=True)
        del scratch, big
        torch.cuda.empty_cache()
    return rows


def compare_chain(lib, dev, reps: int) -> dict:
    """Both variants at R_LO and R_HI, the first design in turns with each
    layout of the current kernel: {(dynamic, design): (lo ms, hi ms, us
    per op)}, design "first" or the current kernel's warps a column (the
    first design's times are the mean of its turns).  Outputs are held
    within 1e-5 of max |out| against the plain version at R_LO."""
    tape, L = chain.probe_inputs(dev)
    overlap = chain.check_chain(tape, L)
    out_first = torch.empty((8, chain.S), dtype=torch.float32, device=dev)
    out_cur = torch.empty_like(out_first)
    rows = {}
    for dynamic in (True, False):
        want = chain.static_chain_ref(tape, L, dynamic=dynamic, R=chain.R_LO)
        ms = {}   # design -> {R: [ms, ...]}
        for warps in chain.LAYOUTS:
            for R in (chain.R_LO, chain.R_HI):
                def first(R=R):
                    rc = lib.bito_static_chain(
                        tape.data_ptr(), L.data_ptr(), out_first.data_ptr(),
                        chain.S, R, int(dynamic), _stream())
                    _kernels.check(rc, "first-design bito_static_chain")

                def current(R=R, warps=warps):
                    chain.launch_chain(tape, L, out_cur, dynamic, R, overlap,
                                       warps)
                f_ms, c_ms = in_turns(first, current, reps)
                ms.setdefault("first", {}).setdefault(R, []).append(f_ms)
                ms.setdefault(warps, {})[R] = [c_ms]
                if R == chain.R_LO:
                    torch.cuda.synchronize()
                    for out in (out_first, out_cur):
                        err = ((out - want).abs().max()
                               / want.abs().max()).item()
                        if not err <= 1e-5:
                            raise RuntimeError(
                                f"chain dynamic={dynamic} warps={warps}: "
                                f"error {err}")
        for design, by_r in ms.items():
            lo, hi = (sum(by_r[R]) / len(by_r[R])
                      for R in (chain.R_LO, chain.R_HI))
            per_op = (hi - lo) / ((chain.R_HI - chain.R_LO) * chain.M) * 1e3
            rows[(dynamic, design)] = (lo, hi, per_op)
            label = design if design == "first" else f"{design} warps"
            print(f"chain dynamic={dynamic} {label:7s} R{chain.R_LO} "
                  f"{lo:.4f} ms, R{chain.R_HI} {hi:.4f} ms, slope "
                  f"{per_op:.4f} us/op", flush=True)
    return rows


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit(__doc__)
    root = Path(argv[0]).resolve()
    reps = int(argv[1]) if len(argv) > 1 else pipe.REPS
    dev = require_card()
    print(card_line(), flush=True)
    print(f"# timing: {GRAPH_TIMING}; {reps} launches a graph", flush=True)
    so = build_first(root)
    lib = load_first(so)
    _kernels.library()
    compare_pipe(lib, dev, reps)
    compare_chain(lib, dev, max(2, reps // 8))
    for label, path in (("first", so), ("current", _kernels.library_path())):
        for name, counts in chain.sass_per_op(path).items():
            print(f"sass {label} {name}: " + ", ".join(
                f"{k} {v:.1f}" for k, v in sorted(counts.items())),
                flush=True)


if __name__ == "__main__":
    main()
