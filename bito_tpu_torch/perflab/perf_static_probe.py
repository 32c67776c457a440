"""Probe of one op of a dependent chain: offsets read from a tape at run
time against offsets fixed at compile time.

Counterpart of scripts/perf_static_probe.py.  Its kernel is
csrc/static_chain.cu: R repetitions of an M = 52-op chain over a scratch
[(2 M + 3) * 16, 1024] f32 (7.0 MB) filled with ones; op m reads the 32
rows at 16 * src, adds t, contracts them, stacked three times, with L
[32, 96], stores ev[0:16] * ev[16:32] at 16 * dst and halves t.  The
output is the 8 rows at 16 * 2 M, plus t.  `dynamic` takes (src, dst) from
the tape [2, 52] int32; otherwise they are compile-time constants of a
fully unrolled chain.  The tape holds those same offsets (2 m, 2 m + 2),
so both give the same output.

On the card W warps take a column (W in LAYOUTS; static_chain launches
WARPS): thread (p, q) sums the terms of 16 / W of the source rows for
ev[p] and ev[p + 16] (`thread_outputs`), and the 2 W parts meet by xor
shuffles (`emulate_chain` repeats that sum order in float32 on the
host).

The per-op cost is the slope between R = 20 and R = 120 (launch and fill
cancel), as the script measures it (perf_static_probe.py:107-129), each
time read from the device (`graph_ms`: a CUDA graph of the launches).
Beside each slope stands the FMA floor of the launch geometry: 1,024
columns, COLS_PER_BLOCK to a block whatever W, so the busiest SM holds 8
of them (8 W warps); an op is 3,072 FMAs per column, and an SM retires at
most 128 FP32 FMAs a cycle at its maximum clock.  On the TPU every variant measured below its
floor, which made the probe inconclusive there (perf_static_probe.py:6-17):
a slope under its floor says the chain was collapsed, not how fast an op
is.

    python -m bito_tpu_torch.perflab static [sass]

`sass` prints instead the SASS instructions of one chained op of every
kernel of the chain (cuobjdump -sass of the built library): FFMA against
the rest, by class, for a warp.
"""
from __future__ import annotations

import collections
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import (GRAPH_TIMING, card_line, count_launch, graph_ms,
               max_sm_clock_mhz, require_card)
from ..device import PRODUCT_DEVICE
from ..treelike import _kernels

CA = 16
S = 1024
M = 52
NS = 2 * M + 3
COLS_PER_BLOCK = 2              # csrc/static_chain.cu's kColsPerBlock
LAYOUTS = (1, 2, 4)             # warps a column, the kernel's template
# The layout static_chain launches: the one with the lower slope in both
# variants on the H100 (chip_smoke.py phase 3 times every layout).
WARPS = 1
FMAS_PER_OP = (2 * CA) * (6 * CA)   # per column: [32, 96] @ [96]
LANES_PER_SM = 128              # FP32 FMA lanes of a Hopper SM
R_LO, R_HI = 20, 120


def probe_inputs(device=PRODUCT_DEVICE):
    """(tape [2, M] int32, L [1, 32, 96] f32), as the script builds them
    (perf_static_probe.py:82-87)."""
    tape = np.zeros((2, M), np.int32)
    tape[0] = 2 * np.arange(M)
    tape[1] = 2 * (np.arange(M) + 1)
    L = np.random.default_rng(0).normal(
        0, 0.05, (1, 2 * CA, 6 * CA)).astype(np.float32)
    return (torch.as_tensor(tape, device=device),
            torch.as_tensor(L, device=device))


def static_chain_ref(tape, L, *, dynamic: bool, R: int) -> torch.Tensor:
    """Plain torch version of the chain: out [8, S] f32."""
    buf = torch.ones((NS * CA, S), dtype=torch.float32, device=L.device)
    offs = tape.tolist()
    t = np.float32(1e-8)
    for _ in range(R):
        for m in range(M):
            src, dst = ((offs[0][m] * CA, offs[1][m] * CA) if dynamic
                        else (2 * m * CA, 2 * (m + 1) * CA))
            rows = buf[src:src + 2 * CA] + float(t)
            ev = L[0] @ torch.cat([rows, rows, rows])
            buf[dst:dst + CA] = ev[:CA] * ev[CA:]
            t = t * np.float32(0.5)
    return buf[2 * M * CA:2 * M * CA + 8] + float(t)


def thread_outputs(warps: int = WARPS) -> np.ndarray:
    """[32 W threads of a column, 2]: the outputs each thread sums
    (csrc/static_chain.cu).  Thread u has part q = u % Q of the Q = 2 W
    parts, the 16 / W source rows from 16 / W * q, and p = 16 / W *
    (u // 32) + (u % 32) // Q: it holds ev[p] and ev[p + 16], which meet
    in it."""
    u = np.arange(32 * warps)
    p = CA // warps * (u // 32) + (u % 32) // (2 * warps)
    return np.stack([p, p + CA], axis=1)


def _fma32(a, b, c):
    """float32 fused multiply-add: the product is exact in float64, and the
    one rounding of the sum to float64 differs from the card's only in
    ties far below the tolerance."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate_chain(tape, L, *, dynamic: bool, R: int,
                  warps: int = WARPS) -> np.ndarray:
    """The kernel's sum order at W = `warps`, in float32 on the host, over
    all columns at once: for part q of Q = 2 W, one accumulator per
    stacked copy c over its 16 / W rows, then (acc0 + acc1) + acc2; then
    the xor shuffles, which add the parts pairwise ((a0 + a1) + (a2 + a3)
    ... in the thread that stores); then ev[o] * ev[o + 16]: out [8, S]."""
    Lm = L[0].cpu().numpy()
    offs = tape.cpu().numpy()
    own = CA // warps
    buf = np.ones((NS * CA, S), np.float32)
    t = np.float32(1e-8)
    for _ in range(R):
        for m in range(M):
            src, dst = ((offs[0, m] * CA, offs[1, m] * CA) if dynamic
                        else (2 * m * CA, 2 * (m + 1) * CA))
            x = buf[src:src + 2 * CA] + t                       # [32, S]
            part = []                                 # [32 outputs, S] a q
            for q in range(2 * warps):
                acc = [np.zeros((2 * CA, S), np.float32) for _ in range(3)]
                for row in range(own * q, own * (q + 1)):
                    for c in range(3):
                        acc[c] = _fma32(Lm[:, 2 * CA * c + row, None],
                                        x[row], acc[c])
                part.append((acc[0] + acc[1]) + acc[2])
            while len(part) > 1:
                part = [part[k] + part[k + 1] for k in range(0, len(part), 2)]
            ev = part[0]
            buf[dst:dst + CA] = ev[:CA] * ev[CA:]
            t = t * np.float32(0.5)
    return buf[2 * M * CA:2 * M * CA + 8] + t


def check_chain(tape, L) -> bool:
    """Raise on operands the kernel does not take; return whether some op's
    destination rows meet its source rows (dst in {src, src + 1}), where
    the kernel needs a barrier before each store."""
    if tuple(tape.shape) != (2, M) or tape.dtype != torch.int32:
        raise TypeError(f"tape must be int32 {(2, M)}, got {tape.dtype} "
                        f"{tuple(tape.shape)}")
    if tuple(L.shape) != (1, 2 * CA, 6 * CA) or L.dtype != torch.float32:
        raise TypeError(f"L must be float32 {(1, 2 * CA, 6 * CA)}, got "
                        f"{L.dtype} {tuple(L.shape)}")
    for name, t in (("tape", tape), ("L", L)):
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    host = tape.cpu().numpy()
    lo, hi = int(host.min()), int(host.max())
    if lo < 0 or hi > 2 * M + 1:
        raise ValueError(f"tape entries in [{lo}, {hi}] leave the scratch")
    return tape_overlaps(host)


def tape_overlaps(tape) -> bool:
    """Whether some op of the tape [2, M] writes rows it reads: its 16
    destination rows 16 dst.. meet its 32 source rows 16 src.. exactly
    where dst is src or src + 1."""
    src, dst = np.asarray(tape)
    return bool(((dst == src) | (dst == src + 1)).any())


def launch_chain(tape, L, out, dynamic: bool, R: int, overlap: bool,
                 warps: int = WARPS) -> None:
    """One launch into `out` [8, S] f32 of operands that check_chain
    passed, with its `overlap`, at `warps` a column; no allocation and no
    host sync, so a CUDA graph can capture it."""
    if warps not in LAYOUTS:
        raise ValueError(f"the kernel takes {LAYOUTS} warps a column, got "
                         f"{warps}")
    with torch.cuda.device(L.device):
        rc = _kernels.library().bito_static_chain(
            tape.data_ptr(), L.data_ptr(), out.data_ptr(), S, R,
            int(dynamic), int(overlap), warps,
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "bito_static_chain")
    count_launch(static_chain)


def static_chain(tape, L, *, dynamic: bool, R: int,
                 warps: int = WARPS) -> torch.Tensor:
    """R repetitions of the chain in one launch, `warps` a column on the
    card: out [8, S]."""
    if L.device.type == "cpu":
        return static_chain_ref(tape, L, dynamic=dynamic, R=R)
    overlap = check_chain(tape, L)
    out = torch.empty((8, S), dtype=torch.float32, device=L.device)
    launch_chain(tape, L, out, dynamic, R, overlap, warps)
    return out


static_chain.launches = 0


def fma_floor_us(sms: int, clock_mhz: float) -> float:
    """The least time of one op (all 1,024 columns) at this launch
    geometry: the busiest SM's columns x 3,072 FMAs over 128 lanes a
    cycle."""
    blocks = math.ceil(S / COLS_PER_BLOCK)
    busiest = math.ceil(blocks / sms) * COLS_PER_BLOCK
    return busiest * FMAS_PER_OP / LANES_PER_SM / clock_mhz


def busiest_warps(sms: int, warps: int = WARPS) -> int:
    """Warps on the busiest SM: its columns x the warps of a column."""
    blocks = math.ceil(S / COLS_PER_BLOCK)
    return math.ceil(blocks / sms) * COLS_PER_BLOCK * warps


def timed(tape, L, dynamic: bool, R: int, reps: int = 5,
          warps: int = WARPS) -> float:
    """Device ms of one launch at R repetitions (graph_ms), its operands
    checked and its output allocated once, outside the timed launches."""
    overlap = check_chain(tape, L)
    out = torch.empty((8, S), dtype=torch.float32, device=L.device)
    return graph_ms(lambda: launch_chain(tape, L, out, dynamic, R, overlap,
                                         warps), reps, static_chain)


def slopes(tape, L, reps: int = 5, layouts=LAYOUTS) -> list:
    """The per-op slope of both variants between R_LO and R_HI at every
    layout, each beside the FMA floor; prints one JSON line each, as the
    script does."""
    sms = torch.cuda.get_device_properties(L.device).multi_processor_count
    floor = fma_floor_us(sms, max_sm_clock_mhz())
    rows = []
    for warps in layouts:
        for dynamic in (True, False):
            t_lo = timed(tape, L, dynamic, R_LO, reps, warps)
            t_hi = timed(tape, L, dynamic, R_HI, reps, warps)
            per_op = (t_hi - t_lo) / ((R_HI - R_LO) * M) * 1e3
            row = {"warps": warps, "dynamic": dynamic, f"R{R_LO}_ms": t_lo,
                   f"R{R_HI}_ms": t_hi, "us_per_op_slope": per_op,
                   "fma_floor_us_per_op": floor,
                   "below_floor": per_op < floor,
                   "busiest_sm_warps": busiest_warps(sms, warps),
                   "timing": GRAPH_TIMING}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


SASS_CLASSES = ("FFMA", "FADD", "FMUL", "LDS", "STS", "SHFL", "BAR")
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9_]*)[^;]*?(?:0x([0-9a-f]+))?\s*;")


def sass_per_op(so) -> dict:
    """{kernel symbol: {instruction class: count per chained op and warp}}
    for every static_chain kernel in the library `so` (cuobjdump -sass,
    beside nvcc): the innermost loop (a backward branch) that holds FFMAs,
    divided by the ops one pass of it runs (52 where the chain is
    unrolled, DYNAMIC false, else 1)."""
    text = subprocess.run(
        [str(Path(_kernels._nvcc()).parent / "cuobjdump"), "-sass", str(so)],
        capture_output=True, text=True, check=True).stdout
    result = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.split("\n", 1)[0].strip()
        if "static_chain_kernel" not in name:
            continue
        instrs = [(int(m.group(1), 16), m.group(2),
                   int(m.group(3), 16) if m.group(3) else None)
                  for m in _SASS_LINE.finditer(block)]
        loops = [(tgt, addr) for addr, op, tgt in instrs
                 if op == "BRA" and tgt is not None and tgt <= addr]
        body = next((ops for ops in (
            [op for addr, op, _ in instrs if lo <= addr <= hi]
            for lo, hi in sorted(loops, key=lambda r: r[1] - r[0]))
            if "FFMA" in ops), None)
        if body is None:
            continue
        counts = collections.Counter(
            op if op in SASS_CLASSES else "other" for op in body)
        ops = 1 if "ILb1E" in name else M   # DYNAMIC: a loop an op
        result[name] = {k: v / ops for k, v in counts.items()}
        result[name]["total"] = len(body) / ops
    return result


def main(argv=None) -> list:
    argv = list(argv or [])
    if argv not in ([], ["sass"]):
        raise ValueError(f"the static probe takes no names but sass, got "
                         f"{argv}")
    device = require_card()
    print(card_line(), flush=True)
    if argv:
        counts = sass_per_op(_kernels.build())
        for name, per_op in counts.items():
            print(f"sass {name}: " + ", ".join(
                f"{k} {v:.1f}" for k, v in sorted(per_op.items())),
                flush=True)
        return [counts]
    tape, L = probe_inputs(device)
    return slopes(tape, L)


if __name__ == "__main__":
    main(sys.argv[1:])
