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

The per-op cost is the slope between R = 20 and R = 120 (launch and fill
cancel), as the script measures it (perf_static_probe.py:107-129).  Beside
each slope stands the FMA floor of the launch geometry: 1,024 columns, one
warp each, 4 to a block, so 256 blocks over the card's SMs; an op is 3,072
FMAs per column, and an SM retires at most 128 FP32 FMAs a cycle at its
maximum clock.  On the TPU every variant measured below its floor, which
made the probe inconclusive there (perf_static_probe.py:6-17): a slope
under its floor says the chain was collapsed, not how fast an op is.

    python -m bito_tpu_torch.perflab static
"""
from __future__ import annotations

import json
import math
import sys

import numpy as np
import torch

from . import card_line, cuda_ms, max_sm_clock_mhz, require_card
from ..device import PRODUCT_DEVICE
from ..treelike import _kernels

CA = 16
S = 1024
M = 52
NS = 2 * M + 3
COLS_PER_BLOCK = 4              # csrc/static_chain.cu's kColsPerBlock
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


def _check_chain(tape, L) -> None:
    if tuple(tape.shape) != (2, M) or tape.dtype != torch.int32:
        raise TypeError(f"tape must be int32 {(2, M)}, got {tape.dtype} "
                        f"{tuple(tape.shape)}")
    if tuple(L.shape) != (1, 2 * CA, 6 * CA) or L.dtype != torch.float32:
        raise TypeError(f"L must be float32 {(1, 2 * CA, 6 * CA)}, got "
                        f"{L.dtype} {tuple(L.shape)}")
    for name, t in (("tape", tape), ("L", L)):
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    lo, hi = int(tape.min()), int(tape.max())
    if lo < 0 or hi > 2 * M + 1:
        raise ValueError(f"tape entries in [{lo}, {hi}] leave the scratch")


def _launch_chain(tape, L, dynamic, R):
    out = torch.empty((8, S), dtype=torch.float32, device=L.device)
    with torch.cuda.device(L.device):
        rc = _kernels.library().bito_static_chain(
            tape.data_ptr(), L.data_ptr(), out.data_ptr(), S, R,
            int(dynamic), torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "bito_static_chain")
    static_chain.launches += 1
    return out


def static_chain(tape, L, *, dynamic: bool, R: int) -> torch.Tensor:
    """R repetitions of the chain in one launch: out [8, S]."""
    if L.device.type == "cpu":
        return static_chain_ref(tape, L, dynamic=dynamic, R=R)
    _check_chain(tape, L)
    return _launch_chain(tape, L, dynamic, R)


static_chain.launches = 0


def fma_floor_us(sms: int, clock_mhz: float) -> float:
    """The least time of one op (all 1,024 columns) at this launch
    geometry: the busiest SM's columns x 3,072 FMAs over 128 lanes a
    cycle."""
    blocks = math.ceil(S / COLS_PER_BLOCK)
    busiest = math.ceil(blocks / sms) * COLS_PER_BLOCK
    return busiest * FMAS_PER_OP / LANES_PER_SM / clock_mhz


def timed(tape, L, dynamic: bool, R: int, reps: int = 5) -> float:
    """CUDA-event mean ms of one launch at R repetitions."""
    static_chain(tape, L, dynamic=dynamic, R=R)  # checks the operands once
    return cuda_ms(lambda: _launch_chain(tape, L, dynamic, R), reps)


def slopes(tape, L, reps: int = 5) -> list:
    """The per-op slope of both variants between R_LO and R_HI, each beside
    the FMA floor; prints one JSON line each, as the script does."""
    sms = torch.cuda.get_device_properties(L.device).multi_processor_count
    floor = fma_floor_us(sms, max_sm_clock_mhz())
    rows = []
    for dynamic in (True, False):
        t_lo = timed(tape, L, dynamic, R_LO, reps)
        t_hi = timed(tape, L, dynamic, R_HI, reps)
        per_op = (t_hi - t_lo) / ((R_HI - R_LO) * M) * 1e3
        row = {"dynamic": dynamic, f"R{R_LO}_ms": t_lo, f"R{R_HI}_ms": t_hi,
               "us_per_op_slope": per_op, "fma_floor_us_per_op": floor,
               "below_floor": per_op < floor}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> list:
    if argv:
        raise ValueError(f"the static probe takes no names, got {argv}")
    device = require_card()
    print(card_line(), flush=True)
    tape, L = probe_inputs(device)
    return slopes(tape, L)


if __name__ == "__main__":
    main(sys.argv[1:])
