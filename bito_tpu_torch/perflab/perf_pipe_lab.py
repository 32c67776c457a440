"""Pipeline experiments: what a grid cell costs for its scratch and its
streamed block, with an (almost) empty body, and whether the layout of a
streamed block matters.

Counterpart of scripts/perf_pipe_lab.py, with its nine experiments (EXPS),
CELLS = 100 cells, S = 1,024 columns and REPS = 40 calls.  Two kernels:
  - csrc/pipe_cell.cu (the script's `run`): per cell, stream a bf16 block
    [block_rows, S], optionally fill an f32 scratch [scratch_rows, S] with
    ones, run `loops` iterations that read 16 scratch rows and store them,
    plus 1, to `stores` places whose offsets come from idx [CELLS, 1, 64]
    at run time, and write scratch[0:8] + block[0:8] to out [CELLS, 8, S].
    On the card a scratch of 2,080-4,160 rows (8.5-17 MB) does not fit in
    shared memory: each cell has its own in device memory, 0.85-1.7 GB at
    100 cells, allocated with torch.empty.  An experiment that does not
    fill its scratch (init False) reads whatever that memory held, on the
    TPU an earlier cell's VMEM: its output is undefined on both sides, and
    its time is the point.
  - csrc/stream_sum.cu (the script's `run4d`): each cell sums its bf16
    block, [32, 256, 128] (stream_sum_4d) or the same bytes as [8192, 128]
    (stream_sum_3d), in groups of 8 rows into out [CELLS, 8, 128] f32.
    One body serves both walks; a thread adds its share of the groups in
    order and a block adds the shares in a fixed order, so the sums are
    the same on every run, and exact wherever float32 holds every partial
    sum (the script's ones block, chip_smoke's small integers).

Times are CUDA-event means over REPS back-to-back launches, in us per
cell.  The script scaled the block before every call to keep XLA from
folding the calls; eager torch calls need no such guard, so only the
kernel is timed.

    python -m bito_tpu_torch.perflab pipe [expname ... | dma4d]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import card_line, cuda_ms, require_card
from ..device import PRODUCT_DEVICE
from ..treelike import _kernels

CELLS = 100
S = 1024
REPS = 40
OFFSETS = 64     # idx entries per cell
ROWS = 16        # rows per load and store of the loop
EXPS = {
    # name: (block_rows, scratch_rows, init, loops, stores)
    "tiny-block_tiny-scratch": (8, 128, False, 0, 0),
    "big-block_tiny-scratch": (1024, 128, False, 0, 0),
    "tiny-block_big-scratch": (8, 2080, False, 0, 0),
    "tiny-block_big-scratch_init": (8, 2080, True, 0, 0),
    "big-block_big-scratch_init": (1024, 2080, True, 0, 0),
    "tiny_big_init_loop28": (8, 2080, True, 28, 0),
    "tiny_big_init_loop28_st4": (8, 2080, True, 28, 4),
    "paired-like": (256, 1024, True, 52, 2),
    "double-scratch-4160": (8, 4160, True, 0, 0),
}
DMA4D = ("dma-32x256x128", 32, 256, 128)   # the script's "dma4d"


def pipe_inputs(block_rows: int, scratch_rows: int, cells: int = CELLS,
                device=PRODUCT_DEVICE):
    """(idx [cells, 1, 64] int32, block [cells, block_rows, S] bf16 ones),
    as the script builds them (perf_pipe_lab.py:47-51)."""
    idx = np.random.default_rng(0).integers(0, scratch_rows // ROWS - 1,
                                            (cells, 1, OFFSETS))
    return (torch.as_tensor(idx, dtype=torch.int32, device=device),
            torch.ones((cells, block_rows, S), dtype=torch.bfloat16,
                       device=device))


def pipe_cell_ref(idx, big, *, scratch_rows: int, init: bool, loops: int,
                  stores: int) -> torch.Tensor:
    """Plain torch version of the pipe cell: out [cells, 8, S] f32."""
    cells, _, cols = big.shape
    kw = dict(dtype=torch.float32, device=big.device)
    scratch = (torch.ones if init else torch.empty)((cells, scratch_rows, cols),
                                                    **kw)
    cell = torch.arange(cells, device=big.device)[:, None]
    offs = idx[:, 0].long() * ROWS                          # [cells, 64]
    rows = torch.arange(ROWS, device=big.device)
    for c in range(loops):
        src = ROWS * (c % OFFSETS)
        v = scratch[:, src:src + ROWS] + 1.0
        for k in range(stores):
            scratch[cell, offs[:, (c + k) % OFFSETS, None] + rows] = v
    return scratch[:, :8] + big[:, :8].float()


def _check_pipe(idx, big, scratch_rows: int, loops: int) -> None:
    if big.dim() != 3 or big.dtype != torch.bfloat16:
        raise TypeError(f"big must be bf16 [cells, rows, S], got "
                        f"{big.dtype} {tuple(big.shape)}")
    cells, block_rows, cols = big.shape
    if tuple(idx.shape) != (cells, 1, OFFSETS) or idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32 {(cells, 1, OFFSETS)}, got "
                        f"{idx.dtype} {tuple(idx.shape)}")
    for name, t in (("idx", idx), ("big", big)):
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    if cols % 128 or block_rows < 8:
        raise ValueError(f"the kernel takes S a multiple of 128 and at least "
                         f"8 block rows, got {tuple(big.shape)}")
    if scratch_rows < max(8, ROWS * min(loops, OFFSETS)):
        raise ValueError(f"{loops} loops read past {scratch_rows} scratch rows")
    lo, hi = int(idx.min()), int(idx.max())
    if lo < 0 or (hi + 1) * ROWS > scratch_rows:
        raise ValueError(f"idx in [{lo}, {hi}] stores past {scratch_rows} "
                         "scratch rows")


def _launch_pipe_cell(idx, big, scratch_rows, init, loops, stores):
    cells, block_rows, cols = big.shape
    kw = dict(dtype=torch.float32, device=big.device)
    scratch = torch.empty((cells, scratch_rows, cols), **kw)
    out = torch.empty((cells, 8, cols), **kw)
    with torch.cuda.device(big.device):
        rc = _kernels.library().bito_pipe_cell(
            idx.data_ptr(), big.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), cells, block_rows, scratch_rows, cols, int(init),
            loops, stores, torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "bito_pipe_cell")
    pipe_cell.launches += 1
    return out


def pipe_cell(idx, big, *, scratch_rows: int, init: bool, loops: int,
              stores: int) -> torch.Tensor:
    """One launch of the pipe cell over every cell: out [cells, 8, S]."""
    if big.device.type == "cpu":
        return pipe_cell_ref(idx, big, scratch_rows=scratch_rows, init=init,
                             loops=loops, stores=stores)
    _check_pipe(idx, big, scratch_rows, loops)
    return _launch_pipe_cell(idx, big, scratch_rows, init, loops, stores)


pipe_cell.launches = 0


def stream_sum_ref(big) -> torch.Tensor:
    """Plain torch version of both stream sums: [cells, 8, cols] f32."""
    cells, cols = big.shape[0], big.shape[-1]
    return big.float().reshape(cells, -1, 8, cols).sum(dim=1)


def _stream_sum(big, nslices, rows, slices, wrapper):
    cells, cols = big.shape[0], big.shape[-1]
    if big.dtype != torch.bfloat16:
        raise TypeError(f"big must be bf16, got {big.dtype}")
    if big.device.type != "cuda" or not big.is_contiguous():
        raise ValueError("big must be a contiguous CUDA tensor")
    if rows % 8:
        raise ValueError(f"the kernel takes rows a multiple of 8, got "
                         f"{tuple(big.shape)}")
    if big.data_ptr() % 16:  # the kernel reads 16-byte chunks
        raise ValueError("big is not 16-byte aligned")
    out = torch.empty((cells, 8, cols), dtype=torch.float32, device=big.device)
    with torch.cuda.device(big.device):
        rc = _kernels.library().bito_stream_sum(
            big.data_ptr(), out.data_ptr(), cells, nslices, rows, cols,
            int(slices), torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "bito_stream_sum")
    wrapper.launches += 1
    return out


def stream_sum_4d(big4) -> torch.Tensor:
    """Sums of 8-row groups of each cell's block [nslices, rows, cols],
    walked slice by slice (the script's kernel4)."""
    if big4.dim() != 4:
        raise ValueError(f"big4 must be [cells, nslices, rows, cols], got "
                         f"{tuple(big4.shape)}")
    if big4.device.type == "cpu":
        return stream_sum_ref(big4)
    return _stream_sum(big4, big4.shape[1], big4.shape[2], True, stream_sum_4d)


def stream_sum_3d(big3) -> torch.Tensor:
    """Sums of 8-row groups of each cell's block [rows, cols], walked flat
    (the script's kernel3)."""
    if big3.dim() != 3:
        raise ValueError(f"big3 must be [cells, rows, cols], got "
                         f"{tuple(big3.shape)}")
    if big3.device.type == "cpu":
        return stream_sum_ref(big3)
    return _stream_sum(big3, 1, big3.shape[1], False, stream_sum_3d)


stream_sum_4d.launches = 0
stream_sum_3d.launches = 0


def run(name, block_rows, scratch_rows, init, loops, stores, *,
        reps: int = REPS, cells: int = CELLS):
    """Time one experiment on the card and print its us per cell.  Returns
    (us per cell, out of the first call)."""
    device = require_card()
    idx, big = pipe_inputs(block_rows, scratch_rows, cells, device)
    kw = dict(scratch_rows=scratch_rows, init=init, loops=loops,
              stores=stores)
    out = pipe_cell(idx, big, **kw)  # checks the operands once
    ms = cuda_ms(lambda: _launch_pipe_cell(idx, big, **kw), reps)
    per_cell = ms * 1e3 / cells
    print(f"{name:34s} {per_cell:8.2f} us/cell", flush=True)
    return per_cell, out


def run4d(name, nslices, rows, cols, *, reps: int = REPS,
          cells: int = CELLS):
    """Time both layouts of the same bytes and print their us per cell.
    Returns {"4d": (us per cell, out), "3d": (...)}."""
    device = require_card()
    big4 = torch.ones((cells, nslices, rows, cols), dtype=torch.bfloat16,
                      device=device)
    result = {}
    for tag, fn, arr in (("4d", stream_sum_4d, big4),
                         ("3d", stream_sum_3d,
                          big4.reshape(cells, nslices * rows, cols))):
        out = fn(arr)
        per_cell = cuda_ms(lambda: fn(arr), reps) * 1e3 / cells
        print(f"{name}-{tag:31s} {per_cell:8.2f} us/cell", flush=True)
        result[tag] = (per_cell, out)
    return result


def main(argv=None) -> dict:
    names = list(argv or EXPS)
    for name in names:
        if name != "dma4d" and name not in EXPS:
            raise ValueError(f"unknown experiment {name!r}; one of "
                             f"{[*EXPS, 'dma4d']}")
    require_card()
    print(card_line(), flush=True)
    return {name: run4d(*DMA4D) if name == "dma4d" else run(name, *EXPS[name])
            for name in names}


if __name__ == "__main__":
    main(sys.argv[1:])
