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
    As the TPU kept the scratch in VMEM, the card keeps it in shared
    memory: a block takes one cell x a tile of T columns (pipe_plan
    chooses T so that its scratch [scratch_rows, T] f32 and block slice
    [block_rows, T] bf16 fit in 227 KB), thread (i, col) owns the rows = i
    (mod 16) of its column, and TMA streams the slice into shared memory
    while the block fills and loops.  An experiment that
    does not fill its scratch (init False) reads whatever that shared
    memory held, on the TPU an earlier cell's VMEM: its output is
    undefined on both sides, and its time is the point.
  - csrc/stream_sum.cu (the script's `run4d`): each cell sums its bf16
    block, [32, 256, 128] (stream_sum_4d) or the same bytes as [8192, 128]
    (stream_sum_3d), in groups of 8 rows into out [CELLS, 8, 128] f32.
    One body serves both walks; a thread adds its share of the groups in
    order and a block adds the shares in a fixed order, so the sums are
    the same on every run, and exact wherever float32 holds every partial
    sum (the script's ones block, chip_smoke's small integers).

The pipe cell's times are read from the device (graph_ms): operands and
output are allocated once, REPS launches are captured in a CUDA graph and
its replays are timed with CUDA events, so no host work lies between the
kernels (the script timed a jitted scan of REPS calls on the TPU, scaling
the block before each to keep XLA from folding them).  Each experiment
prints its us per cell beside both terms of its bound (pipe_bound_ms):
the device-memory bytes it must move and the scratch's shared-memory
bytes.  The stream sums are timed the same way, beside torch.sum over
the same groups (torch_stream_sum), also from a CUDA graph.

    python -m bito_tpu_torch.perflab pipe [expname ... | dma4d | tiles]
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from . import (GRAPH_TIMING, card_line, count_launch, graph_ms,
               max_sm_clock_mhz, require_card)
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


TILES = (64, 32, 16, 8)   # columns a block, 16 threads each (pipe_cell.cu)
MAX_SMEM = 232448          # 227 KB of shared memory a block
SM_SMEM = 233472           # 228 KB an SM, 1 KB of it reserved a block
# The kernel's static arrays (the offsets and the mbarrier, 264 bytes,
# padded to the dynamic array's 128-byte alignment: 384, as
# cudaFuncGetAttributes reads them on sm_90a) and the dynamic bytes that
# align the block slice for TMA: the launch takes dynamic + 128 bytes
# where that is at most MAX_SMEM less the static ones.
SMEM_STATIC = 384
SMEM_EXTRA = SMEM_STATIC + 128
# the most scratch rows a block of 8 rows and 8 columns takes
EDGE_SCRATCH_ROWS = (MAX_SMEM - SMEM_EXTRA - 8 * 8 * 2) // (8 * 4)
MAX_STAGE = 256            # rows of one TMA box
STREAM_ROWS = 256          # past this, a block slice keeps 16+ columns
MAX_STORES = 4             # the kernel's bodies: 0-4 stores an iteration


@dataclasses.dataclass(frozen=True)
class PipePlan:
    tile: int          # T, the columns of a block (16 T threads)
    stage_rows: int    # rows of one TMA box of the block slice
    smem: int          # shared bytes of a block (pipe_smem)


def pipe_smem(block_rows: int, scratch_rows: int, tile: int) -> int:
    """A block's shared bytes: its block slice [block_rows, T] bf16, its
    scratch [scratch_rows, T] f32, its static offsets and mbarrier and the
    bytes that align the slice for TMA (csrc/pipe_cell.cu's launch limit
    counts the same)."""
    return tile * (2 * block_rows + 4 * scratch_rows) + SMEM_EXTRA


def blocks_per_sm(smem: int) -> int:
    return SM_SMEM // (smem + 1024)


def pipe_plan(block_rows: int, scratch_rows: int,
              tile: int | None = None) -> PipePlan:
    """The block's tile and TMA stage for one experiment, or `tile` where
    it fits.  The rule, from H100 times of every experiment at every tile
    (chip_smoke.py phase 4): a block slice of more than STREAM_ROWS rows
    takes the widest tile of 16 columns or more that fits (its stream is
    its cost, and 8 columns use half of each 32-byte sector); any other
    takes 16 columns where two blocks fit an SM, else 8 (a few small
    blocks an SM hide each other's latency better than one wide one).
    Raises where even 8 columns do not fit: the scratch has no place in
    device memory on this design."""
    if block_rows < 8 or block_rows % 8:
        raise ValueError(f"the kernel takes block rows a multiple of 8, got "
                         f"{block_rows}")
    fits = [t for t in TILES
            if pipe_smem(block_rows, scratch_rows, t) <= MAX_SMEM]
    if not fits:
        raise ValueError(
            f"a scratch of {scratch_rows} rows and a block of {block_rows} "
            f"rows need {pipe_smem(block_rows, scratch_rows, 8)} bytes of "
            f"shared memory at 8 columns, past the {MAX_SMEM} a block has")
    if tile is None:
        wide = [t for t in fits if t >= 16]
        if block_rows > STREAM_ROWS and wide:
            tile = wide[0]
        elif blocks_per_sm(pipe_smem(block_rows, scratch_rows, 16)) >= 2:
            tile = 16
        else:
            tile = 8
    elif tile not in fits:
        raise ValueError(f"tile {tile} does not fit {block_rows} block rows "
                         f"and {scratch_rows} scratch rows; these do: {fits}")
    stage = next(r for r in range(min(MAX_STAGE, block_rows), 0, -8)
                 if block_rows % r == 0)
    return PipePlan(tile, stage, pipe_smem(block_rows, scratch_rows, tile))


def _check_pipe(idx, big, scratch_rows: int, loops: int, stores: int) -> None:
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
    if big.data_ptr() % 16:  # the tensor map's base
        raise ValueError("big is not 16-byte aligned")
    if not 0 <= stores <= MAX_STORES:
        raise ValueError(f"the kernel takes 0 to {MAX_STORES} stores, got "
                         f"{stores}")
    if scratch_rows < max(8, ROWS * min(loops, OFFSETS)):
        raise ValueError(f"{loops} loops read past {scratch_rows} scratch rows")
    lo, hi = int(idx.min()), int(idx.max())
    if lo < 0 or (hi + 1) * ROWS > scratch_rows:
        raise ValueError(f"idx in [{lo}, {hi}] stores past {scratch_rows} "
                         "scratch rows")


def launch_pipe_cell(idx, big, out, plan: PipePlan, *, scratch_rows: int,
                     init: bool, loops: int, stores: int) -> None:
    """One launch into `out` [cells, 8, S] f32 of operands that the wrapper
    checked, on `plan`; no allocation and no host sync, so a CUDA graph can
    capture it."""
    cells, block_rows, cols = big.shape
    with torch.cuda.device(big.device):
        rc = _kernels.library().bito_pipe_cell(
            idx.data_ptr(), big.data_ptr(), out.data_ptr(), cells,
            block_rows, scratch_rows, cols, int(init), loops, stores,
            plan.tile, plan.stage_rows,
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "bito_pipe_cell")
    count_launch(pipe_cell)


def pipe_cell(idx, big, *, scratch_rows: int, init: bool, loops: int,
              stores: int) -> torch.Tensor:
    """One launch of the pipe cell over every cell: out [cells, 8, S].  On
    the card the only allocation is `out`: the scratch lives in shared
    memory (pipe_plan raises where it does not fit)."""
    if big.device.type == "cpu":
        return pipe_cell_ref(idx, big, scratch_rows=scratch_rows, init=init,
                             loops=loops, stores=stores)
    _check_pipe(idx, big, scratch_rows, loops, stores)
    plan = pipe_plan(big.shape[1], scratch_rows)
    out = torch.empty((big.shape[0], 8, big.shape[2]), dtype=torch.float32,
                      device=big.device)
    launch_pipe_cell(idx, big, out, plan, scratch_rows=scratch_rows,
                     init=init, loops=loops, stores=stores)
    return out


pipe_cell.launches = 0


def stream_bytes(block_rows: int, cells: int = CELLS) -> int:
    """Device-memory bytes a launch must move: idx and the block read once,
    the output written once."""
    return cells * (OFFSETS * 4 + block_rows * S * 2 + 8 * S * 4)


def scratch_bytes(scratch_rows: int, init: bool, loops: int, stores: int,
                  cells: int = CELLS) -> int:
    """Shared-memory bytes of the scratch's work, 4 a value: the fill's
    writes, and the loop's 16 rows read and 16 written per store where it
    stores (with no store the loop feeds nothing)."""
    rows = (scratch_rows if init else 0) + (
        loops * ROWS * (1 + stores) if stores else 0)
    return cells * rows * S * 4


def pipe_bound_ms(block_rows, scratch_rows, init, loops, stores, *,
                  cells: int = CELLS, sms: int, clock_mhz: float,
                  hbm_bytes_per_s: float = 3.35e12):
    """(device-memory ms, shared-memory ms) of one launch: the least time
    of each term, shared memory at 128 bytes a clock an SM; the bound is
    the larger."""
    smem_bytes_per_s = 128.0 * sms * clock_mhz * 1e6
    return (stream_bytes(block_rows, cells) / hbm_bytes_per_s * 1e3,
            scratch_bytes(scratch_rows, init, loops, stores, cells)
            / smem_bytes_per_s * 1e3)


def stream_sum_ref(big) -> torch.Tensor:
    """Plain torch version of both stream sums: [cells, 8, cols] f32."""
    cells, cols = big.shape[0], big.shape[-1]
    return big.float().reshape(cells, -1, 8, cols).sum(dim=1)


def _stream_walk(big):
    """(nslices, rows, slices, wrapper) of a stream sum's operand: a 4-D
    block is walked slice by slice (stream_sum_4d), a 3-D one flat
    (stream_sum_3d)."""
    if big.dim() == 4:
        return big.shape[1], big.shape[2], True, stream_sum_4d
    return 1, big.shape[1], False, stream_sum_3d


def launch_stream_sum(big, out) -> None:
    """Launch the stream sum of `big` (4-D or 3-D, as _stream_walk walks
    it) into `out` [cells, 8, cols] f32 on the current stream, allocating
    nothing and syncing nothing (graph_ms captures it); checks only what
    the launch needs."""
    cells, cols = big.shape[0], big.shape[-1]
    nslices, rows, slices, wrapper = _stream_walk(big)
    with torch.cuda.device(big.device):
        rc = _kernels.library().bito_stream_sum(
            big.data_ptr(), out.data_ptr(), cells, nslices, rows, cols,
            int(slices), torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "bito_stream_sum")
    count_launch(wrapper)


def _stream_sum(big):
    cells, cols = big.shape[0], big.shape[-1]
    if big.dtype != torch.bfloat16:
        raise TypeError(f"big must be bf16, got {big.dtype}")
    if big.device.type != "cuda" or not big.is_contiguous():
        raise ValueError("big must be a contiguous CUDA tensor")
    if _stream_walk(big)[1] % 8:
        raise ValueError(f"the kernel takes rows a multiple of 8, got "
                         f"{tuple(big.shape)}")
    if big.data_ptr() % 16:  # the kernel reads 16-byte chunks
        raise ValueError("big is not 16-byte aligned")
    out = torch.empty((cells, 8, cols), dtype=torch.float32, device=big.device)
    launch_stream_sum(big, out)
    return out


def torch_stream_sum(big, out) -> torch.Tensor:
    """The one PyTorch call that computes a stream sum, into `out`: the
    grouped sum in float32 (torch.sum), the library comparison."""
    cells, cols = big.shape[0], big.shape[-1]
    return torch.sum(big.reshape(cells, -1, 8, cols), dim=1,
                     dtype=torch.float32, out=out)


def stream_sum_4d(big4) -> torch.Tensor:
    """Sums of 8-row groups of each cell's block [nslices, rows, cols],
    walked slice by slice (the script's kernel4)."""
    if big4.dim() != 4:
        raise ValueError(f"big4 must be [cells, nslices, rows, cols], got "
                         f"{tuple(big4.shape)}")
    if big4.device.type == "cpu":
        return stream_sum_ref(big4)
    return _stream_sum(big4)


def stream_sum_3d(big3) -> torch.Tensor:
    """Sums of 8-row groups of each cell's block [rows, cols], walked flat
    (the script's kernel3)."""
    if big3.dim() != 3:
        raise ValueError(f"big3 must be [cells, rows, cols], got "
                         f"{tuple(big3.shape)}")
    if big3.device.type == "cpu":
        return stream_sum_ref(big3)
    return _stream_sum(big3)


stream_sum_4d.launches = 0
stream_sum_3d.launches = 0


def run(name, block_rows, scratch_rows, init, loops, stores, *,
        reps: int = REPS, cells: int = CELLS, tile: int | None = None):
    """Time one experiment on the card (graph_ms: operands and output
    allocated once, the launches captured in a CUDA graph) and print its
    us per cell beside both terms of its bound.  Returns (us per cell, out
    of the first call)."""
    device = require_card()
    idx, big = pipe_inputs(block_rows, scratch_rows, cells, device)
    kw = dict(scratch_rows=scratch_rows, init=init, loops=loops,
              stores=stores)
    out = pipe_cell(idx, big, **kw)  # checks the operands once
    plan = pipe_plan(block_rows, scratch_rows, tile)
    timed_out = torch.empty_like(out)
    ms = graph_ms(lambda: launch_pipe_cell(idx, big, timed_out, plan, **kw),
                  reps, pipe_cell)
    per_cell = ms * 1e3 / cells
    hbm, smem = pipe_bound_ms(
        block_rows, scratch_rows, init, loops, stores, cells=cells,
        sms=torch.cuda.get_device_properties(device).multi_processor_count,
        clock_mhz=max_sm_clock_mhz())
    print(f"{name:34s} {per_cell:8.4f} us/cell (T={plan.tile}, "
          f"{plan.smem} B); bound {max(hbm, smem) * 1e3 / cells:.4f} "
          f"(device memory {hbm * 1e3 / cells:.4f}, shared memory "
          f"{smem * 1e3 / cells:.4f})", flush=True)
    return per_cell, out


def tile_sweep(names=None, *, reps: int = REPS, cells: int = CELLS) -> dict:
    """Each experiment at every tile that fits: {name: {tile: us per
    cell}}, the card times pipe_plan's rule was set from."""
    result = {}
    for name in names or EXPS:
        exp = EXPS[name]
        result[name] = {}
        for tile in TILES:
            if pipe_smem(*exp[:2], tile) <= MAX_SMEM:
                result[name][tile] = run(f"{name} T={tile}", *exp,
                                         reps=reps, cells=cells,
                                         tile=tile)[0]
    return result


def run4d(name, nslices, rows, cols, *, reps: int = REPS,
          cells: int = CELLS):
    """Time both layouts of the same bytes from the device (graph_ms:
    operand and output allocated once, the launches captured in a CUDA
    graph), beside torch.sum over the same groups timed the same way, and
    print their us per cell.  Returns {"4d": (us per cell, out, torch.sum
    us per cell), "3d": (...)}."""
    device = require_card()
    big4 = torch.ones((cells, nslices, rows, cols), dtype=torch.bfloat16,
                      device=device)
    result = {}
    for tag, fn, arr in (("4d", stream_sum_4d, big4),
                         ("3d", stream_sum_3d,
                          big4.reshape(cells, nslices * rows, cols))):
        out = fn(arr)  # checks the operand once
        timed_out, lib_out = torch.empty_like(out), torch.empty_like(out)
        per_cell = graph_ms(lambda: launch_stream_sum(arr, timed_out), reps,
                            fn) * 1e3 / cells
        lib_cell = graph_ms(lambda: torch_stream_sum(arr, lib_out),
                            reps) * 1e3 / cells
        print(f"{name}-{tag:31s} {per_cell:8.4f} us/cell (torch.sum "
              f"{lib_cell:.4f})", flush=True)
        result[tag] = (per_cell, out, lib_cell)
    return result


def main(argv=None) -> dict:
    names = list(argv or EXPS)
    for name in names:
        if name not in ("dma4d", "tiles") and name not in EXPS:
            raise ValueError(f"unknown experiment {name!r}; one of "
                             f"{[*EXPS, 'dma4d', 'tiles']}")
    require_card()
    print(card_line(), flush=True)
    print(f"# timing: {GRAPH_TIMING}", flush=True)
    return {name: run4d(*DMA4D) if name == "dma4d"
            else tile_sweep() if name == "tiles" else run(name, *EXPS[name])
            for name in names}


if __name__ == "__main__":
    main(sys.argv[1:])
