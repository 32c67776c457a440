"""The perf lab: probes of the kernels' per-op costs on the card.

Counterpart of bito_tpu's four perf-lab scripts, each a module here with
its hand-written CUDA kernels (csrc/, built with the tree-likelihood
kernels by treelike/_kernels.py):
  - perf_lab: the per-node grad kernel with the knobs unroll, resk and
    nodot (scripts/perf_lab.py), csrc/variant_grad.cu;
  - perf_pipe_lab: what a grid cell costs for its scratch and its streamed
    block, and whether the block's layout matters
    (scripts/perf_pipe_lab.py), csrc/pipe_cell.cu and csrc/stream_sum.cu;
  - perf_static_probe: one op of a dependent chain with offsets from a
    tape against offsets fixed at compile time
    (scripts/perf_static_probe.py), csrc/static_chain.cu;
  - perf_chunk_lab: the chunked LL kernel's on-chip body with the knobs
    of scripts/perf_chunk_lab.py, csrc/chunk_variant.cu (which
    instantiates treelike/csrc/paired_ll_onchip.cuh).

    python -m bito_tpu_torch.perflab [lab|pipe|static|chunk] [names ...]

Each kernel's wrapper sends a CPU tensor to its plain torch version and a
CUDA tensor to the kernel, and counts its launches.  The timing entry
points need a card and raise without one.  cuda_ms times calls between
CUDA events; graph_ms times launches captured in a CUDA graph, for the
kernels whose wrappers' host work would outlast them (the pipe cell and
the chain).
"""
from __future__ import annotations

import subprocess

import torch


def require_card() -> torch.device:
    """The CUDA device; raises where there is none (no CPU path for
    timing)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the perf lab times the CUDA kernels and needs an "
                           "NVIDIA card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return _smi("name,power.limit")


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock in MHz (nvidia-smi clocks.max.sm)."""
    return float(_smi("clocks.max.sm").split()[0])


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn` over `reps` calls, from CUDA
    events, after `warmup` calls.  Where a call's host work outlasts its
    kernels, this is the host's time: use graph_ms for short kernels."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


GRAPH_TIMING = "CUDA graph of the launches, CUDA events around its replays"


def count_launch(wrapper) -> None:
    """Add one to `wrapper.launches` where its kernel runs now: a launch
    captured in a CUDA graph runs only when the graph is replayed, and
    graph_ms counts it there."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1


def graph_ms(launch, reps: int, counter=None, replays: int = 3) -> float:
    """Mean device milliseconds of one `launch()`: `reps` launches captured
    in one CUDA graph, replayed once to warm up, then `replays` times
    between two CUDA events, so no host work lies between the kernels.
    `launch` must neither allocate nor synchronise: it runs once before
    the capture and `reps` times inside it, on the capture stream (which
    torch.cuda.current_stream() returns there).  `counter`, the wrapper
    whose kernel `launch` launches, gains the reps * (1 + replays)
    launches the replays run (its launcher counts none while captured)."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            launch()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    if counter is not None:
        counter.launches += reps * (1 + replays)
    return start.elapsed_time(end) / (replays * reps)
