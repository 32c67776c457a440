"""Joining a multi-process job on torch.distributed.

Port of bito_tpu.dist.multihost.  The reference has no distributed layer
(SURVEY section 5.8); bito_tpu's joins a jax.distributed job and lays one
mesh over every host's chips, whose single axis is the site patterns.
Here a job is a torch.distributed process group: one process a rank,
each holding one slice of the pattern axis (PatternShard) on its own
device, with tree encodings, model parameters, branch lengths and q
whole on every rank.  Every sum over patterns is then one all_reduce
(dist/mesh.py all_reduce_sum), which the engines make themselves
(TreeLikelihoodEngine, GPEngine and GPScoredNNIEngine.shard_patterns).

The backend is chosen by a rule, never by trying one and then another:
NCCL where each rank has a card of its own, Gloo on the CPU and where
ranks share one card (Gloo takes CUDA tensors for all_reduce and
broadcast, staging them through the host).  NCCL refuses two ranks on one
card, so NCCL for more ranks than a host's visible cards is refused:
by the launcher, which starts them all, and by `initialize` where the
coordinator is a loopback address (then every rank is on this host;
behind another address it cannot see how many ranks share the host).
A rank's device is BITO_DEVICE, the card (PRODUCT_DEVICE) where that is
unset, checked by device.resolve: a missing card raises.  On the card,
rank r takes card r mod the host's visible cards.

Launch recipe (2 hosts, one card each):
    # host 0
    BITO_COORDINATOR=host0:8476 BITO_NUM_PROCESSES=2 BITO_PROCESS_ID=0 \
        BITO_BACKEND=nccl python train.py
    # host 1: the same with BITO_PROCESS_ID=1 (its card 0)
`import bito_tpu_torch` joins the job when BITO_COORDINATOR is set (or
call initialize() yourself), then `engine.shard_patterns()`.  On one
machine, `python -m bito_tpu_torch.dist.launch -n 2 script.py` starts
the processes and sets the variables.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import PRODUCT_DEVICE, PRODUCT_DTYPE, resolve

BACKENDS = ("gloo", "nccl")
DEVICES = ("cpu", "cuda")
TIMEOUT_S = 600  # a collective that waits longer than this raises
LOOPBACK = ("localhost", "127.0.0.1", "::1")


def default_backend(device: str, ranks_on_host: int) -> str:
    """The backend for `ranks_on_host` ranks on this host's `device`: NCCL
    where each rank has a card of its own, else Gloo."""
    if device == "cuda" and ranks_on_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def check_backend(backend: str, device: str, ranks_on_host: int) -> None:
    """Raises where `backend` cannot serve `ranks_on_host` ranks on this
    host's `device`: an unknown name, NCCL off the card, or NCCL with more
    ranks than visible cards (it refuses two ranks on one card)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if device not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {device!r}")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("the NCCL backend needs device 'cuda'")
        cards = torch.cuda.device_count()
        if ranks_on_host > cards:
            raise ValueError(
                f"NCCL takes one card a rank: {ranks_on_host} ranks, "
                f"{cards} visible card(s); use the Gloo backend where ranks "
                "share a card")


def _device_kind() -> str:
    """BITO_DEVICE, the card where it is unset; a card that is missing
    raises (device.resolve)."""
    kind = os.environ.get("BITO_DEVICE", PRODUCT_DEVICE)
    if kind not in DEVICES:
        raise ValueError(f"BITO_DEVICE must be one of {DEVICES}, got {kind!r}")
    resolve(kind, PRODUCT_DTYPE)
    return kind


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = TIMEOUT_S) -> None:
    """Join this process to the job: torch.distributed.init_process_group
    over tcp://<coordinator_address>.  Arguments not given come from
    BITO_COORDINATOR, BITO_NUM_PROCESSES, BITO_PROCESS_ID and BITO_BACKEND
    (which dist.launch sets); the device from BITO_DEVICE (the card where
    unset; raises without one), the backend, where neither names it,
    from default_backend.  Every rank counts as on this host where the
    coordinator is a loopback address, else this rank alone.  Does nothing when no
    coordinator is set (a single-process run) and nothing when the group
    already exists.  With NCCL, card process_id mod the visible cards
    becomes the current device."""
    coordinator_address = coordinator_address or os.environ.get(
        "BITO_COORDINATOR")
    if coordinator_address is None or dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ["BITO_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["BITO_PROCESS_ID"])
    device = _device_kind()
    host = coordinator_address.rsplit(":", 1)[0].strip("[]")
    ranks_on_host = num_processes if host in LOOPBACK else 1
    backend = (backend or os.environ.get("BITO_BACKEND")
               or default_backend(device, ranks_on_host))
    check_backend(backend, device, ranks_on_host)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def local_device() -> torch.device:
    """This rank's device, from BITO_DEVICE (the card where it is unset;
    raises without one): on the card, card rank mod the visible cards, so
    ranks that share one card all take card 0."""
    if _device_kind() == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", process_index() % torch.cuda.device_count())


@dataclass(frozen=True)
class PatternShard:
    """The slice [start, stop) of a pattern axis of `total` columns that
    rank `rank` of `size` holds: contiguous and of equal widths, so
    `total` must be a multiple of `size` (pad first: mesh.pad_to_multiple,
    with columns of weight 0)."""

    rank: int
    size: int
    total: int

    def __post_init__(self):
        if self.total % self.size:
            raise ValueError(f"{self.total} patterns do not split into "
                             f"{self.size} equal shards")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} is not in a group of "
                             f"{self.size}")

    @classmethod
    def of(cls, total: int, group=None) -> "PatternShard":
        """This process's shard in `group` (the world where None)."""
        from .mesh import group_rank_size

        rank, size = group_rank_size(group)
        return cls(rank, size, total)

    @property
    def width(self) -> int:
        return self.total // self.size

    @property
    def start(self) -> int:
        return self.rank * self.width

    @property
    def stop(self) -> int:
        return self.start + self.width

    def take(self, tensor: torch.Tensor, pattern_axis: int,
             fill: Optional[float] = None) -> torch.Tensor:
        """This shard's slice of `tensor` along `pattern_axis`, as a
        contiguous tensor of its own.  With `fill`, the axis is first
        padded to `total` columns with columns of `fill`."""
        short = self.total - tensor.shape[pattern_axis]
        if fill is not None and short > 0:
            shape = list(tensor.shape)
            shape[pattern_axis] = short
            tensor = torch.cat([tensor, tensor.new_full(shape, fill)],
                               dim=pattern_axis)
        if tensor.shape[pattern_axis] != self.total:
            raise ValueError(f"the pattern axis has "
                             f"{tensor.shape[pattern_axis]} columns, the "
                             f"shard splits {self.total}")
        return tensor.narrow(pattern_axis, self.start, self.width).contiguous()


def place(array, *, device, dtype=None, pattern_axis: Optional[int] = None,
          group=None) -> torch.Tensor:
    """A host array (the same on every rank) as a tensor on `device`: the
    whole array, or with `pattern_axis` this rank's PatternShard of it."""
    tensor = torch.as_tensor(np.asarray(array), dtype=dtype, device=device)
    if pattern_axis is None:
        return tensor
    return PatternShard.of(tensor.shape[pattern_axis], group).take(
        tensor, pattern_axis)


def replicated_to_host(tensor: torch.Tensor) -> np.ndarray:
    """A tensor that every rank holds whole (a reduced result), as numpy."""
    return tensor.detach().cpu().numpy()
