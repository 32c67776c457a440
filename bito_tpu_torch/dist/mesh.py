"""Process groups and sharding over the site-pattern axis.

Port of bito_tpu.dist.mesh.  bito_tpu lays a jax.sharding.Mesh over its
devices and lets XLA insert the psum wherever a program consumes
pattern-sharded operands and produces replicated outputs.  Here a process
group takes the mesh's place, each rank holds its slice of the pattern
axis as a tensor of its own, and the sums over patterns are reduced
explicitly: all_reduce_sum, one collective a sum.  DAG structure, model
parameters and branch lengths are whole on every rank.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _world():
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: join a job first (dist.multihost.initialize, "
            "or start the processes with python -m bito_tpu_torch.dist.launch)")
    return dist.group.WORLD


def make_group(n: Optional[int] = None):
    """The world, or its first `n` ranks, as a process group.  Every rank
    of the world must call it (torch.distributed.new_group's rule); a rank
    outside the first `n` gets a group it is not a member of."""
    world = _world()
    size = dist.get_world_size()
    if n is None or n == size:
        return world
    if not 1 <= n <= size:
        raise ValueError(f"a group of {n} ranks in a world of {size}")
    return dist.new_group(ranks=list(range(n)))


def group_rank_size(group=None) -> tuple[int, int]:
    """(this process's rank in `group`, the group's size); `group` None is
    the world.  Raises where this process is not a member."""
    group = _world() if group is None else group
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not a member of the group")
    return rank, dist.get_world_size(group)


def shard_patterns(tensor: torch.Tensor, pattern_axis: int, group=None
                   ) -> torch.Tensor:
    """This rank's contiguous slice of `tensor` along `pattern_axis`, whose
    length must be a multiple of the group's size (pad_to_multiple)."""
    from .multihost import PatternShard

    return PatternShard.of(tensor.shape[pattern_axis], group).take(
        tensor, pattern_axis)


def replicate(tensor: torch.Tensor, group=None, src: int = 0
              ) -> torch.Tensor:
    """Make `tensor` the same on every rank of `group`: rank `src`'s values
    (a group rank), broadcast in place.  Returns the tensor."""
    group = _world() if group is None else group
    dist.broadcast(tensor, dist.get_global_rank(group, src), group=group)
    return tensor


def unsharded(tensor: torch.Tensor) -> torch.Tensor:
    """The `reduce` of an unsharded engine: its sums over patterns are
    already whole."""
    return tensor


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """The sum of `tensor` over the ranks of `group`, on every rank: one
    all_reduce.  Returns a new tensor where `tensor` is not contiguous,
    else `tensor` itself, reduced in place."""
    tensor = tensor.contiguous()
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def check_same(value: int, group, what: str) -> None:
    """Raise on every rank of `group` (the world where None) unless every
    rank passed the same `value`, an int in [0, 2**63): one all_gather of
    one int64 a rank, so that every rank sees every rank's value and all
    raise together (none is left waiting in a later collective).  The
    message names `what` differs and which group ranks differ from rank
    0.  The tensor is on the card under NCCL, else on the CPU."""
    group = _world() if group is None else group
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    mine = torch.tensor([value], dtype=torch.int64, device=device)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, mine, group=group)
    values = [int(v) for v in every]
    if len(set(values)) > 1:
        differ = [r for r, v in enumerate(values) if v != values[0]]
        raise RuntimeError(
            f"the ranks of the process group hold different {what}: group "
            f"rank(s) {differ} differ from rank 0 ({len(set(values))} "
            f"distinct values over {len(values)} ranks)")


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class PatternSharded:
    """The pattern sharding of an engine (TreeLikelihoodEngine, GPEngine):
    `group`, the process group (None: unsharded), and `pattern_shard`,
    this rank's slice of the padded pattern axis."""

    group = None
    pattern_shard = None

    def _take_shard(self, width: int, multiple: int, group=None):
        """Join `group` (the world where None) and return this rank's
        PatternShard of `width` patterns padded to a multiple of the
        group's size times `multiple`.  Raises where the engine is
        already sharded."""
        from .multihost import PatternShard

        if self.group is not None:
            raise RuntimeError("the engine's patterns are already sharded")
        group = make_group() if group is None else group
        rank, size = group_rank_size(group)
        self.group = group
        self.pattern_shard = PatternShard(
            rank, size, pad_to_multiple(width, size * multiple))
        return self.pattern_shard

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """A sum over this rank's patterns made the whole alignment's: the
        all_reduce over the engine's group (t itself where unsharded)."""
        return t if self.group is None else all_reduce_sum(t, self.group)
