"""The few collectives the sharded rounds use, over ``torch.distributed``
process groups (the port's counterparts of JAX's ``psum``, ``pmean`` and
``axis_index`` inside ``shard_map``).

A group of ``None``, or of one rank, is no group: every function here is
then the local identity and runs no collective, so an unsharded caller
and a mesh of one rank run the same code with no communication.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """Ranks in ``group``; 1 for ``None``."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in ``group`` (JAX's ``axis_index``); 0 for ``None``."""
    return 0 if group is None else dist.get_rank(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (JAX's ``psum``), in a
    new tensor. Complex tensors reduce as their real views."""
    if group_size(group) == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (JAX's ``pmean``)."""
    n = group_size(group)
    return x if n == 1 else all_reduce_sum(x, group) / n


def ant_sum(x: torch.Tensor, dim, group) -> torch.Tensor:
    """Sum over the antenna axis ``dim`` of an antenna shard: the local sum,
    then the sum over the antenna group's ranks."""
    return all_reduce_sum(x.sum(dim), group)


def ant_slice(n_ant: int, group) -> slice:
    """This rank's contiguous block of the ``n_ant`` antennas, as a shard
    of ``shard_map``'s ``P("tp")`` takes it."""
    n = group_size(group)
    if n_ant % n:
        raise ValueError(f"n_ant {n_ant} not divisible by tp={n}")
    k = n_ant // n
    r = group_rank(group)
    return slice(r * k, (r + 1) * k)


def _device_for(group) -> torch.device:
    """Where a small host value must live for a collective over ``group``:
    NCCL reduces CUDA tensors only."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_max_int(n: int, group) -> int:
    """The largest of the ranks' ``n`` (one collective; ``n`` for no group)."""
    if group_size(group) == 1:
        return n
    t = torch.tensor([n], dtype=torch.int64, device=_device_for(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())
