"""The collectives of the (data, model) device grid.

Inside one process the port's grid is an ordered list of
``torch.device``s (parallel/mesh.py), so a collective is a copy between
shard devices plus arithmetic on one of them: no ``torch.distributed``.
Both functions are differentiable (``.to()`` and ``torch.cat`` carry the
gradient back to each shard's device), and the reduce sums the partials
in shard order, so a run repeats bit for bit. On a grid of logical
shards of one device every copy is the tensor itself.

Over a grid line that spans processes (``group``: the line's process
group, parallel/distributed.py) they are ``torch.autograd.Function``s
with Megatron's pairs:

- ``reduce_sum``: the ordered all-reduce forward (every shard's part
  gathered and added in shard order, the one-process sum's arithmetic)
  at the exit of a row-split ``out``/``fc2``, identity backward;
- ``enter``: identity forward at the entry of a column-split
  ``qkv``/``fc1``, the all-reduce backward (each process holds the
  gradient of its own shards' heads);
- ``gather``: the all-gather forward, whose backward takes this
  process's slice: every process computes the same global loss, so no
  exchange is needed there.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _dist():
    # parallel/ imports the models, which import this module: late import
    from imatch_tpu_torch.parallel import distributed

    return distributed


class _ReduceRow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *parts):
        ctx.devices = [p.device for p in parts]
        with torch.no_grad():
            return _dist().all_reduce_ordered(parts, group)

    @staticmethod
    def backward(ctx, grad):
        return (None, *(grad.to(d) for d in ctx.devices))


class _EnterRow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return None, _dist().all_reduce_ordered([grad], ctx.group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dim, x):
        ctx.dim, ctx.width = dim, x.shape[dim]
        ctx.index = torch.distributed.get_rank(group)
        with torch.no_grad():
            return torch.cat(_dist().all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return None, None, grad.narrow(ctx.dim, ctx.index * ctx.width, ctx.width)


def reduce_sum(parts: Sequence[torch.Tensor], device: torch.device, group=None) -> torch.Tensor:
    """The sum of the shards' partials on ``device``, added in shard order
    (the model axis' all-reduce, read where its result is used). With
    ``group``, ``parts`` are this process's shards' and every process of
    the group adds all of them."""
    if group is not None:
        return _ReduceRow.apply(group, *parts).to(device)
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc


def enter(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` as the column-split shards read it: itself; with ``group``,
    its gradient is summed over the group's processes in the backward."""
    return x if group is None else _EnterRow.apply(group, x)


def gather(parts: Sequence[torch.Tensor], device: torch.device, dim: int = 0, group=None) -> torch.Tensor:
    """The shards' pieces concatenated in shard order along ``dim`` on
    ``device`` (an all-gather, read on one device). With ``group``,
    ``parts`` are this process's shards' (as many rows in every process)
    and the result holds every process's, in process order."""
    local = parts[0].to(device) if len(parts) == 1 else torch.cat([p.to(device) for p in parts], dim=dim)
    return local if group is None else _GatherRows.apply(group, dim, local)
