"""The collectives of the (data, model) device grid, as explicit copies.

The port's grid is one process driving an ordered list of
``torch.device``s (parallel/mesh.py), so a collective is a copy between
shard devices plus arithmetic on one of them: no ``torch.distributed``.
Both functions are differentiable (``.to()`` and ``torch.cat`` carry the
gradient back to each shard's device), and the reduce sums the partials
in shard order, so a run repeats bit for bit. On a grid of logical
shards of one device every copy is the tensor itself.
"""

from __future__ import annotations

from typing import Sequence

import torch


def reduce_sum(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum of the shards' partials on ``device``, added in shard order
    (the model axis' all-reduce, read where its result is used)."""
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc


def gather(parts: Sequence[torch.Tensor], device: torch.device, dim: int = 0) -> torch.Tensor:
    """The shards' pieces concatenated in shard order along ``dim`` on
    ``device`` (an all-gather, read on one device)."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts], dim=dim)
