"""Processes joined into one grid: the counterpart of ``jax.distributed``.

``initialize`` joins this process to a ``torch.distributed`` group over
``tcp://`` (the coordinator's address, the process count and this
process's index given by the caller: nothing on the machine announces a
cluster). After it, ``make_mesh`` (parallel/mesh.py) builds a grid that
spans every process: each process brings its local devices, every
process sees the whole shard list, and shard ``s`` belongs to process
``s // local_shards``. The store's host state is replicated in every
process (the SPMD contract JAX's multi-process dryrun relies on), and each
process prepares and searches only the shards it owns
(parallel/dist_search.py), then exchanges its fixed-shape candidates
with ``all_gather``.

The backend is gloo: NCCL cannot put two ranks on one GPU, which is the
only multi-process layout a one-card machine allows. Over gloo a CUDA
tensor crosses through the host. A run with NCCL over several real cards
has not been made.
"""

from __future__ import annotations

import datetime
from typing import List

import torch
import torch.distributed as dist


def initialize(
    coordinator: str,
    num_processes: int,
    process_id: int,
    backend: str = "gloo",
    timeout: float = 300.0,
) -> None:
    """Join the group of ``num_processes`` processes whose rank 0 listens
    at ``coordinator`` (``host:port``); ``timeout`` seconds bound the
    rendezvous and every later collective."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, {num_processes})")
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout),
    )


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes in the group (1 where none was joined)."""
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    """This process's index in the group (0 where none was joined)."""
    return dist.get_rank() if is_initialized() else 0


def shutdown() -> None:
    """Leave the group (a no-op where none was joined)."""
    if is_initialized():
        dist.destroy_process_group()


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every process's ``t`` (one shape and dtype in all), in process
    order, on ``t``'s device. gloo takes host tensors only: a CUDA tensor
    is copied to the host and back. Raises where no group was joined: a
    grid that spans processes must never answer from one process alone."""
    if not is_initialized():
        raise RuntimeError("all_gather over a process-spanning grid, but no process group is joined")
    host = t.detach().cpu().contiguous() if dist.get_backend() == "gloo" else t.contiguous()
    parts = [torch.empty_like(host) for _ in range(process_count())]
    dist.all_gather(parts, host)
    return [x.to(t.device) for x in parts]
