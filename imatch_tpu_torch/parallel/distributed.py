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

The grid's paths exchange through the collectives below, each of which
raises where no group is joined (none answers from one process alone):

- ``new_group``: the group of one grid line (a data column or a model
  row whose shards span processes), made by every process in one order;
- ``all_gather`` and ``all_gather_object``: every process's tensor, or
  host object, in process order;
- ``all_reduce_ordered``: the ordered all-reduce. Each process brings its
  own shards' parts in shard order; every process gathers all of them and
  adds them in shard order, as ``ops/collectives.reduce_sum`` does in one
  process, so a grid over processes sums what a grid in one process sums,
  bit for bit, and runs repeat;
- ``hop``: one point-to-point step (``batch_isend_irecv``): tensors to the
  next process of a line and the same shapes from the previous one;
- ``send_async`` and ``recv``: one tensor from one process to another;
- ``broadcast``: a tensor from the process that holds it to all.

The backend is gloo: NCCL cannot put two ranks on one GPU, which is the
only multi-process layout a one-card machine allows. gloo takes host
tensors, so a CUDA tensor crosses through the host. A run with NCCL over
several real cards has not been made.
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_TIMEOUT: Dict[str, datetime.timedelta] = {}
_GROUPS: Dict[Tuple, Any] = {}  # (line key, ranks) -> its group, made once
# parallel/mesh.py's spanning grids made under the joined group, by the
# identity of their device objects; forgotten, with their groups, on shutdown
GRIDS: Dict[Tuple[int, ...], Any] = {}


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
    _TIMEOUT["t"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
        timeout=_TIMEOUT["t"],
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
    """Leave the group (a no-op where none was joined). The grids made
    under it lose their groups (a later collective on one raises) and are
    forgotten: a list of their devices makes a new grid after a new
    ``initialize``."""
    if is_initialized():
        dist.destroy_process_group()
    for grid in GRIDS.values():
        grid.groups.clear()
    GRIDS.clear()
    _GROUPS.clear()


def _require(what: str) -> None:
    if not is_initialized():
        raise RuntimeError(f"{what} over a process-spanning grid, but no process group is joined")


def _host(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend takes it: on the host for gloo."""
    return t.detach().cpu().contiguous() if dist.get_backend() == "gloo" else t.detach().contiguous()


def new_group(key: Tuple, ranks: Sequence[int]):
    """The group of ``ranks`` for the grid line ``key`` (a collective:
    every process makes every line's group, in one order; a line's group
    is made once and kept)."""
    _require("new_group")
    ranks = tuple(sorted(ranks))
    got = _GROUPS.get((key, ranks))
    if got is None:
        got = _GROUPS[(key, ranks)] = dist.new_group(list(ranks), timeout=_TIMEOUT.get("t"))
    return got


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every process's ``t`` (one shape and dtype in all), in process
    order, on ``t``'s device. gloo takes host tensors only: a CUDA tensor
    is copied to the host and back. Raises where no group was joined: a
    grid that spans processes must never answer from one process alone."""
    _require("all_gather")
    host = _host(t)
    if host.dtype == torch.bool:  # gloo has no bool: as bytes
        host = host.to(torch.uint8)
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, host, group=group)
    return [x.to(device=t.device, dtype=t.dtype) for x in parts]


def all_gather_object(obj: Any, group=None) -> List[Any]:
    """Every process's picklable ``obj`` (host state), in process order."""
    _require("all_gather_object")
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def all_reduce_ordered(parts: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """The sum of every shard's part along a grid line, on the first
    part's device: this process brings its own shards' ``parts`` (as many
    as every other process of ``group``, in shard order), all are
    gathered, and the sum runs in shard order (``acc = p0; acc = acc +
    p1; ...``), the one-process reduce's arithmetic."""
    dev = parts[0].device
    mine = torch.stack([p.to(dev) for p in parts])
    _require("all_reduce_ordered")
    host = _host(mine)
    got = [torch.empty_like(host) for _ in range(dist.get_world_size(group))]
    dist.all_gather(got, host, group=group)
    me = dist.get_rank(group)
    # this process's own parts stay where they are; the others' come to dev
    flat = [p for i, g in enumerate(got) for p in (mine if i == me else g.to(dev)).unbind(0)]
    acc = flat[0]
    for p in flat[1:]:
        acc = acc + p
    return acc


def hop(tensors: Sequence[torch.Tensor], dst: int, src: int) -> List[torch.Tensor]:
    """One point-to-point step: ``tensors`` sent to process ``dst`` and as
    many of the same shapes and dtypes received from process ``src`` (one
    ``batch_isend_irecv``), on the first tensor's device."""
    _require("hop")
    dev = tensors[0].device
    out = [_host(t) for t in tensors]
    bufs = [torch.empty_like(t) for t in out]
    ops = [dist.P2POp(dist.isend, t, dst) for t in out] + [dist.P2POp(dist.irecv, b, src) for b in bufs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(dev) for b in bufs]


def send_async(t: torch.Tensor, dst: int):
    """``t`` sent to process ``dst`` without waiting; wait on the returned
    handle (which keeps the host copy alive) before reusing it."""
    _require("send")
    host = _host(t)
    return host, dist.isend(host, dst)


def recv(shape, dtype: torch.dtype, src: int, device) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` from process ``src``."""
    _require("recv")
    buf = torch.empty(shape, dtype=dtype, device="cpu" if dist.get_backend() == "gloo" else device)
    dist.recv(buf, src)
    return buf.to(device)


def broadcast(t: Optional[torch.Tensor], src: int, device) -> torch.Tensor:
    """The tensor ``t`` of process ``src`` (None elsewhere) in every
    process, on ``device``; its shape and dtype travel first."""
    _require("broadcast")
    meta = [None if t is None else (tuple(t.shape), t.dtype)]
    dist.broadcast_object_list(meta, src=src)
    shape, dtype = meta[0]
    if dist.get_rank() == src:
        buf = _host(t)
    else:
        buf = torch.empty(shape, dtype=dtype, device="cpu" if dist.get_backend() == "gloo" else device)
    dist.broadcast(buf, src=src)
    return buf.to(device)


def barrier() -> None:
    _require("barrier")
    dist.barrier()
