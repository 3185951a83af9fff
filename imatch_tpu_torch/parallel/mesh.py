"""The (data, model) device grid.

Counterpart of ``imatch_tpu/parallel/mesh.py``: axes ``data`` (batch and
corpus sharding; its collectives gather embeddings and top-k candidates)
and ``model`` (tensor parallelism inside the towers: attention heads and
the MLP's hidden width; one reduce at each block's output), the model axis
innermost.

The JAX package is one process driving every local device (a single
controller); the port keeps that shape. A grid is an ordered tuple of
``torch.device``s inside one process, row-major over (data, model), so
shard (d, m) is ``grid[d * model + m]``. Inside a process it uses no
``torch.distributed``: NCCL cannot put two ranks on one GPU. A device may
repeat: 8 shards on ``cpu`` are the counterpart of the JAX suite's virtual
host devices, and P logical shards of ``cuda:0`` run the grid's code on one
card. The collectives are copies between shard devices
(ops/collectives.py). A run over several real cards has not been made.

The sharded index engines take a grid as their list of shards
(index/store.py): a grid with ``model == 1`` is the data axis alone.

Across processes (the counterpart of a JAX mesh after
``jax.distributed.initialize``): once parallel/distributed.py has joined
the processes, ``make_mesh`` gathers every process's local devices into
one grid that every process sees whole. Shard ``s`` belongs to process
``s // local_shards`` (``grid.owners``); a process touches only its own
shards (``grid.is_local``), and the sharded engine exchanges its
candidates over the process group (parallel/dist_search.py). The model
axis stays inside a process: such a grid has ``model == 1``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from imatch_tpu_torch.device import resolve_device
from imatch_tpu_torch.parallel import distributed

AXIS_DATA = "data"
AXIS_MODEL = "model"


class Grid(tuple):
    """Devices in row-major (data, model) order, a ``tuple`` of
    ``torch.device`` (so the index engines iterate it as their shards).
    ``owners``: the process of each shard (all 0 in one process);
    ``process``: this process's index."""

    model: int
    owners: Tuple[int, ...]
    process: int

    def __new__(cls, devices: Sequence, model: int = 1, owners: Optional[Sequence[int]] = None, process: int = 0):
        grid = super().__new__(cls, (torch.device(d) for d in devices))
        dp, mp = mesh_shape_for(len(grid), model)
        if dp == 0:
            raise ValueError("a grid needs at least one device")
        grid.model = mp
        grid.owners = tuple(owners) if owners is not None else (0,) * len(grid)
        grid.process = process
        if len(grid.owners) != len(grid):
            raise ValueError(f"{len(grid.owners)} owners for {len(grid)} shards")
        if len(set(grid.owners)) > 1 and mp != 1:
            raise ValueError("the model axis cannot span processes: model_parallel must be 1 on such a grid")
        return grid

    def __getnewargs__(self):
        return (tuple(self), self.model, self.owners, self.process)

    @property
    def spans_processes(self) -> bool:
        return len(set(self.owners)) > 1

    def is_local(self, s: int) -> bool:
        """Whether shard ``s`` belongs to this process."""
        return self.owners[s] == self.process

    @property
    def shape(self) -> Dict[str, int]:
        return {AXIS_DATA: len(self) // self.model, AXIS_MODEL: self.model}

    def device(self, d: int, m: int) -> torch.device:
        """The device of shard (d, m)."""
        return self[d * self.model + m]

    def row(self, d: int) -> Tuple[torch.device, ...]:
        """The model shards of data shard ``d``."""
        return tuple(self[d * self.model : (d + 1) * self.model])

    def axis(self, name: str) -> Tuple[torch.device, ...]:
        """The devices along axis ``name`` through shard (0, 0): the data
        axis is column 0, the model axis row 0 (a ring's or a pipeline's
        devices, in order)."""
        if name == AXIS_DATA:
            return tuple(self.device(d, 0) for d in range(len(self) // self.model))
        if name == AXIS_MODEL:
            return self.row(0)
        raise ValueError(f"unknown mesh axis {name!r}: {AXIS_DATA!r} or {AXIS_MODEL!r}")

    def __repr__(self) -> str:
        owners = f", owners={list(self.owners)}" if self.spans_processes else ""
        return f"Grid(data={len(self) // self.model}, model={self.model}, {list(map(str, self))}{owners})"


Mesh = Grid


def mesh_shape_for(n_devices: int, model_parallel: int = 1) -> Tuple[int, int]:
    """Split ``n_devices`` into (data, model) with ``model`` innermost."""
    if model_parallel < 1 or n_devices % model_parallel:
        raise ValueError(
            f"{n_devices} devices not divisible by model_parallel={model_parallel}"
        )
    return (n_devices // model_parallel, model_parallel)


def _checked(devices: Sequence) -> list:
    """Each device resolved (a CUDA device raises where there is no card),
    and a CUDA index past the visible cards refused."""
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev}: only {torch.cuda.device_count()} CUDA devices visible")
        out.append(dev)
    return out


def as_grid(mesh: Optional[Sequence]) -> Optional[Grid]:
    """``mesh`` as a grid: a ``Grid`` as it is, a device list as its data
    axis (``make_mesh(devices)``), None as None."""
    if mesh is None or isinstance(mesh, Grid):
        return mesh
    return make_mesh(list(mesh))


def _spanning(local: list, model_parallel: int) -> Grid:
    """The grid over every process's ``local`` devices, in process order
    (a collective: every process of the group calls it)."""
    import torch.distributed as dist

    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, [str(d) for d in local])
    if len({len(n) for n in names}) != 1:
        raise ValueError(f"every process must bring as many shards: {[len(n) for n in names]}")
    return Grid(
        [d for n in names for d in n],
        model_parallel,
        owners=[p for p, n in enumerate(names) for _ in n],
        process=dist.get_rank(),
    )


def make_mesh(
    model_parallel: Union[int, Sequence, None] = 1, devices: Optional[Sequence] = None
) -> Grid:
    """The grid over ``devices`` (names or ``torch.device``s, in order; a
    device may repeat), by default every visible CUDA device, one shard
    each, split into (data, model) with ``model_parallel`` innermost.
    ``make_mesh(devices)``, the store's form, is ``make_mesh(1, devices)``.
    Raises where no CUDA device is visible and none are named, for a
    device that does not exist, and where ``model_parallel`` does not
    divide the device count.

    In a process joined to others (parallel/distributed.py) ``devices``
    are this process's own, and the grid spans every process's (a
    collective: each process calls it with as many devices). A grid that
    already spans processes is returned as it is."""
    if model_parallel is None or not isinstance(model_parallel, int):
        model_parallel, devices = 1, model_parallel
    if isinstance(devices, Grid) and devices.spans_processes:
        return devices
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device visible: name the mesh's devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    if not len(devices):
        raise ValueError("a mesh needs at least one device")
    local = _checked(devices)
    if distributed.is_initialized():
        return _spanning(local, model_parallel)
    return Grid(local, model_parallel)
