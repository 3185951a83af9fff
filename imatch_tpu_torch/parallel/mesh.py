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
shards (``grid.is_local``) and exchanges over the process group
(parallel/distributed.py). Each grid line whose shards span processes (a
data column, a model row) has a group of its own (``grid.group``), made
when the grid is; ``grid.local_block()`` is this process's rectangle of
data rows and model columns. Either axis may span processes: with
``owners=[0, 0, 1, 1]`` and ``model=2`` each process holds a whole model
row and only the data axis crosses processes; with one shard a process
and ``model=2`` the model row does. A list of a spanning grid's devices,
or the grid itself, is that grid: it is never stitched a second time
(until parallel/distributed.py's ``shutdown``, which forgets the grids
made under the group it leaves).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

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
        grid.groups = {}  # (axis, index) -> the line's process group (``_spanning`` fills it)
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

    def line(self, axis: str, index: int) -> Tuple[int, ...]:
        """The shard indices of one grid line: data column ``index``
        (axis ``data``) or model row ``index`` (axis ``model``)."""
        dp = len(self) // self.model
        if axis == AXIS_DATA:
            return tuple(d * self.model + index for d in range(dp))
        if axis == AXIS_MODEL:
            return tuple(range(index * self.model, (index + 1) * self.model))
        raise ValueError(f"unknown mesh axis {axis!r}: {AXIS_DATA!r} or {AXIS_MODEL!r}")

    def lines(self, axis: str) -> List[Tuple[int, ...]]:
        n = self.model if axis == AXIS_DATA else len(self) // self.model
        return [self.line(axis, i) for i in range(n)]

    def line_spans(self, axis: str, index: int) -> bool:
        return len({self.owners[s] for s in self.line(axis, index)}) > 1

    def group(self, axis: str, index: int):
        """The process group of a line whose shards span processes; None
        for a line inside one process. Raises for a spanning line without
        a group (a grid built by hand, no process joined)."""
        if not self.line_spans(axis, index):
            return None
        got = self.groups.get((axis, index))
        if got is None:
            raise RuntimeError(
                f"the {axis} line {index} of {self!r} spans processes, but no process group is joined"
            )
        return got

    def local_shards(self) -> List[int]:
        return [s for s in range(len(self)) if self.is_local(s)]

    def local_block(self) -> Tuple[List[int], List[int]]:
        """This process's data rows and model columns: its shards must be
        their product, each a contiguous run (every layout ``make_mesh``
        builds with ``model_parallel`` dividing, or a multiple of, the
        shards a process brings). Raises ValueError for another layout."""
        mine = self.local_shards()
        rows = sorted({s // self.model for s in mine})
        cols = sorted({s % self.model for s in mine})
        rect = {d * self.model + m for d in rows for m in cols}
        contiguous = all(b - a == 1 for seq in (rows, cols) for a, b in zip(seq, seq[1:]))
        if not mine or rect != set(mine) or not contiguous:
            raise ValueError(
                f"process {self.process} holds shards {mine} of {self!r}: not a block of whole "
                "data rows and model columns, which the grid's paths need"
            )
        return rows, cols

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
    """The grid over every process's ``local`` devices, in process order,
    with a process group for each of its lines that spans processes (a
    collective: every process of the group calls it)."""
    names = distributed.all_gather_object([str(d) for d in local])
    if len({len(n) for n in names}) != 1:
        raise ValueError(f"every process must bring as many shards: {[len(n) for n in names]}")
    grid = Grid(
        [d for n in names for d in n],
        model_parallel,
        owners=[p for p, n in enumerate(names) for _ in n],
        process=distributed.process_index(),
    )
    for axis in (AXIS_DATA, AXIS_MODEL):
        for i, line in enumerate(grid.lines(axis)):
            if grid.line_spans(axis, i):
                key = (axis, i, tuple(grid.owners), model_parallel)
                grid.groups[(axis, i)] = distributed.new_group(key, {grid.owners[s] for s in line})
    # known by the identity of its device objects (made for it: a list of
    # them came from the grid) until the group is left
    distributed.GRIDS[tuple(map(id, grid))] = grid
    return grid


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
    already spans processes, or the list of its devices (at its model
    axis), is returned as that grid, with no collective."""
    if model_parallel is None or not isinstance(model_parallel, int):
        model_parallel, devices = 1, model_parallel
    if isinstance(devices, Grid) and (devices.spans_processes or devices.model == model_parallel):
        return devices  # a grid is itself: never stitched again
    if devices is not None:
        known = distributed.GRIDS.get(tuple(map(id, devices)))
        if known is not None and known.model == model_parallel:
            return known  # a spanning grid's own devices: that grid
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
