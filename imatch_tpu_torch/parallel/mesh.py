"""The (data, model) device grid.

Counterpart of ``imatch_tpu/parallel/mesh.py``: axes ``data`` (batch and
corpus sharding; its collectives gather embeddings and top-k candidates)
and ``model`` (tensor parallelism inside the towers: attention heads and
the MLP's hidden width; one reduce at each block's output), the model axis
innermost.

The JAX package is one process driving every local device (a single
controller); the port keeps that shape. A grid is an ordered tuple of
``torch.device``s inside one process, row-major over (data, model), so
shard (d, m) is ``grid[d * model + m]``. It uses no ``torch.distributed``:
NCCL cannot put two ranks on one GPU. A device may repeat: 8 shards on
``cpu`` are the counterpart of the JAX suite's virtual host devices, and P
logical shards of ``cuda:0`` run the grid's code on one card. The
collectives are copies between shard devices (ops/collectives.py). A run
over several real cards has not been made.

The sharded index engines take a grid as their list of shards
(index/store.py): a grid with ``model == 1`` is the data axis alone.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from imatch_tpu_torch.device import resolve_device

AXIS_DATA = "data"
AXIS_MODEL = "model"


class Grid(tuple):
    """Devices in row-major (data, model) order, a ``tuple`` of
    ``torch.device`` (so the index engines iterate it as their shards)."""

    model: int

    def __new__(cls, devices: Sequence, model: int = 1):
        grid = super().__new__(cls, (torch.device(d) for d in devices))
        dp, mp = mesh_shape_for(len(grid), model)
        if dp == 0:
            raise ValueError("a grid needs at least one device")
        grid.model = mp
        return grid

    def __getnewargs__(self):
        return (tuple(self), self.model)

    @property
    def shape(self) -> Dict[str, int]:
        return {AXIS_DATA: len(self) // self.model, AXIS_MODEL: self.model}

    def device(self, d: int, m: int) -> torch.device:
        """The device of shard (d, m)."""
        return self[d * self.model + m]

    def row(self, d: int) -> Tuple[torch.device, ...]:
        """The model shards of data shard ``d``."""
        return tuple(self[d * self.model : (d + 1) * self.model])

    def __repr__(self) -> str:
        return f"Grid(data={len(self) // self.model}, model={self.model}, {list(map(str, self))})"


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


def make_mesh(
    model_parallel: Union[int, Sequence, None] = 1, devices: Optional[Sequence] = None
) -> Grid:
    """The grid over ``devices`` (names or ``torch.device``s, in order; a
    device may repeat), by default every visible CUDA device, one shard
    each, split into (data, model) with ``model_parallel`` innermost.
    ``make_mesh(devices)``, the store's form, is ``make_mesh(1, devices)``.
    Raises where no CUDA device is visible and none are named, for a
    device that does not exist, and where ``model_parallel`` does not
    divide the device count."""
    if model_parallel is None or not isinstance(model_parallel, int):
        model_parallel, devices = 1, model_parallel
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device visible: name the mesh's devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    if not len(devices):
        raise ValueError("a mesh needs at least one device")
    return Grid(_checked(devices), model_parallel)
