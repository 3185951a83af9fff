"""The device list the sharded index engines run over.

Counterpart of ``imatch_tpu/parallel/mesh.py``'s data axis. The JAX store
is one process driving every local device (a single controller,
``shard_map``); the port keeps that shape: its "mesh" is an ordered tuple
of ``torch.device``s inside one process, shard ``s`` on ``mesh[s]``, and
the index uses no ``torch.distributed``. A device may repeat: P shards on
``cpu`` are the counterpart of the JAX suite's virtual host devices, and
P shards on ``cuda:0`` run the sharded engines' merge on one card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

Mesh = Tuple[torch.device, ...]


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """``devices`` as a tuple of ``torch.device`` (names or devices, in
    shard order), or by default every visible CUDA device, one shard
    each. Raises where no CUDA device is visible and none are named."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device visible: name the mesh's devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh
