"""GPipe: pipeline parallelism for stacked transformer layers.

Counterpart of ``imatch_tpu/parallel/pipeline.py``. ``gpipe_scan`` is the
pipelined form of running ``body`` over the layers in order: the layers are
cut into P contiguous stages over one axis of the device grid
(parallel/mesh.py ``Grid.axis``; stage s on the axis's s-th device), the
batch into M microbatches, and activations flow stage to stage on the
GPipe schedule of M + P - 1 ticks (bubble fraction (P - 1) / (M + P - 1)).
At each tick every busy stage is launched before anything is waited on,
and each stage's output is copied to the next stage's device without
blocking, so on several cards the stages run at once.

Unlike JAX's SPMD body, which runs every stage on every tick (on zeros in
the bubble), the port skips a stage's bubble ticks: the layers run L x M
times, not L x (M + P - 1). The result is ``body``'s loop over the layers
on the whole batch, on the axis's first device; each row's arithmetic is
the loop's, though a layer's matmuls see M-row microbatches.

``stacked`` takes JAX's form, a dict (nested dicts, lists or tuples
allowed) of tensors with a leading layer axis, or the port's, a sequence
of layers such as ``Encoder.layers`` (models/clip/model.py). A layer not
on its stage's device is copied there for the call (tensors moved, modules
deep-copied), as JAX's shard_map places the stacked parameters on each
call; layers already placed are used as they are.

Over an axis that spans processes (a grid from parallel/distributed.py's
``initialize`` and ``make_mesh``; every process calls with the same x and
layers) stage s runs only in the process that owns it. An activation
crosses to the next process by a point-to-point send on the same
schedule, bubble ticks skipped; the carry keeps x's microbatch shape and
dtype, as JAX's ``ppermute`` carry does. The last stage's output is
broadcast, so every process returns it. This form is forward only: under
autograd it raises RuntimeError (no JAX caller differentiates
``gpipe_scan``; its backward across processes is queued).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, List, Sequence

import torch
from torch import nn

from imatch_tpu_torch.parallel import distributed
from imatch_tpu_torch.parallel.mesh import AXIS_MODEL, as_grid
from imatch_tpu_torch.parallel.ring_attention import axis_positions


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def _layers(stacked) -> List[Any]:
    """One entry a layer: a module as it is, or the stacked tree's slice."""
    if isinstance(stacked, dict):
        n = _first_leaf(stacked).shape[0]
        return [_tree_map(lambda t, i=i: t[i], stacked) for i in range(n)]
    return list(stacked)


def _place(layer, device: torch.device):
    if isinstance(layer, nn.Module):
        p = next(layer.parameters(), None)
        if p is None or p.device == device:
            return layer
        return copy.deepcopy(layer).to(device)
    return _tree_map(lambda t: t.to(device), layer)


def _requires_grad(layer) -> bool:
    if isinstance(layer, nn.Module):
        return any(p.requires_grad for p in layer.parameters())
    found = []
    _tree_map(lambda t: found.append(t.requires_grad), layer)
    return any(found)


def gpipe_scan(
    body: Callable,
    x: torch.Tensor,
    stacked,
    *,
    mesh: Sequence,
    axis: str = AXIS_MODEL,
    microbatches: int = 4,
) -> torch.Tensor:
    """Pipeline-parallel ``for layer in stacked: x = body(x, layer)[0]``.

    body: (h, layer) -> (h, _). x: (B, ...) with B divisible by
    ``microbatches``; the layer count must divide by the stage count (the
    size of ``mesh``'s ``axis``)."""
    grid = as_grid(mesh)
    devices, owners, mine = axis_positions(grid, axis)
    p = len(devices)
    layers = _layers(stacked)
    if len(layers) % p:
        raise ValueError(f"{len(layers)} layers not divisible by {p} stages")
    if x.shape[0] % microbatches:
        raise ValueError(f"batch {x.shape[0]} not divisible by microbatches={microbatches}")
    across = grid.spans_processes
    if across and torch.is_grad_enabled() and (x.requires_grad or any(_requires_grad(lp) for lp in layers)):
        raise RuntimeError(
            "gpipe_scan across processes is forward only: run it under torch.no_grad() "
            "(its backward across processes is not ported)"
        )
    per = len(layers) // p
    stages = {s: [_place(lp, devices[s]) for lp in layers[s * per : (s + 1) * per]] for s in mine}
    x_mb = x.chunk(microbatches)
    inbox = {}  # (stage, microbatch) -> its input, on the stage's device
    outs, sends = [None] * microbatches, []
    for t in range(microbatches + p - 1):
        for s in mine:  # this process's stages
            mb = t - s
            if not 0 <= mb < microbatches:
                continue  # a bubble tick: this stage has nothing to run
            if s == 0:
                h = x_mb[mb].to(devices[0])
            elif (s, mb) in inbox:
                h = inbox.pop((s, mb))
            else:  # sent by the previous stage's process on the last tick
                h = distributed.recv(x_mb[mb].shape, x.dtype, owners[s - 1], devices[s])
            for lp in stages[s]:
                h = body(h, lp)[0]
            if s + 1 == p:
                outs[mb] = h.to(devices[mine[0]], non_blocking=True)
            elif owners[s + 1] == grid.process:
                inbox[(s + 1, mb)] = h.to(devices[s + 1], non_blocking=True)
            else:
                if h.shape != x_mb[mb].shape or h.dtype != x.dtype:
                    raise ValueError(f"the carry changed from {tuple(x_mb[mb].shape)} to {tuple(h.shape)}")
                sends.append(distributed.send_async(h, owners[s + 1]))
    for _, req in sends:
        req.wait()
    if not across:
        return torch.cat(outs, dim=0)
    last = p - 1 in mine
    return distributed.broadcast(torch.cat(outs, dim=0) if last else None, owners[-1], devices[mine[0]])
