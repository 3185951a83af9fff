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
"""

from __future__ import annotations

import copy
from typing import Any, Callable, List, Sequence

import torch
from torch import nn

from imatch_tpu_torch.parallel.mesh import AXIS_MODEL, as_grid


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
    devices = as_grid(mesh).axis(axis)
    p = len(devices)
    layers = _layers(stacked)
    if len(layers) % p:
        raise ValueError(f"{len(layers)} layers not divisible by {p} stages")
    if x.shape[0] % microbatches:
        raise ValueError(f"batch {x.shape[0]} not divisible by microbatches={microbatches}")
    per = len(layers) // p
    stages = [[_place(lp, dev) for lp in layers[s * per : (s + 1) * per]] for s, dev in enumerate(devices)]
    x_mb = x.to(devices[0]).chunk(microbatches)
    inbox = {}  # (stage, microbatch) -> its input, on the stage's device
    outs = [None] * microbatches
    for t in range(microbatches + p - 1):
        for s in range(p):
            mb = t - s
            if not 0 <= mb < microbatches:
                continue  # a bubble tick: this stage has nothing to run
            h = x_mb[mb] if s == 0 else inbox.pop((s, mb))
            for lp in stages[s]:
                h = body(h, lp)[0]
            if s + 1 < p:
                inbox[(s + 1, mb)] = h.to(devices[s + 1], non_blocking=True)
            else:
                outs[mb] = h.to(devices[0], non_blocking=True)
    return torch.cat(outs, dim=0)
