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
call; layers already placed are used as they are. Under autograd a module
must already be placed: its copy would take the gradient, so that case
raises ValueError.

Over an axis that spans processes (a grid from parallel/distributed.py's
``initialize`` and ``make_mesh``; every process calls with the same x and
layers) stage s runs only in the process that owns it. An activation
crosses to the next process by a point-to-point send on the same
schedule, bubble ticks skipped; the carry keeps x's microbatch shape and
dtype, as JAX's ``ppermute`` carry does. The last stage's output is
broadcast, so every process returns it.

Under autograd that form is one ``torch.autograd.Function``
(``_AcrossProcesses``), so that every send meets its receive whatever
order each process's autograd engine takes. Its forward keeps only each
of this process's stages' input a microbatch; its backward runs the
schedule reversed in time (the last stage first, microbatch M - 1
first), recomputes each (stage, microbatch) forward from its kept input
(GPipe's re-materialization: ``body`` must give the same result twice)
and sends the input's gradient back to the previous stage's process,
each exchange tagged by (stage, microbatch). The output's gradient needs
no exchange: every process differentiates the same loss of the same
broadcast output, as ``ops/collectives.py``'s gather does. x's gradient
is stage 0's, broadcast to every process; each process's own stages'
layers get their ``.grad`` (summed over the microbatches last to first,
the one-process engine's order), and other stages' layers keep theirs
(None where nothing set it). In one process autograd runs through the
``.to()`` copies as it does through any tensor code.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, List, Optional, Sequence

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
        if torch.is_grad_enabled() and any(q.requires_grad for q in layer.parameters()):
            # the copy's fresh leaves would take the gradient, the caller's layer none
            raise ValueError(
                f"a layer on {p.device} runs on its stage's {device} only as a copy, which autograd "
                "cannot reach: move the layers to their stages' devices, or run under torch.no_grad()"
            )
        return copy.deepcopy(layer).to(device)
    return _tree_map(lambda t: t.to(device), layer)


def _grad_leaves(layers) -> List[torch.Tensor]:
    """The tensors of ``layers`` (modules or tree slices) that take a
    gradient, in a fixed order."""
    found = []
    for layer in layers:
        if isinstance(layer, nn.Module):
            found += [p for p in layer.parameters() if p.requires_grad]
        else:
            _tree_map(lambda t: found.append(t) if t.requires_grad else None, layer)
    return found


class _Schedule:
    """One call's GPipe schedule over the stages of ``mine`` (this
    process's; every stage in one process)."""

    def __init__(self, body, grid, devices, owners, mine, stages, microbatches):
        self.body, self.grid, self.devices, self.owners = body, grid, devices, owners
        self.mine, self.stages, self.m = mine, stages, microbatches
        self.kept = None  # (stage, microbatch) -> its input, under ``_AcrossProcesses``

    def _tag(self, s: int, mb: int, backward: bool) -> int:
        """The tag of stage s's exchange of microbatch mb with its
        neighbour: the activation into s + 1, or (backward) the gradient
        back into s - 1."""
        return (len(self.devices) * self.m if backward else 0) + s * self.m + mb

    def _run(self, s: int, h: torch.Tensor) -> torch.Tensor:
        for lp in self.stages[s]:
            h = self.body(h, lp)[0]
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        devices, owners, mine, m = self.devices, self.owners, self.mine, self.m
        p = len(devices)
        x_mb = x.chunk(m)
        inbox = {}  # (stage, microbatch) -> its input, on the stage's device
        outs, sends = [None] * m, []
        for t in range(m + p - 1):
            for s in mine:  # this process's stages
                mb = t - s
                if not 0 <= mb < m:
                    continue  # a bubble tick: this stage has nothing to run
                if s == 0:
                    h = x_mb[mb].to(devices[0])
                elif (s, mb) in inbox:
                    h = inbox.pop((s, mb))
                else:  # sent by the previous stage's process on the last tick
                    h = distributed.recv(x_mb[mb].shape, x.dtype, owners[s - 1], devices[s], self._tag(s - 1, mb, False))
                if self.kept is not None:
                    self.kept[(s, mb)] = h
                h = self._run(s, h)
                if s + 1 == p:
                    outs[mb] = h.to(devices[mine[0]], non_blocking=True)
                elif owners[s + 1] == self.grid.process:
                    inbox[(s + 1, mb)] = h.to(devices[s + 1], non_blocking=True)
                else:
                    if h.shape != x_mb[mb].shape or h.dtype != x.dtype:
                        raise ValueError(f"the carry changed from {tuple(x_mb[mb].shape)} to {tuple(h.shape)}")
                    sends.append(distributed.send_async(h, owners[s + 1], self._tag(s, mb, False)))
        for _, req in sends:
            req.wait()
        if not self.grid.spans_processes:
            return torch.cat(outs, dim=0)
        last = p - 1 in mine
        return distributed.broadcast(torch.cat(outs, dim=0) if last else None, owners[-1], devices[mine[0]])

    def backward(self, grad: torch.Tensor, params, x_like: Optional[torch.Tensor]):
        """The reversed schedule: (x's gradient in every process, like
        ``x_like``, or None where that is None; the gradient of each of
        ``params``' tensors, a list a stage)."""
        devices, owners, mine, m = self.devices, self.owners, self.mine, self.m
        p = len(devices)
        g_mb = grad.chunk(m)
        x_grads, inbox, sends = [None] * m, {}, []
        sums = {s: [None] * len(params[s]) for s in mine}
        for u in range(m + p - 1):
            for s in reversed(mine):
                mb = m + p - 2 - u - s
                if not 0 <= mb < m:
                    continue
                if s + 1 == p:
                    g = g_mb[mb].to(devices[s])
                elif (s, mb) in inbox:
                    g = inbox.pop((s, mb))
                else:  # sent back by the next stage's process on the last tick
                    g = distributed.recv(g_mb[mb].shape, grad.dtype, owners[s + 1], devices[s], self._tag(s + 1, mb, True))
                with torch.enable_grad():
                    h = self.kept.pop((s, mb)).detach().requires_grad_(s > 0 or x_like is not None)
                    wrt = ([h] if h.requires_grad else []) + params[s]
                    got = list(torch.autograd.grad(self._run(s, h), wrt, g, allow_unused=True))
                gh = got.pop(0) if h.requires_grad else None
                for i, gi in enumerate(got):
                    if gi is not None:
                        sums[s][i] = gi if sums[s][i] is None else sums[s][i] + gi
                if s == 0:
                    x_grads[mb] = gh
                elif owners[s - 1] == self.grid.process:
                    inbox[(s - 1, mb)] = gh.to(devices[s - 1])
                else:
                    sends.append(distributed.send_async(gh, owners[s - 1], self._tag(s, mb, True)))
        for _, req in sends:
            req.wait()
        gx = None
        if x_like is not None:
            gx = torch.cat(x_grads, dim=0).to(x_like.device) if 0 in mine else None
            gx = distributed.broadcast(gx, owners[0], x_like.device).to(x_like.dtype)
        return gx, [sums[s] for s in mine]


class _AcrossProcesses(torch.autograd.Function):
    """``_Schedule.forward`` across processes as one autograd node: its
    backward runs every exchange of the reversed schedule in one call."""

    @staticmethod
    def forward(ctx, sched, params, x, *flat):
        sched.kept = {}
        ctx.sched, ctx.params = sched, params
        ctx.x_like = torch.empty(0, dtype=x.dtype, device=x.device)  # x's device and dtype, not x
        return sched.forward(x)

    @staticmethod
    def backward(ctx, grad):
        x_like = ctx.x_like if ctx.needs_input_grad[2] else None
        gx, per_stage = ctx.sched.backward(grad, ctx.params, x_like)
        ctx.sched.kept = None
        return (None, None, gx, *(g for stage in per_stage for g in stage))


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
    size of ``mesh``'s ``axis``). Differentiable in one process and
    across processes (see the module docstring: across processes the
    backward recomputes each stage's forward, and a process's ``.grad``
    reaches only its own stages' layers). A module whose parameters sit
    on another device than its stage's runs as a copy there, so under
    autograd, where the copy would take its gradient, it raises
    ValueError; a stacked tree's slices are moved by differentiable
    copies and need no such care."""
    grid = as_grid(mesh)
    devices, owners, mine = axis_positions(grid, axis)
    p = len(devices)
    layers = _layers(stacked)
    if len(layers) % p:
        raise ValueError(f"{len(layers)} layers not divisible by {p} stages")
    if x.shape[0] % microbatches:
        raise ValueError(f"batch {x.shape[0]} not divisible by microbatches={microbatches}")
    per = len(layers) // p
    stages = {s: [_place(lp, devices[s]) for lp in layers[s * per : (s + 1) * per]] for s in mine}
    sched = _Schedule(body, grid, devices, owners, mine, stages, microbatches)
    if grid.spans_processes and torch.is_grad_enabled():
        params = {s: _grad_leaves(stages[s]) for s in mine}
        flat = [t for s in mine for t in params[s]]
        if x.requires_grad or flat:
            return _AcrossProcesses.apply(sched, params, x, *flat)
    return sched.forward(x)
