"""Ring attention: sequence parallelism over one axis of the device grid.

Counterpart of ``imatch_tpu/parallel/ring_attention.py``. The sequence is
cut into P equal shards over the axis's devices (parallel/mesh.py
``Grid.axis``: the data axis is the grid's column 0, the model axis its
row 0). Shard r's queries stay on device r, and the K/V blocks move one
hop a step around the ring: at hop i device r holds block (r - i) mod P,
copied in from device r - 1. Each device keeps an online softmax (running
max ``m``, denominator ``l`` and fp32 accumulator), so no device ever holds
more than an (S / P, S / P) block of logits.

The arithmetic is JAX's hop for hop: queries upcast to fp32 and then
scaled by Dh^-0.5, fp32 logits, the causal mask by global positions with
``NEG_INF`` (a finite -1e30: a later hop's block may be fully masked, and
exp(-inf - -inf) is NaN), ``m``, ``l`` and ``acc`` updated in hop order,
then ``acc / max(l, 1e-30)`` cast to q's dtype. JAX's hop is einsums (XLA,
no Pallas), so this is plain PyTorch (``matmul``, ``exp``), and autograd
differentiates it. Every device's hop is launched before any copy is
waited on, so on several cards the devices compute at once; the output is
gathered on the axis's first device.

Over an axis that spans processes (a grid from parallel/distributed.py's
``initialize`` and ``make_mesh``; every process calls with the same whole
q, k and v) each process holds only its own positions' Q/K/V blocks. K/V
move within a process as above, and from its last position to the next
process's first by a point-to-point hop (``_Hop``, whose backward sends
the gradient one hop back). The output is all-gathered, so every process
returns (B, H, S, Dh) on its first position's device, and q, k and v
enter through ``_Enter``, whose backward sums their gradients over the
processes (each holds its own positions'): ``sum(ring)``'s gradient is
the one-process ring's in every process. The axis must hold positions of
every process.
"""

from __future__ import annotations

from typing import Sequence

import torch

from imatch_tpu_torch.ops.collectives import gather
from imatch_tpu_torch.parallel import distributed
from imatch_tpu_torch.parallel.mesh import AXIS_DATA, Grid, as_grid

NEG_INF = -1e30


def _hop(qf, kk, vv, m, l, acc, masked):
    """One ring step on one device: (m, l, acc) updated by a K/V block;
    ``masked``: the (S/P, S/P) causal mask of the block, or None."""
    s = torch.matmul(qf, kk.float().transpose(-1, -2))
    if masked is not None:
        s = s.masked_fill(masked, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    ex = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + ex.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.matmul(ex, vv.float())
    return m_new, l_new, acc_new


class _Enter(torch.autograd.Function):
    """q, k and v as every process holds them; the backward sums their
    gradients over the processes in process order."""

    @staticmethod
    def forward(ctx, q, k, v):
        return q.view_as(q), k.view_as(k), v.view_as(v)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        return tuple(distributed.all_reduce_ordered([torch.stack([gq, gk, gv])]).unbind(0))


class _Hop(torch.autograd.Function):
    """This process's last K/V block to the next process, the previous
    one's into this process's first position; backward, the gradients
    one hop back."""

    @staticmethod
    def forward(ctx, dst, src, k, v):
        ctx.dst, ctx.src = dst, src
        return tuple(distributed.hop([k, v], dst, src))

    @staticmethod
    def backward(ctx, gk, gv):
        return (None, None, *distributed.hop([gk, gv], ctx.src, ctx.dst))


def axis_positions(grid: Grid, axis: str):
    """(the axis's devices, their owners, this process's positions on it)
    along ``axis`` through shard (0, 0); in one process every position is
    its own. Over processes, raises where a process holds no position on
    the axis."""
    devices, line = grid.axis(axis), grid.line(axis, 0)
    owners = [grid.owners[s] for s in line]
    if set(owners) != set(grid.owners):
        raise ValueError(
            f"the {axis} axis of {grid!r} holds shards of processes {sorted(set(owners))} only: "
            "across processes it must hold positions of every process"
        )
    return devices, owners, [r for r, s in enumerate(line) if grid.is_local(s)]


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Sequence,
    axis: str = AXIS_DATA,
    causal: bool = False,
) -> torch.Tensor:
    """(B, H, S, Dh) attention with S sharded over ``mesh``'s ``axis``;
    returns (B, H, S, Dh) in q's dtype on the axis's first device (over
    processes, in every process on its first position's device). S must
    divide by the axis size, and q, k and v must have one length."""
    grid = as_grid(mesh)
    devices, owners, mine = axis_positions(grid, axis)
    p = len(devices)
    b, h, s_len, d = q.shape
    if s_len % p:
        raise ValueError(f"seq len {s_len} not divisible by ring size {p}")
    if k.shape[2] != s_len or v.shape[2] != s_len:
        raise ValueError(f"q/k/v seq lens must match: {s_len}/{k.shape[2]}/{v.shape[2]}")
    across = grid.spans_processes
    if across:
        q, k, v = _Enter.apply(q, k, v)
    s_loc = s_len // p

    def block(t, r):
        return t[:, :, r * s_loc : (r + 1) * s_loc].to(devices[r], non_blocking=True)

    qf = [block(q, r).float() * d**-0.5 for r in mine]
    kk = [block(k, r) for r in mine]
    vv = [block(v, r) for r in mine]
    local = [torch.arange(s_loc, device=devices[r]) for r in mine]
    m = [torch.full((b, h, s_loc, 1), NEG_INF, dtype=torch.float32, device=devices[r]) for r in mine]
    l = [torch.zeros((b, h, s_loc, 1), dtype=torch.float32, device=devices[r]) for r in mine]
    acc = [torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=devices[r]) for r in mine]
    for i in range(p):
        for j, r in enumerate(mine):
            src = (r - i) % p  # the shard whose K/V block position r holds
            # by global positions: key src * s_loc + j is hidden from query r * s_loc + i past it
            masked = (src * s_loc + local[j])[None, :] > (r * s_loc + local[j])[:, None] if causal else None
            m[j], l[j], acc[j] = _hop(qf[j], kk[j], vv[j], m[j], l[j], acc[j], masked)
        if i + 1 < p:  # the last hop's rotation would carry nothing used
            # this process's first position takes the block before it: its
            # own last one, or over processes the previous process's
            head_k, head_v = kk[-1], vv[-1]
            if across:
                nxt, prv = owners[(mine[-1] + 1) % p], owners[(mine[0] - 1) % p]
                head_k, head_v = _Hop.apply(nxt, prv, head_k, head_v)
            kk = [(head_k if j == 0 else kk[j - 1]).to(devices[r], non_blocking=True) for j, r in enumerate(mine)]
            vv = [(head_v if j == 0 else vv[j - 1]).to(devices[r], non_blocking=True) for j, r in enumerate(mine)]
    out = [(acc[j] / torch.clamp(l[j], min=1e-30)).to(q.dtype) for j in range(len(mine))]
    return gather(out, devices[mine[0]], dim=2, group=torch.distributed.group.WORLD if across else None)
