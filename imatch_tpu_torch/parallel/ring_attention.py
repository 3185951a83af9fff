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
"""

from __future__ import annotations

from typing import Sequence

import torch

from imatch_tpu_torch.ops.collectives import gather
from imatch_tpu_torch.parallel.mesh import AXIS_DATA, as_grid

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
    returns (B, H, S, Dh) in q's dtype on the axis's first device. S must
    divide by the axis size, and q, k and v must have one length."""
    devices = as_grid(mesh).axis(axis)
    p = len(devices)
    s_len = q.shape[2]
    if s_len % p:
        raise ValueError(f"seq len {s_len} not divisible by ring size {p}")
    if k.shape[2] != s_len or v.shape[2] != s_len:
        raise ValueError(f"q/k/v seq lens must match: {s_len}/{k.shape[2]}/{v.shape[2]}")
    b, h, _, d = q.shape
    s_loc = s_len // p
    scale = d**-0.5

    def block(t, r):
        return t[:, :, r * s_loc : (r + 1) * s_loc].to(devices[r], non_blocking=True)

    qf = [block(q, r).float() * scale for r in range(p)]
    kk = [block(k, r) for r in range(p)]
    vv = [block(v, r) for r in range(p)]
    local = [torch.arange(s_loc, device=dev) for dev in devices]
    m = [torch.full((b, h, s_loc, 1), NEG_INF, dtype=torch.float32, device=dev) for dev in devices]
    l = [torch.zeros((b, h, s_loc, 1), dtype=torch.float32, device=dev) for dev in devices]
    acc = [torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=dev) for dev in devices]
    for i in range(p):
        for r in range(p):
            src = (r - i) % p  # the shard whose K/V block device r holds
            # by global positions: key src * s_loc + j is hidden from query r * s_loc + i past it
            masked = (src * s_loc + local[r])[None, :] > (r * s_loc + local[r])[:, None] if causal else None
            m[r], l[r], acc[r] = _hop(qf[r], kk[r], vv[r], m[r], l[r], acc[r], masked)
        if i + 1 < p:  # the last hop's rotation would carry nothing used
            kk = [kk[(r - 1) % p].to(devices[r], non_blocking=True) for r in range(p)]
            vv = [vv[(r - 1) % p].to(devices[r], non_blocking=True) for r in range(p)]
    out = [(acc[r] / torch.clamp(l[r], min=1e-30)).to(q.dtype) for r in range(p)]
    return gather(out, devices[0], dim=2)
