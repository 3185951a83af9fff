"""W8A8 int8 primitives: static per-channel weights, dynamic per-row
activations.

Counterpart of ``imatch_tpu/ops/quant.py``. The activation quantizes are
K3 (``quant_rows_int8``) and K4 (``ln_quant_rows_int8``): on the card they
always launch the CUDA kernels, on the CPU they run the kernels' plain
versions (ops/kernels/quantize.py), which follow the Pallas kernels'
numerics. The JAX package's ``IMATCH_QUANT_KERNEL`` switch between its
Pallas kernels and an XLA composition has no counterpart: the two agree
to one LSB (tests/test_quant_kernel.py), and tests/test_torch_quant.py
holds the port to both.

The int8 x int8 -> int32 contraction is a plain matrix product outside
any kernel of the JAX package (an XLA ``dot_general`` there), so it goes
to ``torch._int_mm`` here.
"""

from __future__ import annotations

from typing import Optional

import torch

# The activation quantizes are the kernels' wrappers themselves, under
# the JAX package's names: quant_rows_int8(x) -> (int8, fp32 scale) is K3,
# ln_quant_rows_int8(x, weight, bias, eps) is K4.
from imatch_tpu_torch.ops.kernels.quantize import (  # noqa: F401
    ln_quant_rows as ln_quant_rows_int8,
    quant_rows as quant_rows_int8,
)


def quantize_weight_int8(w: torch.Tensor) -> dict:
    """Per-output-channel symmetric int8 of a ``(..., D_in, D_out)``
    weight: the scale runs over the contraction axis (-2). Returns
    ``{"q": int8 of w's shape, "s": fp32 with axis -2 squeezed out}``,
    bit-identical to the JAX function on fp32 weights (true divisions of
    two tensors, which a division by a Python number is not on the card;
    round half to even)."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), 1.0)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.squeeze(-2)}


def qdot_int8(
    xi: torch.Tensor,
    ascale: torch.Tensor,
    wq: torch.Tensor,
    wscale: torch.Tensor,
    bias: Optional[torch.Tensor],
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """int8 ``xi (..., D_in)`` x int8 ``wq (D_in, D_out)`` -> int32, then
    the JAX dequant order exactly: ``((acc * ascale) * wscale)`` in fp32,
    cast to ``out_dtype``, then ``+ bias`` in ``out_dtype`` (at bf16
    another order rounds differently). ``wq`` may be the transpose of a
    row-major ``(D_out, D_in)`` buffer, the layout the int8 GEMM takes."""
    lead = xi.shape[:-1]
    acc = torch._int_mm(xi.reshape(-1, xi.shape[-1]), wq)
    y = ((acc.float() * ascale.reshape(-1, 1)) * wscale).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y.reshape(*lead, wq.shape[1])
