"""Multi-head attention for the encoder towers.

Counterpart of ``imatch_tpu/ops/attention.py`` (``mha``, ``_mha_xla``).
The JAX package sends CLIP's short sequences (S <= 257) to XLA; the port
sends every sequence to K2, the CUDA flash-attention kernel, which
computes exactly ``_mha_xla``'s function (fp32 logits and softmax,
optional causal mask). The dispatch is by device and lives in the
kernel's wrapper: a CUDA tensor launches K2, a CPU tensor runs its plain
PyTorch version. There is no fallback on the card: a head dim the kernel
does not take raises there.
"""

from __future__ import annotations

import torch

from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha


def mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False
) -> torch.Tensor:
    """Scaled dot-product attention over (B, H, S, Dh) tensors; returns
    (B, H, S, Dh) in q's dtype."""
    return flash_mha(q, k, v, causal=causal)
