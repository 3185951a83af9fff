"""Multi-head attention for the encoder towers.

Counterpart of ``imatch_tpu/ops/attention.py`` (``mha``, ``_mha_xla``).
Serving (``impl="auto"`` or ``"kernel"``) sends every sequence to K2, the
CUDA flash-attention kernel, which computes ``_mha_xla``'s fp32 function
(fp32 logits and softmax, optional causal mask). The dispatch is by device
and lives in the kernel's wrapper: a CUDA tensor launches K2, a CPU tensor
runs its plain PyTorch version. There is no fallback on the card: a head
dim the kernel does not take raises there.

K2 has no backward, as the Pallas kernel has no VJP: the JAX package
trains through ``_mha_xla`` (every CLIP tower has S <= 512), and so does
the port. ``impl="xla"`` takes ``mha_xla``, the same computation written
in plain PyTorch ops that autograd differentiates, with ``_mha_xla``'s
rounding steps at bf16. K2's wrapper raises on a CUDA input that requires
grad, so a training forward cannot reach it by mistake.
"""

from __future__ import annotations

import torch

from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha

IMPLS = ("auto", "kernel", "xla")


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """Scaled dot-product attention over (B, H, S, Dh) tensors; returns
    (B, H, S, Dh) in q's dtype. ``impl``: "auto" or "kernel" (K2), or
    "xla" (``mha_xla``, the training path)."""
    if impl == "xla":
        return mha_xla(q, k, v, causal=causal)
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}: expected one of {IMPLS}")
    return flash_mha(q, k, v, causal=causal)


def _causal_mask(s: int, device) -> torch.Tensor:
    return torch.ones((s, s), dtype=torch.bool, device=device).tril()


def _round(x: float, dtype: torch.dtype) -> float:
    return torch.tensor(x, dtype=dtype).item()


def mha_xla(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False
) -> torch.Tensor:
    """``_mha_xla``: the full (B, H, S, S) logits. fp32 inputs: fp32 logits
    times Dh^-0.5, a ``finfo(float32).min`` causal mask, softmax, fp32
    probabilities times V. bf16 inputs: bf16 logits scaled by
    ``bf16(scale)``, a ``bf16(-3e38)`` mask, ``exp(logits - max)`` in fp32
    cast to bf16, an fp32 denominator cast to bf16, the bf16 divide, and
    P @ V accumulated in fp32 and cast to bf16."""
    dtype = q.dtype
    s = q.shape[-2]
    scale = q.shape[-1] ** -0.5
    if dtype == torch.float32:
        logits = torch.matmul(q, k.transpose(-1, -2)) * scale
        if causal:
            logits = logits.masked_fill(
                ~_causal_mask(s, q.device), torch.finfo(torch.float32).min
            )
        probs = torch.softmax(logits, dim=-1)
        return torch.matmul(probs, v)
    # python floats holding the bf16 values: a product of two bf16 numbers
    # is exact in the fp32 that PyTorch computes it in before rounding
    logits = torch.matmul(q, k.transpose(-1, -2)) * _round(scale, dtype)
    if causal:
        logits = logits.masked_fill(~_causal_mask(s, q.device), _round(-3e38, dtype))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp((logits - m).float()).to(dtype)
    denom = p.float().sum(dim=-1, keepdim=True)
    p = p / denom.to(dtype)
    return torch.matmul(p, v)
