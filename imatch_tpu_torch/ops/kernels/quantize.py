"""K3 (row quantize) and K4 (LayerNorm + row quantize) — the CUDA
kernels' wrappers and their plain PyTorch versions.

Replace ``imatch_tpu/ops/pallas/quantize.py::_quant_kernel`` (entry
``quant_rows_pallas``) and ``::_ln_quant_kernel`` (entry
``ln_quant_rows_pallas``). The kernels are ``csrc/quantize.cu``; its
header says what bounds them on the H100 and how the design answers.

Contract (the Pallas kernels'): x ``(..., D)`` in float32 or bfloat16,
math in fp32; per row amax, ``scale = amax / 127`` (1 for a zero row) and
codes ``clip(round_half_even(y * (127 / amax)), -127, 127)`` as int8, with
``y = x`` (K3) or ``y`` the fp32 LayerNorm of x with gamma and beta (K4,
``var = mean((x - mean)^2)``). Returns int8 ``(..., D)`` and an fp32
``(..., 1)`` scale.

``quant_rows`` and ``ln_quant_rows`` launch the kernel for CUDA tensors
and use the plain versions only for CPU tensors. On a CUDA tensor they
check device, dtype, contiguity, alignment and D (a multiple of 8) and
raise rather than fall back. ``quant_rows.launches`` and
``ln_quant_rows.launches`` count launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from imatch_tpu_torch.ops.kernels import _build

_NAME = "quantize"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_VECTORS = 8192  # 16-byte vectors a row: 1024 threads x 8 (csrc/quantize.cu)


def _quantize(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Pallas ``_quantize`` epilogue on fp32 rows: a reciprocal
    multiply, not a divide; ``torch.round`` rounds half to even. Both
    divisions are true divisions of two tensors: ``127.0 / t`` is
    ``t.reciprocal() * 127`` and, on the card, ``t / 127.0`` is
    ``t * (1 / 127)``, two roundings each."""
    amax = y.abs().amax(dim=-1, keepdim=True)
    nonzero = amax > 0
    c127 = torch.full_like(amax, 127.0)
    scale = torch.where(nonzero, amax / c127, 1.0)
    inv = torch.where(nonzero, c127 / amax, 1.0)
    q = torch.clamp(torch.round(y * inv), -127, 127).to(torch.int8)
    return q, scale


def quant_rows_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function in PyTorch: per-row symmetric int8 of x (..., D)."""
    return _quantize(x.float())


def ln_quant_rows_plain(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's function in PyTorch: fp32 LayerNorm, then K3's quantize."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    xc = x - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return _quantize(y * gamma.float() + beta.float())


def _lib():
    lib = _build.load(_NAME)
    fn = lib.quant_rows
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, gamma, beta) -> None:
    if x.ndim < 1:
        raise ValueError("expected x of shape (..., D)")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the quantize kernels take float32 or bfloat16, got {x.dtype}")
    d = x.shape[-1]
    if d % 8:
        raise ValueError(f"the row length must be a multiple of 8, got {d}")
    if d * x.element_size() // 16 > _MAX_VECTORS:
        raise ValueError(f"a row of {d} {x.dtype} exceeds the kernel's {_MAX_VECTORS} vectors")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.shape != (d,):
            raise ValueError(f"{name} must be float32 of shape ({d},), got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(x, gamma, beta, eps):
    """One launch of K3 (gamma None) or K4 on CUDA tensors."""
    _check(x, gamma, beta)
    d = x.shape[-1]
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return q, scale
    if rows >= 1 << 31:
        raise ValueError(f"{rows} rows exceed the kernel's grid")
    lib = _lib()
    ln = gamma is not None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.quant_rows(
            x.data_ptr(),
            gamma.data_ptr() if ln else None,
            beta.data_ptr() if ln else None,
            q.data_ptr(),
            scale.data_ptr(),
            _DTYPES[x.dtype],
            int(ln),
            rows,
            d,
            float(eps),
            stream,
        )
    _build.check(lib, _NAME, rc)
    if ln:
        ln_quant_rows.launches += 1
    else:
        quant_rows.launches += 1
    return q, scale


def _device(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    return x.device.type


def quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (int8 (..., D), fp32 scale (..., 1)); see the module docstring."""
    if _device(x, "quant_rows") == "cpu":
        return quant_rows_plain(x)
    return _launch(x, None, None, 0.0)


def ln_quant_rows(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: LayerNorm(x; gamma, beta, eps) quantized per row."""
    if _device(x, "ln_quant_rows") == "cpu":
        return ln_quant_rows_plain(x, gamma, beta, eps)
    return _launch(x, gamma, beta, eps)


quant_rows.launches = 0
ln_quant_rows.launches = 0
