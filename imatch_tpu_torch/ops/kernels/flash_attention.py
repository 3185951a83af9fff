"""K2: flash-attention forward — the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``imatch_tpu/ops/pallas/flash_attention.py::_flash_kernel``
(launched by ``flash_mha``). The kernel is ``csrc/flash_attention.cu``;
its header says what bounds it on the H100 and how the design answers.

Contract (the same as the Pallas kernel's): ``(B, H, S, Dh)`` q, k, v in
float32 or bfloat16; ``Dh ** -0.5`` applied in fp32; fp32 online softmax
and accumulation; optional causal mask; keys at or past ``kv_len``
(default S) are masked; a row with no visible key is 0; the output is in
q's dtype. fp32 runs on the CUDA cores (no TF32: the fidelity path); bf16
runs on the tensor cores with fp32 logits and accumulators, the
probabilities rounded to bf16 before ``P @ V`` (at most 2^-9 relative
each, inside the bf16 bar the tests hold it to).

``flash_mha`` launches the kernel for CUDA tensors and uses
``flash_mha_plain`` only for CPU tensors. On a CUDA tensor it checks
device, dtype, shape and layout and raises on anything the kernel does
not take (head dims that are not a multiple of 8 in [8, 128], a head dim
that is not contiguous; for bf16, rows that do not start 16-byte aligned,
since the kernel copies them 16 bytes at a time); it never falls back.
``flash_mha.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from imatch_tpu_torch.ops.kernels import _build

_NAME = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_mha_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Full-logits attention with the kernel's contract: fp32 logits and
    softmax, the same masking, 0 for rows with no visible key."""
    s, dh = q.shape[-2], q.shape[-1]
    kv_len = s if kv_len is None else kv_len
    q32 = q.float() * (dh**-0.5)
    logits = torch.matmul(q32, k.float().transpose(-1, -2))
    pos = torch.arange(s, device=q.device)
    visible = (pos < kv_len)[None, :].expand(s, s)
    if causal:
        visible = visible & (pos[None, :] <= pos[:, None])
    logits = logits.masked_fill(~visible, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # softmax of an all -inf row is NaN; such a row writes 0
    probs = torch.where(visible.any(-1, keepdim=True), probs, 0.0)
    return torch.matmul(probs, v.float()).to(q.dtype)


def _lib():
    lib = _build.load(_NAME)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 7
            + [ctypes.c_void_p, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, kv_len):
    if q.ndim != 4:
        raise ValueError(f"expected (B, H, S, Dh) tensors, got q {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash attention takes float32 or bfloat16 q, k, v of one "
            f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on the same device")
    dh = q.shape[-1]
    if dh % 8 or not 8 <= dh <= 128:
        raise ValueError(
            f"the CUDA flash-attention kernel takes head dims that are "
            f"multiples of 8 in [8, 128], got {dh}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    if q.dtype == torch.bfloat16:
        # The bf16 kernel copies rows 16 bytes at a time: every base pointer
        # a multiple of 16 bytes, every stride of a dim it steps along a
        # multiple of 8 elements (bitwise or: this runs at every launch).
        sq, sk, sv = q.stride(), k.stride(), v.stride()
        steps = 0
        for i in range(3):
            if q.shape[i] > 1:
                steps |= sq[i] | sk[i] | sv[i]
        if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 or steps % 8:
            raise ValueError("bf16 q, k and v rows must start 16-byte aligned")
    if not 0 <= kv_len <= q.shape[-2]:
        raise ValueError(f"kv_len {kv_len} outside [0, {q.shape[-2]}]")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError("B * H above 65535 exceeds the kernel's grid")


def flash_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """(B, H, S, Dh) attention. CUDA tensors run the kernel (strided
    inputs are read in place as long as the head dim is contiguous; the
    output's memory is laid out (B, S, H, Dh), so merging the heads back
    is free); CPU tensors run ``flash_mha_plain``."""
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, causal=causal, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    b, h, s, dh = q.shape
    kv_len = s if kv_len is None else kv_len
    _check(q, k, v, kv_len)
    # (B, H, S, Dh) over (B, S, H, Dh) memory
    ostrides = (s * h * dh, dh, h * dh)
    out = torch.empty_strided((b, h, s, dh), (*ostrides, 1), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *ostrides
    )
    lib = _lib()
    dev = q.get_device()
    # The B=1 towers are bound by the host's launch rate, so the launch
    # takes the stream's raw handle (no Stream object) and enters q's
    # device only when it is not the current one.
    args = (
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
        _DTYPES[q.dtype],
        b,
        h,
        s,
        dh,
        kv_len,
        int(causal),
        ctypes.cast(strides, ctypes.c_void_p),
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if dev == torch.cuda.current_device():
        rc = lib.flash_attention_fwd(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.flash_attention_fwd(*args)
    _build.check(lib, _NAME, rc)
    flash_mha.launches += 1
    return out


flash_mha.launches = 0
