"""K5: tile-max scoring over an int4 corpus — the CUDA kernel's wrapper,
its plain PyTorch version and the packing.

Replaces ``scripts/exp_int4_kernel.py::_int4_tile_max_kernel`` (launched
by ``int4_tile_max`` there), an experiment for a 4-bit capacity tier; its
only caller is that script and its port,
``imatch_tpu_torch/scripts/exp_int4_kernel.py``. The kernel is
``csrc/int4_tile_max.cu``; its header says what bounds it on the H100 and
how the design answers.

The layout is the script's, so the two compare like with like:
``pack_int4`` quantizes each row to codes in [-7, 7] and packs them in
halves, byte b of a row holding feature b in its low nibble and feature
b + D/2 in its high nibble; the side array is (8, N) bf16 with the per-row
scale in row 0 and the validity in row 1. ``int4_tile_max(queries, packed,
side, tile_n)`` returns the (Q, n_tiles) fp32 maxima over each tile's valid
rows of ``(queries . codes) * scale``, fp32 accumulation from bf16 queries.

CUDA tensors launch the kernel; CPU tensors use ``int4_tile_max_plain``.
On a CUDA tensor the wrapper checks device, dtype, shape and contiguity
and raises rather than falls back. ``int4_tile_max.launches`` counts
launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from imatch_tpu_torch.ops.kernels import _build
from imatch_tpu_torch.ops.kernels.topk import _same_device_contiguous

NEG_INF = -3.0e38
_NAME = "int4_tile_max"
# the script's pack_int4 runs under jit, where XLA folds ``amax / 7.0``
# into a multiply by the fp32 constant 1/7
_INV7 = float(np.float32(1.0 / 7.0))


def pack_int4(
    corpus: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, D) fp32 rows and (N,) validity -> packed (N, D/2) int8, side
    (8, N) bf16 (row 0 scale, row 1 validity), the int4 codes (N, D) as
    int8 and the fp32 scales (N,): the script's ``pack_int4``, bit for
    bit."""
    half = corpus.shape[1] // 2
    amax = corpus.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax * _INV7, 1.0)
    q = torch.clamp(torch.round(corpus / scale[:, None]), -7, 7).to(torch.int8)
    packed = (q[:, :half] & 15) | (q[:, half:] << 4)
    side = torch.zeros((8, corpus.shape[0]), dtype=torch.bfloat16, device=corpus.device)
    side[0] = scale.to(torch.bfloat16)
    side[1] = valid.to(torch.bfloat16)
    return packed, side, q, scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """The (N, D) int32 codes of a halves-packed (N, D/2) corpus: each byte
    sign-extended, the low nibble ``(b << 28) >> 28``, the high ``b >> 4``
    (the script's in-kernel unpack)."""
    p = packed.to(torch.int32)
    return torch.cat([(p << 28) >> 28, p >> 4], dim=1)


def int4_tile_max_plain(
    queries: torch.Tensor, packed: torch.Tensor, side: torch.Tensor, tile_n: int
) -> torch.Tensor:
    """Reference: the full (Q, N) fp32 scores of bf16 queries against the
    unpacked codes (exact products), times each row's scale, masked where
    ``side[1] <= 0``, max per tile. Only the order of the fp32 sums
    differs from the kernel."""
    n_tiles = packed.shape[0] // tile_n
    s = torch.matmul(queries.float(), unpack_int4(packed).float().T)
    s = s * side[0].float()[None, :]
    s = torch.where(side[1].float()[None, :] > 0, s, NEG_INF)
    return s.reshape(queries.shape[0], n_tiles, tile_n).amax(dim=2)


def _lib():
    lib = _build.load(_NAME)
    fn = lib.int4_tile_max
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(queries, packed, side, tile_n):
    if queries.ndim != 2 or packed.ndim != 2 or side.ndim != 2:
        raise ValueError("expected queries (Q, D), packed (N, D/2), side (8, N)")
    n, h = packed.shape
    if queries.shape[1] != 2 * h:
        raise ValueError(f"query dim {queries.shape[1]} != 2 x packed width {h}")
    if h % 16:
        raise ValueError("the packed width must be a multiple of 16 (16-byte rows)")
    if queries.dtype != torch.bfloat16 or side.dtype != torch.bfloat16:
        raise TypeError(f"queries and side must be bfloat16, got {queries.dtype}, {side.dtype}")
    if packed.dtype != torch.int8:
        raise TypeError(f"packed must be int8, got {packed.dtype}")
    if side.shape != (8, n):
        raise ValueError(f"side must be (8, {n}), got {tuple(side.shape)}")
    if tile_n <= 0 or n % tile_n:
        raise ValueError(f"corpus rows {n} not a multiple of {tile_n}")
    _same_device_contiguous(packed, queries=queries, packed=packed, side=side)


def int4_tile_max(
    queries: torch.Tensor, packed: torch.Tensor, side: torch.Tensor, tile_n: int
) -> torch.Tensor:
    """(Q, n_tiles) fp32 tile maxima; see the module docstring."""
    if packed.device.type == "cpu":
        return int4_tile_max_plain(queries, packed, side, tile_n)
    if packed.device.type != "cuda":
        raise ValueError(f"int4_tile_max runs on cuda or cpu, not {packed.device}")
    _check(queries, packed, side, tile_n)
    n = packed.shape[0]
    out = torch.empty((queries.shape[0], n // tile_n), dtype=torch.float32, device=packed.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        rc = lib.int4_tile_max(
            queries.data_ptr(),
            packed.data_ptr(),
            side.data_ptr(),
            out.data_ptr(),
            queries.shape[0],
            packed.shape[1],
            n,
            tile_n,
            stream,
        )
    _build.check(lib, _NAME, rc)
    int4_tile_max.launches += 1
    return out


int4_tile_max.launches = 0
