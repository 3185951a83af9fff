"""K1: tile-max scoring (phase 1 of the exact top-k) — the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces ``imatch_tpu/ops/pallas/topk.py::_tile_max_kernel`` (launched by
``_query_prepared``), which is also the math of the XLA phase 1 in
``index/search.py::_tilemax_topk``. The kernel is ``csrc/tile_max.cu``;
its header says what bounds it on the H100 and how the design answers.

``tile_max(queries, scoring, valid, tile_n)`` returns the ``(Q, n_tiles)``
fp32 maxima over each tile's valid rows of the query-row dot products,
accumulated in fp32 from bf16 or fp32 operands; a tile with no valid row
is ``NEG_INF``. Validity is a mask (one byte a row), not the Pallas
kernel's penalty column: that column existed only because Mosaic could not
lower a (1, tile_n) mask operand, and phase 2 (index/search.py) selects
the same tiles either way (tests/test_torch_topk.py holds the results to
``pallas_cosine_topk``'s).

CUDA tensors launch the kernel; CPU tensors use ``tile_max_plain``. On a
CUDA tensor the wrapper checks device, dtype, shape and contiguity and
raises rather than falls back. ``tile_max.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from imatch_tpu_torch.ops.kernels import _build

NEG_INF = -3.0e38
_NAME = "tile_max"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tile_max_plain(
    queries: torch.Tensor, scoring: torch.Tensor, valid: torch.Tensor, tile_n: int
) -> torch.Tensor:
    """Reference: the full (Q, N) fp32 score matrix, masked, max per tile.
    bf16 operands upcast exactly, so only the summation order differs
    from the kernel."""
    n_tiles = scoring.shape[0] // tile_n
    s = torch.matmul(queries.float(), scoring.float().T)
    s = torch.where(valid[None, :], s, NEG_INF)
    return s.reshape(queries.shape[0], n_tiles, tile_n).amax(dim=2)


def _lib():
    lib = _build.load(_NAME)
    fn = lib.tile_max
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def _check(queries, scoring, valid, tile_n):
    if queries.ndim != 2 or scoring.ndim != 2 or valid.ndim != 1:
        raise ValueError("expected queries (Q, D), scoring (N, D), valid (N,)")
    if queries.shape[1] != scoring.shape[1]:
        raise ValueError(
            f"query dim {queries.shape[1]} != corpus dim {scoring.shape[1]}"
        )
    if scoring.dtype not in _DTYPES or queries.dtype != scoring.dtype:
        raise TypeError(
            f"tile_max takes float32 or bfloat16 queries and corpus of one "
            f"dtype, got {queries.dtype} and {scoring.dtype}"
        )
    if valid.dtype != torch.bool or valid.shape[0] != scoring.shape[0]:
        raise ValueError("valid must be a bool mask with one entry a corpus row")
    if tile_n <= 0 or scoring.shape[0] % tile_n:
        raise ValueError(f"corpus rows {scoring.shape[0]} not a multiple of {tile_n}")
    if scoring.shape[1] % 8:
        raise ValueError("the corpus dim must be a multiple of 8 (16-byte rows)")
    for name, t in (("queries", queries), ("scoring", scoring), ("valid", valid)):
        if t.device != scoring.device:
            raise ValueError(f"{name} is on {t.device}, the corpus on {scoring.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def tile_max(
    queries: torch.Tensor, scoring: torch.Tensor, valid: torch.Tensor, tile_n: int
) -> torch.Tensor:
    """(Q, n_tiles) fp32 tile maxima; see the module docstring."""
    if scoring.device.type == "cpu":
        return tile_max_plain(queries, scoring, valid, tile_n)
    if scoring.device.type != "cuda":
        raise ValueError(f"tile_max runs on cuda or cpu, not {scoring.device}")
    _check(queries, scoring, valid, tile_n)
    n_tiles = scoring.shape[0] // tile_n
    out = torch.empty(
        (queries.shape[0], n_tiles), dtype=torch.float32, device=scoring.device
    )
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(scoring.device):
        stream = torch.cuda.current_stream(scoring.device).cuda_stream
        rc = lib.tile_max(
            queries.data_ptr(),
            scoring.data_ptr(),
            valid.data_ptr(),
            out.data_ptr(),
            _DTYPES[scoring.dtype],
            queries.shape[0],
            scoring.shape[1],
            tile_n,
            n_tiles,
            stream,
        )
    _build.check(lib, _NAME, rc)
    tile_max.launches += 1
    return out


tile_max.launches = 0
