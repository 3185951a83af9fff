"""K6: tile-max scoring over a corpus stored transposed — the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces ``scripts/exp_pallas_search.py::_tile_max_kernel_T`` (launched by
``phase1_transposed`` there), the transposed-layout variant of K1 that
experiment measures; its only caller is that script and its port,
``imatch_tpu_torch/scripts/exp_pallas_search.py``. The kernel is
``csrc/tile_max_t.cu``; its header says what bounds it on the H100 and how
the design answers.

``tile_max_t(queries, corpus_t, tile_n)`` takes (Q, Dp) bf16 queries and a
(Dp, N) bf16 corpus and returns the (Q, N / tile_n) fp32 maxima over each
tile of columns of the query-column dot products, fp32 accumulation. There
is no mask operand: as in the script, validity rides in a penalty feature
row (the query has 1 there, an invalid column -4). ``tile_n`` is a multiple
of 256 that divides 2048 or a multiple of 2048 (the script uses 1024, 2048
and 4096).

CUDA tensors launch the kernel; CPU tensors use ``tile_max_t_plain``. On a
CUDA tensor the wrapper checks device, dtype, shape and contiguity and
raises rather than falls back. ``tile_max_t.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from imatch_tpu_torch.ops.kernels import _build
from imatch_tpu_torch.ops.kernels.topk import _same_device_contiguous

_NAME = "tile_max_t"
_SPAN = 2048  # corpus columns a block covers in one pass (csrc/tile_max_t.cu)


def tile_max_t_plain(queries: torch.Tensor, corpus_t: torch.Tensor, tile_n: int) -> torch.Tensor:
    """Reference: the full (Q, N) fp32 score matrix, max per tile. bf16
    operands upcast exactly, so only the summation order differs from the
    kernel."""
    n_tiles = corpus_t.shape[1] // tile_n
    s = torch.matmul(queries.float(), corpus_t.float())
    return s.reshape(queries.shape[0], n_tiles, tile_n).amax(dim=2)


def _lib():
    lib = _build.load(_NAME)
    fn = lib.tile_max_t
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(queries, corpus_t, tile_n):
    if queries.ndim != 2 or corpus_t.ndim != 2 or queries.shape[1] != corpus_t.shape[0]:
        raise ValueError("expected queries (Q, Dp) and a transposed corpus (Dp, N)")
    if queries.dtype != torch.bfloat16 or corpus_t.dtype != torch.bfloat16:
        raise TypeError(f"tile_max_t takes bfloat16, got {queries.dtype} and {corpus_t.dtype}")
    n = corpus_t.shape[1]
    if tile_n <= 0 or tile_n % 256 or (_SPAN % tile_n if tile_n < _SPAN else tile_n % _SPAN):
        raise ValueError(
            f"tile_n {tile_n} must be a multiple of 256 that divides {_SPAN} or a multiple of {_SPAN}"
        )
    if n % tile_n:
        raise ValueError(f"corpus columns {n} not a multiple of {tile_n}")
    _same_device_contiguous(corpus_t, queries=queries, corpus_t=corpus_t)


def tile_max_t(queries: torch.Tensor, corpus_t: torch.Tensor, tile_n: int) -> torch.Tensor:
    """(Q, n_tiles) fp32 tile maxima; see the module docstring."""
    if corpus_t.device.type == "cpu":
        return tile_max_t_plain(queries, corpus_t, tile_n)
    if corpus_t.device.type != "cuda":
        raise ValueError(f"tile_max_t runs on cuda or cpu, not {corpus_t.device}")
    _check(queries, corpus_t, tile_n)
    dp, n = corpus_t.shape
    out = torch.empty((queries.shape[0], n // tile_n), dtype=torch.float32, device=corpus_t.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(corpus_t.device):
        stream = torch.cuda.current_stream(corpus_t.device).cuda_stream
        rc = lib.tile_max_t(
            queries.data_ptr(),
            corpus_t.data_ptr(),
            out.data_ptr(),
            queries.shape[0],
            dp,
            n,
            tile_n,
            stream,
        )
    _build.check(lib, _NAME, rc)
    tile_max_t.launches += 1
    return out


tile_max_t.launches = 0
