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

``tile_max_int8(qi, codes, qscale, scale, valid, tile_n)`` is the int8
variant, phase 1 of the int8 score tier and the tilemax-host tier: the
math of ``imatch_tpu/index/search.py::_int8_scores`` (XLA in JAX), int8
query and corpus codes with a per-query and a per-row fp32 scale, the dot
accumulated exactly as an integer, then ``(dot * qscale) * scale``, masked,
max per tile. It is bit-identical to ``tile_max_int8_plain``.

CUDA tensors launch the kernel; CPU tensors use the plain versions. On a
CUDA tensor the wrappers check device, dtype, shape, contiguity and
16-byte alignment and raise rather than fall back. bf16 at Q >= 2 runs on
the tensor cores (``tile_max_mma_kernel``), fp32 at Q >= 2 on a
register-blocked CUDA-core product (``tile_max_fp32_kernel``), Q = 1 in
either dtype on the CUDA cores (``tile_max_kernel``); none of them asks
more of its inputs than before. ``tile_max.launches`` and
``tile_max_int8.launches`` count the launches of each variant;
``tile_max.mma_launches`` and ``tile_max.fp32_mq_launches`` count those of
``tile_max``'s that went to the tensor-core kernel and to the fp32
multi-query kernel.
"""

from __future__ import annotations

import ctypes

import torch

from imatch_tpu_torch.ops.kernels import _build

NEG_INF = -3.0e38
_NAME = "tile_max"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# int8 dots of up to this many terms are integers below 2^24 (D * 127^2),
# so an fp32 product computes them exactly in any summation order
FP32_EXACT_DIM = (1 << 24) // (127 * 127)


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


def int8_dot_scores(
    qi: torch.Tensor, codes: torch.Tensor, qscale: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """(Q, N) fp32 ``((qi . codes) * qscale) * scale``, the integer dot
    exact: an fp32 product while D * 127^2 < 2^24, fp64 past it. (CUDA has
    no int32 matmul, and an int8 matmul on the CPU overflows in int8.)"""
    wide = torch.float32 if codes.shape[1] <= FP32_EXACT_DIM else torch.float64
    dots = torch.matmul(qi.to(wide), codes.to(wide).T).float()
    return dots * qscale[:, None] * scale[None, :]


def tile_max_int8_plain(
    qi: torch.Tensor,
    codes: torch.Tensor,
    qscale: torch.Tensor,
    scale: torch.Tensor,
    valid: torch.Tensor,
    tile_n: int,
) -> torch.Tensor:
    """Reference of the int8 variant: dequantized scores, masked, max per
    tile. Every step rounds as the kernel does, so the two agree bit for
    bit."""
    n_tiles = codes.shape[0] // tile_n
    s = int8_dot_scores(qi, codes, qscale, scale)
    s = torch.where(valid[None, :], s, NEG_INF)
    return s.reshape(qi.shape[0], n_tiles, tile_n).amax(dim=2)


def _lib():
    lib = _build.load(_NAME)
    fn = lib.tile_max
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.tile_max_int8.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        lib.tile_max_int8.restype = ctypes.c_int
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
    _same_device_contiguous(scoring, queries=queries, scoring=scoring, valid=valid)
    if queries.data_ptr() % 16 or scoring.data_ptr() % 16:
        raise ValueError("queries and corpus must start 16-byte aligned (16-byte loads)")


def _same_device_contiguous(corpus, **tensors):
    for name, t in tensors.items():
        if t.device != corpus.device:
            raise ValueError(f"{name} is on {t.device}, the corpus on {corpus.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_int8(qi, codes, qscale, scale, valid, tile_n):
    if qi.ndim != 2 or codes.ndim != 2 or qi.shape[1] != codes.shape[1]:
        raise ValueError("expected query codes (Q, D) and corpus codes (N, D)")
    if qi.dtype != torch.int8 or codes.dtype != torch.int8:
        raise TypeError(f"tile_max_int8 takes int8 codes, got {qi.dtype} and {codes.dtype}")
    if codes.shape[1] % 16:
        raise ValueError("the corpus dim must be a multiple of 16 (16-byte rows)")
    n = codes.shape[0]
    if qscale.dtype != torch.float32 or qscale.shape != (qi.shape[0],):
        raise ValueError("qscale must be float32 with one entry a query")
    if scale.dtype != torch.float32 or scale.shape != (n,):
        raise ValueError("scale must be float32 with one entry a corpus row")
    if valid.dtype != torch.bool or valid.shape != (n,):
        raise ValueError("valid must be a bool mask with one entry a corpus row")
    if tile_n <= 0 or n % tile_n:
        raise ValueError(f"corpus rows {n} not a multiple of {tile_n}")
    _same_device_contiguous(
        codes, qi=qi, codes=codes, qscale=qscale, scale=scale, valid=valid
    )


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
    if queries.shape[0] >= 2:  # csrc dispatch
        if scoring.dtype == torch.bfloat16:
            tile_max.mma_launches += 1
        else:
            tile_max.fp32_mq_launches += 1
    return out


tile_max.launches = 0
tile_max.mma_launches = 0
tile_max.fp32_mq_launches = 0


def tile_max_int8(
    qi: torch.Tensor,
    codes: torch.Tensor,
    qscale: torch.Tensor,
    scale: torch.Tensor,
    valid: torch.Tensor,
    tile_n: int,
) -> torch.Tensor:
    """(Q, n_tiles) fp32 tile maxima of the int8 tier; see the module
    docstring."""
    if codes.device.type == "cpu":
        return tile_max_int8_plain(qi, codes, qscale, scale, valid, tile_n)
    if codes.device.type != "cuda":
        raise ValueError(f"tile_max_int8 runs on cuda or cpu, not {codes.device}")
    _check_int8(qi, codes, qscale, scale, valid, tile_n)
    n_tiles = codes.shape[0] // tile_n
    out = torch.empty((qi.shape[0], n_tiles), dtype=torch.float32, device=codes.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = lib.tile_max_int8(
            qi.data_ptr(),
            codes.data_ptr(),
            qscale.data_ptr(),
            scale.data_ptr(),
            valid.data_ptr(),
            out.data_ptr(),
            qi.shape[0],
            codes.shape[1],
            tile_n,
            n_tiles,
            stream,
        )
    _build.check(lib, _NAME, rc)
    tile_max_int8.launches += 1
    return out


tile_max_int8.launches = 0
