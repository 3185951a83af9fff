"""Exact cosine top-k over a device-resident corpus: the two-phase engine.

Counterpart of ``imatch_tpu/index/search.py`` (``prepare_device_corpus``,
``_tilemax_topk``) and ``imatch_tpu/ops/pallas/topk.py``
(``prepare_corpus``, ``_query_prepared``). Both JAX engines that this
slice ports, ``tilemax`` (tile_n 512) and ``pallas`` (tile_n 2048), are
the same two phases here:

- Phase 1, K1 (``ops/kernels/topk.py``): per query, the max score of
  every tile of ``tile_n`` corpus rows in the score dtype (bf16 by
  default, or fp32), fp32 accumulation, invalid rows masked.
- Phase 2, PyTorch: the top ``k + margin`` tiles per query; their rows
  gathered from the fp32 ``exact`` copy and rescored in full fp32 (TF32
  is off, see device.py); invalid rows masked; the final top k. Slots
  beyond the valid rows are index -1 with score ``NEG_INF``.

If a true top-k row were outside the selected tiles, each selected tile's
max would outrank it with k distinct rows, so the selected tiles hold the
full top k; the margin absorbs score-dtype rounding at the tile cutoff.
Like any fixed margin it is defeated by a corpus where more than
k + margin tiles tie within bf16 rounding; IMATCH_SCORE_DTYPE=fp32 makes
phase 1 exact.

Ties break to the lower index, as ``lax.top_k`` does after the JAX code's
index sort: both selections use a stable descending sort over candidates
held in ascending index order (``torch.topk`` promises no order on ties).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from imatch_tpu_torch.ops.kernels.topk import NEG_INF, tile_max

# Gathered fp32 candidate rows per phase-2 step; queries are processed in
# chunks that stay under it (one query at a time at worst).
_RESCORE_BYTES = 1 << 30


class DeviceCorpus(NamedTuple):
    """Query-ready device state, rebuilt by the store after a mutation."""

    scoring: torch.Tensor  # (n_tiles * tile_n, Dp) score dtype, Dp = D up to a multiple of 8
    exact: torch.Tensor  # (n_tiles * tile_n, D) fp32 for the rescore
    valid: torch.Tensor  # (n_tiles * tile_n,) bool
    tile_n: int
    margin: int


def prepare_device_corpus(
    corpus,
    valid,
    *,
    tile_n: int,
    score_dtype: torch.dtype = torch.bfloat16,
    margin: int = 4,
    device="cpu",
) -> DeviceCorpus:
    """Pad (N, D) fp32 rows and their (N,) validity to whole tiles, cast
    the scoring copy to ``score_dtype`` and zero-pad its columns to a
    multiple of 8 (16-byte rows for the kernel's loads)."""
    exact = torch.as_tensor(corpus, dtype=torch.float32, device=device)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=device)
    if exact.device.type == "cpu":
        # as_tensor aliases host memory that the store mutates in place
        exact, valid = exact.clone(), valid.clone()
    n, d = exact.shape
    n_pad = max(1, -(-n // tile_n)) * tile_n
    d_pad = -(-d // 8) * 8
    if n_pad != n:
        exact = torch.nn.functional.pad(exact, (0, 0, 0, n_pad - n))
        valid = torch.nn.functional.pad(valid, (0, n_pad - n))
    scoring = torch.nn.functional.pad(exact, (0, d_pad - d)).to(score_dtype)
    return DeviceCorpus(scoring.contiguous(), exact.contiguous(), valid, tile_n, margin)


def _rescore(q32, tmax, dc: DeviceCorpus, k: int):
    """Phase 2: candidate tiles from the tile maxima, exact fp32 rescore."""
    nq, n_tiles = tmax.shape
    tile_n = dc.tile_n
    d = dc.exact.shape[1]
    kt = min(k + dc.margin, n_tiles)
    top_tiles = torch.sort(tmax, dim=1, descending=True, stable=True).indices[:, :kt]
    tiles = torch.sort(top_tiles, dim=1).values  # candidates in index order
    rows_t = dc.exact.view(n_tiles, tile_n, d)
    valid_t = dc.valid.view(n_tiles, tile_n)
    col = torch.arange(tile_n, device=tmax.device)
    kk = min(k, kt * tile_n)
    step = max(1, _RESCORE_BYTES // (kt * tile_n * d * 4))
    out_s, out_i = [], []
    for q0 in range(0, nq, step):
        t = tiles[q0 : q0 + step]
        c = t.shape[0]
        rows = rows_t[t].reshape(c, kt * tile_n, d)
        s = torch.bmm(rows, q32[q0 : q0 + step, :, None]).reshape(c, kt * tile_n)
        s = torch.where(valid_t[t].reshape(c, -1), s, NEG_INF)
        gidx = (t[:, :, None] * tile_n + col).reshape(c, -1)
        s, pos = torch.sort(s, dim=1, descending=True, stable=True)
        s = s[:, :kk]
        idx = torch.where(s <= NEG_INF / 2, -1, gidx.gather(1, pos[:, :kk]))
        out_s.append(s)
        out_i.append(idx)
    scores, idx = torch.cat(out_s), torch.cat(out_i)
    if kk < k:
        scores = torch.nn.functional.pad(scores, (0, k - kk), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
    return scores, idx


def tilemax_topk(
    queries: torch.Tensor, dc: DeviceCorpus, *, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, D) fp32 L2-normalised queries -> (scores (Q, k) fp32
    descending, indices (Q, k) int64), on the corpus's device."""
    q32 = queries.to(device=dc.exact.device, dtype=torch.float32)
    nq, d = q32.shape
    qs = torch.zeros((nq, dc.scoring.shape[1]), dtype=dc.scoring.dtype, device=q32.device)
    qs[:, :d] = q32
    tmax = tile_max(qs, dc.scoring, dc.valid, dc.tile_n)
    return _rescore(q32, tmax, dc, k)
