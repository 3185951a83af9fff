"""Exact cosine top-k over a device-resident corpus: the two-phase engine.

Counterpart of ``imatch_tpu/index/search.py`` (``prepare_device_corpus``,
``_tilemax_topk``, ``_int8_scores`` and the tilemax-host tier) and
``imatch_tpu/ops/pallas/topk.py`` (``prepare_corpus``,
``_query_prepared``). The JAX engines ``tilemax`` (tile_n 512) and
``pallas`` (tile_n 2048) are the same two phases here:

- Phase 1, K1 (``ops/kernels/topk.py``): per query, the max score of
  every tile of ``tile_n`` corpus rows in the score dtype (bf16 by
  default, or fp32), fp32 accumulation, invalid rows masked. With int8
  scoring, K1's int8 variant on per-row quantized codes
  (``int8_tile_max``, the math of JAX ``_int8_scores``).
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

The tilemax-host capacity tier (``HostRescoreCorpus``) keeps only the
int8 codes on the device and rescores the selected tiles in fp32 from the
host copy with numpy. Its phase 1 is the same ``int8_tile_max`` as the
int8 engine's, so both tiers select the same tiles.

Ties break to the lower index, as ``lax.top_k`` does after the JAX code's
index sort: both selections use a stable descending sort over candidates
held in ascending index order (``torch.topk`` promises no order on ties).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from imatch_tpu_torch.ops.kernels.topk import (
    NEG_INF,
    int8_dot_scores,
    tile_max,
    tile_max_int8,
)

# Gathered fp32 candidate rows per phase-2 step; queries are processed in
# chunks that stay under it (one query at a time at worst).
_RESCORE_BYTES = 1 << 30


class DeviceCorpus(NamedTuple):
    """Query-ready device state, rebuilt by the store after a mutation."""

    scoring: torch.Tensor  # (n_tiles * tile_n, Dp) score dtype, Dp = D up to 8 (16 for int8)
    exact: torch.Tensor  # (n_tiles * tile_n, D) fp32 for the rescore
    valid: torch.Tensor  # (n_tiles * tile_n,) bool
    tile_n: int
    margin: int
    scale: Optional[torch.Tensor] = None  # (n_tiles * tile_n,) fp32, int8 scoring only


# XLA folds ``amax / 127.0`` into a multiply by the fp32 constant 1/127
# (so does nvcc for a division by a constant); a true division differs in
# the last bit for about 5% of rows. JAX's device scales are therefore
# ``amax * fp32(1/127)``, and so are the port's, written out.
_INV127 = float(np.float32(1.0 / 127.0))


def _int8_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of fp32 rows as JAX ``_int8_scores`` and
    ``_prepare_device_corpus`` compute it: ``scale = amax * fp32(1/127)``
    (1 for a zero row), codes ``clip(round(x / scale), -127, 127)``, the
    latter a true division of two tensors. K3's ``round(x * (127 / amax))``
    would flip codes."""
    amax = x.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax * _INV127, 1.0)
    codes = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return codes, scale


def _int8_queries(q32: torch.Tensor, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query codes zero-padded to the corpus codes' width, and their scales."""
    codes, qscale = _int8_rows(q32)
    return torch.nn.functional.pad(codes, (0, width - codes.shape[1])), qscale


def int8_scores(q32: torch.Tensor, scoring: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain counterpart of JAX ``_int8_scores``: the (Q, N) fp32 int8
    phase-1 scores of fp32 queries against int8 corpus codes."""
    qi, qscale = _int8_queries(q32, scoring.shape[1])
    return int8_dot_scores(qi, scoring, qscale, scale)


def int8_tile_max(
    q32: torch.Tensor,
    scoring: torch.Tensor,
    valid: torch.Tensor,
    scale: torch.Tensor,
    tile_n: int,
) -> torch.Tensor:
    """Phase 1 of both int8 tiers: the queries quantized as
    ``_int8_scores`` does, then K1's int8 variant. One definition: the
    tilemax int8 engine and the tilemax-host tier must select the same
    tiles."""
    qi, qscale = _int8_queries(q32, scoring.shape[1])
    return tile_max_int8(qi, scoring, qscale, scale, valid, tile_n)


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
    multiple of 8 values (16 int8 codes) for the kernels' 16-byte loads.
    int8 scoring quantizes each row (``_int8_rows``) and keeps its
    scale."""
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
    if score_dtype == torch.int8:
        codes, scale = _int8_rows(exact)
        scoring = torch.nn.functional.pad(codes, (0, -(-d // 16) * 16 - d))
        return DeviceCorpus(scoring, exact.contiguous(), valid, tile_n, margin, scale)
    scoring = torch.nn.functional.pad(exact, (0, d_pad - d)).to(score_dtype)
    return DeviceCorpus(scoring.contiguous(), exact.contiguous(), valid, tile_n, margin)


def _top_tiles(tmax: torch.Tensor, kt: int) -> torch.Tensor:
    """The kt best tiles per query, ties to the lower tile (lax.top_k)."""
    return torch.sort(tmax, dim=1, descending=True, stable=True).indices[:, :kt]


def _rescore(q32, tmax, dc: DeviceCorpus, k: int):
    """Phase 2: candidate tiles from the tile maxima, exact fp32 rescore."""
    nq, n_tiles = tmax.shape
    tile_n = dc.tile_n
    d = dc.exact.shape[1]
    kt = min(k + dc.margin, n_tiles)
    tiles = torch.sort(_top_tiles(tmax, kt), dim=1).values  # candidates in index order
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
    if dc.scoring.dtype == torch.int8:
        tmax = int8_tile_max(q32, dc.scoring, dc.valid, dc.scale, dc.tile_n)
    else:
        nq, d = q32.shape
        qs = torch.zeros((nq, dc.scoring.shape[1]), dtype=dc.scoring.dtype, device=q32.device)
        qs[:, :d] = q32
        tmax = tile_max(qs, dc.scoring, dc.valid, dc.tile_n)
    return _rescore(q32, tmax, dc, k)


# -- capacity tier: int8 scoring on the device, fp32 rescore on the host -------

HOST_MARGIN = 16  # candidate tiles beyond k, as JAX _phase1_tiles


class HostRescoreCorpus(NamedTuple):
    """Device state for corpora whose fp32 copy does not fit the card:
    only the int8 codes, validity and scales live on the device; the fp32
    rows stay on the host for the rescore (the store's host copy is its
    source of truth anyway). Selected by IMATCH_INDEX_ENGINE=tilemax-host
    or by ``auto``'s capacity escalation (index/store.py)."""

    scoring: torch.Tensor  # (N_pad, Dp) int8, device
    valid: torch.Tensor  # (N_pad,) bool, device
    scale: torch.Tensor  # (N_pad,) fp32, device
    host_exact: np.ndarray  # (N, D) fp32 copy, mutation-safe
    host_valid: np.ndarray  # (N,) bool copy
    tile_n: int
    n: int  # rows represented, before padding


def phase1_tiles(queries: torch.Tensor, hc: HostRescoreCorpus, *, k: int) -> torch.Tensor:
    """Counterpart of JAX ``_phase1_tiles``: the top k + 16 candidate
    tiles per query from ``int8_tile_max``, on the device."""
    q32 = queries.to(device=hc.scoring.device, dtype=torch.float32)
    tmax = int8_tile_max(q32, hc.scoring, hc.valid, hc.scale, hc.tile_n)
    return _top_tiles(tmax, min(k + HOST_MARGIN, tmax.shape[1]))


def prepare_host_rescore_corpus(
    emb: np.ndarray, alive: np.ndarray, *, tile_n: int = 512, device="cpu"
) -> HostRescoreCorpus:
    """Quantize on the host (numpy, chunks of 2^20 rows so the float
    temporaries stay small), as JAX ``prepare_host_rescore_corpus`` does
    bit for bit (numpy divides by 127 where XLA multiplies by 1/127, so a
    scale here can differ from the device tier's in the last bit); only the int8 codes, the mask and the scales go to the
    device. Columns are zero-padded to a multiple of 16 for the kernel."""
    n, d = emb.shape
    scale = np.empty((n,), np.float32)
    q = np.empty(emb.shape, np.int8)
    step = 1 << 20
    for s0 in range(0, n, step):
        blk = emb[s0 : s0 + step]
        amax = np.abs(blk).max(axis=1)
        sc = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        scale[s0 : s0 + step] = sc
        q[s0 : s0 + step] = np.clip(np.round(blk / sc[:, None]), -127, 127).astype(np.int8)
    pad = (-n) % tile_n
    q = np.pad(q, ((0, pad), (0, -(-d // 16) * 16 - d)))
    alive_p = np.pad(alive, (0, pad))
    scale_p = np.pad(scale, (0, pad), constant_values=1.0)
    return HostRescoreCorpus(
        scoring=torch.from_numpy(q).to(device),
        valid=torch.from_numpy(alive_p).to(device),
        scale=torch.from_numpy(scale_p).to(device),
        host_exact=emb,
        host_valid=alive,
        tile_n=tile_n,
        n=n,
    )


def host_rescore_topk(queries: torch.Tensor, hc: HostRescoreCorpus, *, k: int):
    """(Q, k) fp32 scores and int64 indices as numpy arrays, -1 / NEG_INF
    padded: the contract of ``tilemax_topk``, with phase 2 on the host
    (JAX ``host_rescore_topk``: the selected tiles' rows rescored in fp32
    with numpy, ties to the lower index through ``lexsort``)."""
    tiles = phase1_tiles(queries, hc, k=k).cpu().numpy()
    qh = queries.detach().to(device="cpu", dtype=torch.float32).numpy()
    nq = qh.shape[0]
    out_s = np.full((nq, k), NEG_INF, np.float32)
    out_i = np.full((nq, k), -1, np.int64)
    col = np.arange(hc.tile_n)
    for qi in range(nq):
        rows_idx = (tiles[qi][:, None] * hc.tile_n + col[None, :]).ravel()
        rows_idx = rows_idx[rows_idx < hc.n]
        rows_idx = rows_idx[hc.host_valid[rows_idx]]
        if rows_idx.size == 0:
            continue
        # chunked: at k = 1000 the candidates are about half a million rows
        es = np.empty((rows_idx.size,), np.float32)
        step = 65536
        for c0 in range(0, rows_idx.size, step):
            es[c0 : c0 + step] = hc.host_exact[rows_idx[c0 : c0 + step]] @ qh[qi]
        kk = min(k, rows_idx.size)
        order = np.lexsort((rows_idx, -es))[:kk]
        out_s[qi, :kk] = es[order]
        out_i[qi, :kk] = rows_idx[order]
    return out_s, out_i
