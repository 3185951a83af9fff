"""Corpus-sharded exact top-k over a device list (the ``sharded`` engine).

Counterpart of ``imatch_tpu/parallel/dist_search.py``. The corpus is cut
row-wise into P equal shards, shard ``s`` on ``mesh[s]`` (parallel/
mesh.py); each shard answers with the two-phase engine of
index/search.py, whose phase 1 is K1, so an engine call launches K1 once
a shard. The (Q, k) candidates of every shard are offset to global row
ids, copied to the first device and merged: the global top k, ties to
the lower global index (JAX orders the all-gathered candidates by index
before its stable ``lax.top_k``). A query's traffic between devices is
k * P scores and ids, whatever the corpus size.

Every shard is launched before any result is waited on (nothing in a
shard's call synchronises), so on several cards the shards run at once.
int8 scoring is coerced to bf16, as in JAX: the sharded engine keeps no
per-row scale.

Each shard holds whole tiles (rows are padded to a multiple of
``P * tile_n``), so a shard's tiles are the single-device engine's tiles,
and each row's final score comes from ``search.final_topk``, whose bits
do not depend on the batch: the store's ``sharded`` engine answers as
``tilemax`` does, bit for bit, at every P.

Over a grid that spans processes (parallel/distributed.py) a process
prepares only the shards it owns (the others are None in its
``ShardedCorpus``), runs K1 on them, and all-gathers its fixed-shape
(Q, k x local shards) candidates and their global ids over the process
group before the merge, so every process returns the same answer. Every
process must make the same calls in the same order (the store's host
state is replicated in each).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from imatch_tpu_torch.index.search import DeviceCorpus, prepare_device_corpus, stable_top, tilemax_topk
from imatch_tpu_torch.parallel import distributed
from imatch_tpu_torch.parallel.mesh import Mesh


class ShardedCorpus(NamedTuple):
    """Query-ready sharded state: one ``DeviceCorpus`` a shard, on its own
    device, each of ``rows`` rows (whole tiles); None for a shard another
    process owns."""

    shards: Tuple[DeviceCorpus, ...]
    rows: int
    mesh: Mesh
    tile_n: int


def _coerce_dtype(score_dtype: torch.dtype) -> torch.dtype:
    # no per-row dequant scale on the sharded path: int8 runs as bf16
    return torch.bfloat16 if score_dtype == torch.int8 else score_dtype


def prepare_sharded_corpus(
    corpus,
    valid,
    *,
    mesh: Mesh,
    score_dtype: torch.dtype = torch.bfloat16,
    tile_n: int = 512,
    margin: int = 4,
) -> ShardedCorpus:
    """Pad (N, D) fp32 rows to a multiple of ``len(mesh) * tile_n`` and
    prepare each shard's scoring and fp32 rescore copies on its device."""
    corpus = np.asarray(corpus, np.float32)
    valid = np.asarray(valid, bool)
    dp = len(mesh)
    pad = (-corpus.shape[0]) % (dp * tile_n)
    if pad:
        corpus = np.pad(corpus, ((0, pad), (0, 0)))
        valid = np.pad(valid, (0, pad))
    rows = corpus.shape[0] // dp
    dtype = _coerce_dtype(score_dtype)
    shards = tuple(
        prepare_device_corpus(
            corpus[s * rows : (s + 1) * rows],
            valid[s * rows : (s + 1) * rows],
            tile_n=tile_n,
            score_dtype=dtype,
            margin=margin,
            device=dev,
        )
        if _local(mesh, s)
        else None
        for s, dev in enumerate(mesh)
    )
    return ShardedCorpus(shards, rows, mesh, tile_n)


def _local(mesh, s: int) -> bool:
    """Whether shard ``s`` is this process's (every shard of a device list)."""
    return getattr(mesh, "is_local", lambda _: True)(s)


def merge_parts(parts, mesh, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``merge_topk`` of this process's shards' candidates; over a grid
    that spans processes, of every process's, all-gathered first."""
    if getattr(mesh, "spans_processes", False):
        dev = parts[0][0].device
        ss = torch.cat([s.to(dev) for s, _ in parts], dim=1)
        ii = torch.cat([i.to(dev) for _, i in parts], dim=1)
        parts = list(zip(distributed.all_gather(ss), distributed.all_gather(ii)))
    return merge_topk(parts, k)


def merge_topk(parts, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global top k of per-shard ``(scores, global ids)`` pairs, on the
    first pair's device: candidates ordered by global id (-1 last), then a
    stable descending sort of the scores."""
    dev = parts[0][0].device
    ss = torch.cat([s.to(dev) for s, _ in parts], dim=1)
    ii = torch.cat([i.to(dev) for _, i in parts], dim=1)
    return stable_top(ss, ii, k)


def _offset(idx: torch.Tensor, base: int) -> torch.Tensor:
    return torch.where(idx >= 0, idx + base, -1)


def sharded_topk_prepared(
    queries: torch.Tensor, sc: ShardedCorpus, *, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k against a prepared sharded corpus: the contract of
    ``tilemax_topk`` ((Q, k) fp32 scores descending, int64 global row ids,
    -1 padded), on the first shard's device."""
    q32 = torch.as_tensor(queries).float()
    parts = []
    for s, dc in enumerate(sc.shards):  # every shard launched before any wait
        if dc is not None:
            scores, idx = tilemax_topk(q32.to(dc.exact.device), dc, k=k)
            parts.append((scores, _offset(idx, s * sc.rows)))
    return merge_parts(parts, sc.mesh, k)


def pad_corpus_for_mesh(corpus: torch.Tensor, valid: torch.Tensor, dp: int):
    """Pad corpus rows (and validity, with False) to a multiple of ``dp``."""
    pad = (-corpus.shape[0]) % dp
    if pad:
        corpus = torch.nn.functional.pad(corpus, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return corpus, valid


def sharded_cosine_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    *,
    mesh: Mesh,
    k: int,
    chunk: int = 512,
    score_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global exact top-k of a corpus whose rows are a multiple of the
    mesh size (``pad_corpus_for_mesh``), ``valid`` masking the padding:
    each shard of N / P rows is tiled by min(chunk, 512, N / P) rows and
    answered by the two-phase engine. Returns global row ids, -1 for empty
    slots, ties to the lower index; on the first device of the mesh."""
    n = corpus.shape[0]
    dp = len(mesh)
    if n == 0:
        raise ValueError("empty corpus: nothing to search")
    if n % dp:
        raise ValueError(f"corpus rows {n} not a multiple of the mesh size {dp}")
    shard_rows = n // dp
    tile_n = min(chunk, 512, shard_rows)
    q32 = torch.as_tensor(queries).float()
    dtype = _coerce_dtype(score_dtype)
    margin = int(os.environ.get("IMATCH_TILEMAX_MARGIN", "4"))  # as JAX's _tilemax_topk
    parts = []
    for s, dev in enumerate(mesh):
        if not _local(mesh, s):
            continue
        sl = slice(s * shard_rows, (s + 1) * shard_rows)
        dc = prepare_device_corpus(
            corpus[sl], valid[sl], tile_n=tile_n, score_dtype=dtype, margin=margin, device=dev
        )
        scores, idx = tilemax_topk(q32.to(dev), dc, k=k)
        parts.append((scores, _offset(idx, s * shard_rows)))
    return merge_parts(parts, mesh, k)
