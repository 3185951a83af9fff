"""Sharded IVF: one IVF a shard over a device list (the ``ivf-sharded`` engine).

Counterpart of ``imatch_tpu/parallel/dist_ivf.py``. The corpus is cut
row-wise into P shards as for the exact sharded engine (parallel/
dist_search.py), and each shard gets an INDEPENDENT IVF (k-means over
its N / P rows, seed ``seed + s``) on its device. A query probes every
shard's index with the single-device probe (index/ivf.py
``_ivf_probe_topk``), and the (Q, k) candidates of the shards merge on
the first device as the exact engine's do. P independent indexes probed
``n_probe`` deep scan at least as much as one global index; with
``n_probe`` at least every shard's cluster count each shard scans all of
its rows, and the answers equal the exact ``sharded`` engine's.

Shards are padded to one cluster count and member width, as JAX stacks
them: padded clusters carry ``nonempty`` False (so do empty ones) and
never win a probe slot. Member tables hold shard-LOCAL row ids.

A grid that spans processes (parallel/distributed.py) is refused with a
ValueError: this engine keeps every shard's host state in one process and
has no exchange of candidates, and it must never answer from the local
shards alone. The exact ``sharded`` engine serves such a grid.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from imatch_tpu_torch.index import ivf as _ivf
from imatch_tpu_torch.index.ivf import IVFIndex, _ivf_probe_topk
from imatch_tpu_torch.parallel.dist_search import _offset, merge_topk
from imatch_tpu_torch.parallel.mesh import Mesh


class ShardedIVF(NamedTuple):
    """One ``IVFIndex`` a shard on its device (centroids (C_max, D),
    members (C_max, M_max) of local ids, corpus (rows, D), valid (rows,)),
    with each shard's (C_max,) ``nonempty`` mask."""

    shards: Tuple[IVFIndex, ...]
    nonempty: Tuple[torch.Tensor, ...]
    rows: int
    mesh: Mesh


def prepare_sharded_ivf(corpus, valid, *, mesh: Mesh, n_clusters: int = 0, seed: int = 0) -> ShardedIVF:
    """Row-shard the corpus and build one IVF a shard (a full build)."""
    state, _ = prepare_sharded_ivf_incremental(corpus, valid, mesh=mesh, n_clusters=n_clusters, seed=seed)
    return state


def _repairable(snap, dp: int, rows: int, dim: int, live: int) -> bool:
    """Whether the previous build's host state ``snap`` can be repaired
    into this build: same kind, shard count and shard rows, the live set
    grown less than IMATCH_IVF_REBUILD_FRAC (default 0.3) since k-means,
    and well formed. A malformed state (a hand-edited sidecar) is not an
    error: it retrains."""
    frac = float(os.environ.get("IMATCH_IVF_REBUILD_FRAC", "0.3"))
    try:
        return (
            snap is not None
            and snap.get("kind") == "ivf-sharded"
            and snap.get("dp") == dp
            and snap.get("rows") == rows
            and len(snap["cents"]) == dp
            and all(c.ndim == 2 for c in snap["cents"])
            and snap["cents"][0].shape[1] == dim
            and live <= snap["built_live"] * (1.0 + frac)
            and hasattr(snap["assign"], "shape")
            and snap["assign"].ndim == 1
        )
    except (KeyError, IndexError, AttributeError, TypeError):
        return False


def prepare_sharded_ivf_incremental(
    corpus,
    valid,
    *,
    mesh: Mesh,
    n_clusters: int = 0,
    seed: int = 0,
    snap: dict = None,
) -> Tuple[ShardedIVF, dict]:
    """The sharded IVF build with per-shard repair. Shard boundaries are
    ranges of the capacity buffer the store hands over, stable between
    capacity growths, so when ``snap`` (the previous build's host state)
    is repairable each shard only assigns its unassigned rows against its
    EXISTING centroids and repacks its member lists: no Lloyd runs. The
    store drops the host state on a capacity growth or a compaction (rows
    cross shard boundaries), so those retrain.

    Returns ``(state, host_state)``; the host state is the store's and
    comes back as the next call's ``snap``."""
    if getattr(mesh, "spans_processes", False):
        raise ValueError(f"ivf-sharded does not run over a grid that spans processes: {mesh!r}; use sharded")
    corpus = np.asarray(corpus)
    valid = np.asarray(valid, bool)
    dp = len(mesh)
    pad = (-corpus.shape[0]) % dp
    if pad:
        corpus = np.pad(corpus, ((0, pad), (0, 0)))
        valid = np.pad(valid, (0, pad))
    rows = corpus.shape[0] // dp
    live = int(valid.sum())
    # each shard's rows go to its device once, for k-means, assignment and the index
    dev_rows = [_ivf._as_corpus(corpus[s * rows : (s + 1) * rows], dev) for s, dev in enumerate(mesh)]
    repair = _repairable(snap, dp, rows, corpus.shape[1], live)
    cents, membs, fills = [], [], []
    if repair:
        assign = snap["assign"]
        if assign.shape[0] < corpus.shape[0]:
            assign = np.concatenate([assign, np.full((corpus.shape[0] - assign.shape[0],), -1, np.int32)])
        else:
            assign = assign[: corpus.shape[0]].copy()  # the repair writes in place
        assign[~valid] = -1  # dead slots: a reused slot must repair
        built_live = snap["built_live"]
        cents = list(snap["cents"])
        try:
            for s in range(dp):
                sl = slice(s * rows, (s + 1) * rows)
                a_s, ok_s = assign[sl], valid[sl]
                fresh = np.nonzero((a_s == -1) & ok_s)[0]
                if fresh.size:
                    a_s[fresh] = _ivf.assign_rows(dev_rows[s][torch.from_numpy(fresh).to(mesh[s])], cents[s])
                m, counts = _ivf.pack_members(a_s, ok_s, cents[s].shape[0])
                membs.append(m)
                fills.append(counts.astype(np.int64))
        except (IndexError, ValueError):
            # semantically corrupt host state (assignments past a shard's
            # cluster count): a full per-shard retrain, never a poisoned path
            repair = False
            cents, membs, fills = [], [], []
    if not repair:
        assign = np.full((corpus.shape[0],), -1, np.int32)
        built_live = live
        for s in range(dp):
            sl = slice(s * rows, (s + 1) * rows)
            c = _ivf.train_centroids(dev_rows[s], valid[sl], n_clusters=n_clusters, seed=seed + s)
            a_s = _ivf.assign_rows(dev_rows[s], c)
            assign[sl] = a_s
            m, counts = _ivf.pack_members(a_s, valid[sl], c.shape[0])
            cents.append(c.cpu().numpy())
            membs.append(m)
            fills.append(counts.astype(np.int64))
        # the assignment covered every slot; dead and padding rows are
        # stamped unassigned, so rows added there later are repaired
        assign[~valid] = -1

    host = {
        "kind": "ivf-sharded",
        "cents": cents,
        "assign": assign,
        "built_live": built_live,
        "dp": dp,
        "rows": rows,
        # each shard's member-list fill, for the O(batch) append (index/patch.py)
        "counts": fills,
        "last_mode": "repair" if repair else "train",
    }
    c_max = max(c.shape[0] for c in cents)
    m_max = max(m.shape[1] for m in membs)
    shards, masks = [], []
    for s, dev in enumerate(mesh):
        c, m = cents[s], membs[s]
        shards.append(
            IVFIndex(
                torch.from_numpy(np.pad(c, ((0, c_max - c.shape[0]), (0, 0)))).to(dev),
                torch.from_numpy(
                    np.pad(m, ((0, c_max - m.shape[0]), (0, m_max - m.shape[1])), constant_values=-1)
                ).to(device=dev, dtype=torch.int64),
                dev_rows[s],
                torch.from_numpy(valid[s * rows : (s + 1) * rows].copy()).to(dev),
            )
        )
        masks.append(torch.from_numpy(np.pad(fills[s] > 0, (0, c_max - c.shape[0]))).to(dev))
    return ShardedIVF(tuple(shards), tuple(masks), rows, mesh), host


def sharded_ivf_topk(
    queries,
    index: ShardedIVF,
    *,
    k: int,
    n_probe: int = 8,
    rescore_margin: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate global top-k against a prepared sharded IVF: the
    contract of ``tilemax_topk`` ((Q, k) fp32 scores descending, int64
    global row ids, -1 padded), on the first shard's device."""
    q32 = torch.as_tensor(queries).float()
    parts = []
    for s, (ix, ne) in enumerate(zip(index.shards, index.nonempty)):
        scores, idx = _ivf_probe_topk(
            q32.to(ix.corpus.device),
            ix.centroids,
            ix.members,
            ix.corpus,
            ix.valid,
            k=k,
            n_probe=n_probe,
            rescore_margin=rescore_margin,
            nonempty=ne,
        )
        parts.append((scores, _offset(idx, s * index.rows)))
    return merge_topk(parts, k)
