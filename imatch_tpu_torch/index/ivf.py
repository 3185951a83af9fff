"""IVF-flat approximate index: the optional ANN tier, on the card.

Counterpart of ``imatch_tpu/index/ivf.py``. k-means clusters the corpus
(streamed Lloyd iterations, products with fp32 accumulation), each
cluster keeps its member list, and a query scores the C centroids,
probes the best ``n_probe`` clusters and rescores only their members in
fp32: a query reads O(n_probe * N / C) rows instead of N. The exact
engine (index/search.py) stays the accuracy reference; a full probe
(``n_probe >= C``) reproduces it.

- Every step JAX runs on its device runs on the index's device here:
  the k-means products and updates, the assignment, the probe and both
  rescore phases. The host packs the member lists (``pack_members``,
  numpy, the same code as JAX's) and keeps the bookkeeping.
- Random draws use an explicit ``torch.Generator`` on the CPU seeded with
  ``seed``: the live-row sample, then the k-means init (rows drawn with
  replacement, weighted by validity, as ``jax.random.choice`` with
  ``p=``). Torch cannot reproduce JAX's draws, so an index trained here
  differs from JAX's; ``kmeans_init`` and ``lloyd`` are separate so that
  the same init gives the same centroids.
- The Lloyd update accumulates each cluster's rows with ``index_add_``
  (JAX: a one-hot matrix product). Both sum in fp32; the order differs,
  so centroids agree with JAX's to fp32 rounding, not bit for bit.
- Ties go to the lower index everywhere JAX's ``lax.top_k`` sees them
  after its index sort: the probed clusters, phase 1's survivors and the
  final top k (stable descending sorts over candidates held in index
  order); ``argmax`` returns the first maximum, as ``jnp.argmax``.
- The probe runs phase 1 one query at a time, so the peak holds one
  query's (n_probe * M, D) gather (JAX maps it over queries with
  ``lax.map`` for the same reason). Phase 2 rescores every query's
  k + margin survivors at once with the exact engines' final step
  (``search.final_topk``, whose scores do not depend on the batch's
  shape): a full probe gives each row the exact engines' bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from imatch_tpu_torch.index.search import final_topk, stable_top
from imatch_tpu_torch.ops.kernels.topk import NEG_INF


class IVFIndex(NamedTuple):
    centroids: torch.Tensor  # (C, D) fp32, L2-normalised
    members: torch.Tensor  # (C, M) int64 row ids, -1 padding
    corpus: torch.Tensor  # (N, D) storage dtype (the exact vectors)
    valid: torch.Tensor  # (N,) bool


def _on_device(x, device, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``. A tensor is moved (not copied when
    it is there already); numpy is copied, also on the CPU, where
    ``as_tensor`` would alias memory that patches then write in place."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    a = np.asarray(x)
    t = torch.from_numpy(a if a.flags.writeable else a.copy())
    out = t.to(device=device, dtype=dtype)
    return out.clone() if out.data_ptr() == t.data_ptr() else out


def _as_corpus(corpus, device) -> torch.Tensor:
    """(N, D) rows on ``device`` in fp32, or in bf16 if given bf16 (JAX
    ``_coerce_corpus``)."""
    t = _on_device(corpus, device)
    return t if t.dtype in (torch.float32, torch.bfloat16) else t.float()


def _as_valid(valid, device) -> torch.Tensor:
    return _on_device(valid, device, torch.bool)


def _scores(rows: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """(n, c) fp32 products of rows with ``other`` (c, D) in the rows'
    dtype, accumulated in fp32: bf16 operands are upcast (exact) and
    multiplied in fp32, as JAX's ``preferred_element_type=float32``."""
    return rows.float() @ other.to(rows.dtype).float().T


def _normalise(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-9)


def kmeans_init(
    train: torch.Tensor, tvalid: torch.Tensor, n_clusters: int, generator: torch.Generator
) -> torch.Tensor:
    """(C, D) fp32 initial centroids: ``n_clusters`` rows of ``train`` drawn
    with replacement, each valid row equally likely (JAX ``jax.random.
    choice(key, n, (C,), p=valid / valid.sum())``), L2-normalised. The draw
    runs on the CPU with ``generator``."""
    probs = tvalid.detach().to(device="cpu", dtype=torch.float64)
    if not bool(probs.any()):  # no live row (JAX's 0/0 weights): draw any
        probs = torch.ones_like(probs)
    idx = torch.multinomial(probs, n_clusters, replacement=True, generator=generator)
    return _normalise(train[idx.to(train.device)].float())


def lloyd(
    train: torch.Tensor,
    tvalid: torch.Tensor,
    init_centroids: torch.Tensor,
    iters: int = 10,
    chunk: int = 8192,
) -> torch.Tensor:
    """``iters`` Lloyd iterations from ``init_centroids``, streamed over
    ``chunk``-row slices (JAX ``_kmeans_chunked``'s loop): each row's
    nearest centroid (similarities in the rows' dtype, fp32 accumulation)
    adds the row to its cluster's fp32 sum; a cluster with rows moves to
    their mean, an empty one stays; then L2-normalise. Only (chunk, C)
    similarities exist at a time, never (N, C)."""
    cents = init_centroids.to(device=train.device, dtype=torch.float32)
    n_clusters, d = cents.shape
    n = train.shape[0]
    for _ in range(iters):
        sums = torch.zeros((n_clusters, d), dtype=torch.float32, device=train.device)
        counts = torch.zeros((n_clusters,), dtype=torch.float32, device=train.device)
        for off in range(0, n, chunk):
            rows = train[off : off + chunk]
            ok = tvalid[off : off + chunk]
            # invalid rows add zeros (no boolean indexing: no host sync)
            assign = torch.argmax(_scores(rows, cents), dim=1)
            sums.index_add_(0, assign, torch.where(ok[:, None], rows.float(), 0.0))
            counts.index_add_(0, assign, ok.float())
        counts = counts[:, None]
        cents = _normalise(torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), cents))
    return cents


def _assign(corpus: torch.Tensor, cents: torch.Tensor, chunk: int) -> torch.Tensor:
    """(N,) nearest-centroid id per row on the device, streamed (JAX
    ``_assign_chunked``)."""
    cents = cents.to(corpus.device)
    steps = range(0, corpus.shape[0], chunk)
    return torch.cat([torch.argmax(_scores(corpus[off : off + chunk], cents), dim=1) for off in steps])


def train_centroids(
    corpus,
    valid,
    *,
    n_clusters: int = 0,
    iters: int = 10,
    seed: int = 0,
    sample: int = 1 << 18,
    chunk: int = 8192,
    device=None,
) -> torch.Tensor:
    """k-means alone: (C, D) fp32 L2-normalised centroids on ``device``
    (the corpus's, for a tensor), UNPRUNED, so assignments index a stable
    [0, C) space that later repairs reuse (``pack_ivf`` prunes per
    build). C defaults to ``4 * sqrt(live rows)``, at most the live rows:
    the store hands over its capacity buffer, and sizing by capacity
    would scatter a few rows over many clusters. Past ``sample`` rows it
    trains on ``sample`` LIVE slots drawn with replacement (uniform over
    capacity trained mostly on dead zero rows after mass deletion)."""
    if device is None:
        device = corpus.device if isinstance(corpus, torch.Tensor) else "cpu"
    corpus = _as_corpus(corpus, device)
    valid = _as_valid(valid, device)
    n = corpus.shape[0]
    valid_h = valid.cpu().numpy()
    n_live = int(valid_h.sum())
    if n_clusters <= 0:
        base = max(n_live, 1)
        n_clusters = max(1, min(base, int(4 * np.sqrt(base))))
    n_clusters = min(n_clusters, n)
    g = torch.Generator().manual_seed(seed)
    if n > sample:
        live_idx = np.flatnonzero(valid_h)
        if live_idx.size:
            sel = torch.randint(0, live_idx.size, (sample,), generator=g).numpy()
            idx = torch.from_numpy(live_idx[sel])
        else:
            idx = torch.randint(0, n, (sample,), generator=g)
        idx = idx.to(corpus.device)
        train, tvalid = corpus[idx], valid[idx]
    else:
        train, tvalid = corpus, valid
    init = kmeans_init(train, tvalid, n_clusters, g)
    return lloyd(train, tvalid, init, iters=iters, chunk=chunk)


def assign_rows(rows, cents, *, chunk: int = 8192, device=None) -> np.ndarray:
    """Nearest-centroid id per row, as host int32 (a copy the caller may
    write). ``rows`` may be any subset of the corpus, numpy or a tensor:
    the incremental add joins new rows to the index by one streamed
    argmax against the EXISTING centroids (the FAISS IVF add discipline)
    instead of re-clustering. Runs on the rows' device, or ``device``."""
    if device is None:
        device = rows.device if isinstance(rows, torch.Tensor) else "cpu"
    rows = _as_corpus(rows, device)
    if rows.shape[0] == 0:
        return np.zeros((0,), np.int32)
    return _assign(rows, _on_device(cents, rows.device, torch.float32), chunk).to(torch.int32).cpu().numpy()


def member_slack(max_count: int) -> int:
    """Headroom columns of the member table, so appends (index/patch.py)
    scatter new rows into their clusters without a repack: 25% of the
    deepest cluster, at least 16."""
    return max(16, -(-max_count // 4))


def pack_members(
    assign: np.ndarray, ok: np.ndarray, n_clusters: int, slack=None
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorised member-list scatter (JAX's numpy, line for line): the
    live rows into a (C, M) int32 table padded with -1, M = the deepest
    cluster + ``slack`` (``member_slack`` by default). Returns (members,
    per-cluster counts). Rows within a cluster ascend by row id: an
    append places its new (highest) rows at the fill point and stays
    list-identical to a repack."""
    rows = np.nonzero(ok)[0].astype(np.int64)
    a = assign[rows]
    order = np.argsort(a, kind="stable")
    rows_sorted = rows[order].astype(np.int32)
    a_sorted = a[order]
    counts = np.bincount(a, minlength=n_clusters)
    max_count = int(counts.max()) if counts.size else 1
    if slack is None:
        slack = member_slack(max(1, max_count))
    m = max(1, max_count + slack)
    starts = np.cumsum(counts) - counts
    pos = np.arange(len(rows_sorted)) - np.repeat(starts, counts)
    members = np.full((n_clusters, m), -1, np.int32)
    members[a_sorted, pos] = rows_sorted
    return members, counts


def pack_ivf(corpus, valid, cents, assign: np.ndarray, *, device=None) -> IVFIndex:
    """``pack_ivf_stats`` without the stats."""
    return pack_ivf_stats(corpus, valid, cents, assign, device=device)[0]


def pack_ivf_stats(corpus, valid, cents, assign: np.ndarray, *, device=None) -> Tuple[IVFIndex, dict]:
    """The member-list pack, then the empty-cluster prune: an empty
    cluster's centroid (a k-means leftover) would compete for probe slots
    with real clusters, and on a near-empty capacity buffer a query's
    every probe could land on one. ``assign`` indexes the UNPRUNED
    centroids; the index holds the pruned ones. Also returns the host
    bookkeeping of the incremental append (index/patch.py):

    - ``counts``: (C_pruned,) int64 fill of each member list;
    - ``pruned_map``: (C_unpruned,) int32, each unpruned cluster's row of
      the pruned table, -1 where it was pruned."""
    if device is None:
        device = corpus.device if isinstance(corpus, torch.Tensor) else "cpu"
    corpus = _as_corpus(corpus, device)
    valid = _as_valid(valid, device)
    cents = np.array(cents.cpu() if isinstance(cents, torch.Tensor) else cents, np.float32)
    n_clusters = cents.shape[0]
    members, counts = pack_members(assign, valid.cpu().numpy(), n_clusters)
    nonempty = np.nonzero(counts > 0)[0]
    pruned_map = np.full((n_clusters,), -1, np.int32)
    if nonempty.size and nonempty.size < n_clusters:
        members, cents, counts = members[nonempty], cents[nonempty], counts[nonempty]
        pruned_map[nonempty] = np.arange(nonempty.size, dtype=np.int32)
    elif not nonempty.size:
        members, cents, counts = members[:1], cents[:1], counts[:1]
    else:
        pruned_map[:] = np.arange(n_clusters, dtype=np.int32)
    index = IVFIndex(
        torch.from_numpy(np.ascontiguousarray(cents)).to(device),
        torch.from_numpy(members).to(device=device, dtype=torch.int64),
        corpus,
        valid,
    )
    return index, {"counts": counts.astype(np.int64), "pruned_map": pruned_map}


def build_ivf(
    corpus,
    valid,
    *,
    n_clusters: int = 0,
    iters: int = 10,
    seed: int = 0,
    sample: int = 1 << 18,
    chunk: int = 8192,
    device=None,
) -> IVFIndex:
    """Train centroids on a sample, assign every row in a streamed argmax,
    pack the member lists: ``train_centroids`` + ``assign_rows`` +
    ``pack_ivf``, the stages the incremental path reuses. The corpus keeps
    its dtype on the device (bf16 for corpora whose fp32 copy would not
    fit); the rescore is fp32 either way. Uploads the corpus once."""
    if device is None:
        device = corpus.device if isinstance(corpus, torch.Tensor) else "cpu"
    corpus = _as_corpus(corpus, device)
    valid = _as_valid(valid, device)
    cents = train_centroids(
        corpus, valid, n_clusters=n_clusters, iters=iters, seed=seed, sample=sample, chunk=chunk
    )
    assign = assign_rows(corpus, cents, chunk=chunk)
    return pack_ivf(corpus, valid, cents, assign)


def ivf_topk(
    queries: torch.Tensor,
    index: IVFIndex,
    *,
    k: int,
    n_probe: int = 8,
    rescore_margin: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k: probe ``n_probe`` clusters, two-phase rescore.
    Phase 1 scores every probed member in the corpus's storage dtype and
    keeps the top k + ``rescore_margin``; phase 2 rescores those in fp32.
    Returns (scores (Q, k) fp32 descending, indices (Q, k) int64) on the
    index's device, ``NEG_INF`` / -1 padded, ties to the lower row."""
    q32 = torch.as_tensor(queries).to(device=index.corpus.device, dtype=torch.float32)
    return _ivf_probe_topk(
        q32,
        index.centroids,
        index.members,
        index.corpus,
        index.valid,
        k=k,
        n_probe=n_probe,
        rescore_margin=rescore_margin,
    )


def _ivf_probe_topk(
    q32: torch.Tensor,
    centroids: torch.Tensor,
    members: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    *,
    k: int,
    n_probe: int,
    rescore_margin: int,
    nonempty: Optional[torch.Tensor] = None,
):
    """The probe and two-phase rescore shared by ``ivf_topk`` and each
    shard of the sharded IVF (parallel/dist_ivf.py). ``nonempty``: an
    optional (C,) mask; clusters padded in across shards never win a
    probe slot."""
    c, m = members.shape
    n_probe = min(n_probe, c)
    cand = n_probe * m
    kk = min(k + rescore_margin, cand)
    csims = q32 @ centroids.T
    if nonempty is not None:
        csims = torch.where(nonempty[None, :], csims, NEG_INF)
    probe = torch.sort(csims, dim=1, descending=True, stable=True).indices[:, :n_probe]
    # phase 1, a query at a time: one query's probed rows at the peak
    survivors = []
    for qi in range(q32.shape[0]):
        ids = members[probe[qi]].reshape(cand)
        safe = ids.clamp(min=0)
        ok = (ids >= 0) & valid[safe]
        s1 = _scores(corpus[safe], q32[qi : qi + 1])[:, 0]
        s1 = torch.where(ok, s1, NEG_INF)
        ts1, cid = stable_top(s1, torch.where(ok, ids, -1), kk)
        survivors.append(torch.where(ts1 <= NEG_INF / 2, -1, cid))
    # phase 2: the survivors' fp32 scores, the exact engines' final step
    return final_topk(torch.stack(survivors), q32, corpus, k)
