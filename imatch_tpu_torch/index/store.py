"""Vector store with ChromaDB-collection semantics, on the card.

Counterpart of ``imatch_tpu/index/store.py`` ``VectorStore``: ``add``
(with the up-front validation), ``get`` with ``include=``, ``update``,
``delete`` (tombstones), ``count``, ``stats`` and ``query``, which returns
cosine *distance* ``1 - cos`` like a chroma cosine collection
(pipeline/search.py maps similarity ``1 - d/2`` on top).

- The host copy (fp32 numpy rows + id/metadata/document lists) is the
  source of truth. Slot capacity doubles from 1024 as rows arrive, or
  starts at ``capacity=`` / IMATCH_STORE_CAPACITY.
- The device state (``index/search.py`` ``DeviceCorpus``) covers the
  whole capacity buffer, padded to whole tiles. It is built on the
  store's device at the first query after an invalidation, from copies of
  the host buffers taken under the lock, outside the lock, and installed
  with a generation check. Mutations patch it in O(batch)
  (``index/patch.py``); a capacity growth or a compaction invalidates it.
- Deletes are tombstones; compaction rewrites the rows when more than
  half the slots are dead.
- Persistence, byte for byte JAX's: with ``persist_dir`` every mutation
  appends to ``journal.jsonl``; ``save`` writes a snapshot generation
  (``embeddings-<gen>.npy``, ``records-<gen>.json``, ``manifest.json``
  replaced last) and ``load`` reads a snapshot and replays the journal.
- Engines: ``tilemax`` (tile_n 512, margin IMATCH_TILEMAX_MARGIN, default
  4, or 16 with int8 scoring), ``pallas`` (tile_n 2048, margin 4; int8
  scoring is coerced to bf16 there, as in JAX), ``tilemax-host`` (int8
  codes on the device, fp32 rescore on the host; margin 16), ``sharded``
  (the corpus row-sharded over the store's mesh, a ``tilemax`` engine a
  shard, parallel/dist_search.py; int8 coerced to bf16), ``ivf`` and
  ``ivf-sharded`` (approximate: index/ivf.py, one IVF a shard in
  parallel/dist_ivf.py; IMATCH_IVF_NPROBE clusters probed, default 8)
  and ``auto`` (``sharded`` on a mesh of more than one device, else
  ``tilemax``, each escalated per build to ``tilemax-host`` when the
  device copies would outgrow the card, ``_engine_for``). Phase 1 of the
  exact engines runs on K1 (once a shard), the int8 tiers on its int8
  variant. Score dtypes bf16 (default), fp32 and int8.
- The mesh (parallel/mesh.py): ``mesh=`` (devices in shard order, a
  device may repeat), by default every visible CUDA device for a store on
  the card and the store's device alone on the CPU. A grid that spans
  processes (parallel/distributed.py) serves ``sharded`` and
  ``ivf-sharded``: every process holds the whole host state and makes the
  same calls, each builds, patches and searches only its own shards and
  exchanges candidates (and, for ``ivf-sharded``, its shards' host state)
  over the process group. A sidecar any process writes loads in a
  one-process store over the same shard count, which repairs it.
- The IVF host state (``_ivf_host``: trained centroids, each slot's
  cluster, the live count at the last k-means) outlives the device state:
  a build after mutations REPAIRS the index (assigns only unassigned rows
  against the existing centroids) until the live set has grown past
  IMATCH_IVF_REBUILD_FRAC (default 0.3) since k-means, then retrains. It
  follows capacity growth and compaction (the sharded kind is dropped:
  its shard boundaries move), and ``save`` writes it to ``ivf-<gen>.npz``
  (JAX's sidecar: the sharded kind only without tombstones), which
  ``load`` validates and restores: a bad sidecar retrains, never blocks.
- Each build is tagged with the engine that built it, and ``query``
  dispatches on the tag; ``stats()["last_build"]["engine"]`` reports it.
- ``query`` runs the engine at the next power of two of k and keeps the
  first k, as the JAX store does: the candidate tiles (k_c + margin) and
  so the answers on near-tied corpora are JAX's. The query count is not
  padded (JAX pads it with zero rows for its jit cache): each real row
  costs phase 2 a rescore, and a zero row would cost one too.
- ``query`` is timed as ``index.query`` (the request, coalescer queueing
  included) and each engine call as ``index.dispatch``, inside
  ``GATE.priority()`` up to its results on the host: bulk streams park
  at their next checkpoint meanwhile (runtime/scheduler.py). Inside it,
  ``index.fetch`` times a device engine's copy of its results to the
  host (the wait for every kernel queued before it on the stream); after
  it, ``index.rows`` times turning indices into id and metadata lists.
- Coalescing (runtime/coalesce.py): with ``coalesce=True``, or
  IMATCH_COALESCE=1 on a ``cuda`` store, concurrent single-row queries
  share one engine call. Off by default, as in JAX.
- ``warm`` runs the engine once for each (Q bucket, k bucket) pair on the
  live state: the kernels are built and loaded, the allocator holds the
  buffers, before the first request.
- Device-resident add: ``add`` with a ``torch.Tensor`` scatters the rows
  into the prepared state device to device (index/patch.py) and defers
  the host mirror and the journal: a d2h copy into pinned memory starts
  at once behind a CUDA event, and ``_drain_pending`` completes it at the
  next drain point (a journaled op, a rebuild, ``save``, ``checkpoint``,
  ``get(include=embeddings)``, ``flush``; at most IMATCH_PENDING_MAX
  batches, default 64, wait).
"""

from __future__ import annotations

import base64
import json
import logging
import os
import tempfile
import threading
import time
import zipfile
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from imatch_tpu_torch.device import DeviceLike, resolve_device
from imatch_tpu_torch.index import ivf as _ivf
from imatch_tpu_torch.index import patch as _patch
from imatch_tpu_torch.index.search import (
    HOST_MARGIN,
    host_rescore_topk,
    prepare_device_corpus,
    prepare_host_rescore_corpus,
    tilemax_topk,
)
from imatch_tpu_torch.parallel.dist_ivf import prepare_sharded_ivf_incremental, sharded_ivf_topk
from imatch_tpu_torch.parallel.dist_search import prepare_sharded_corpus, sharded_topk_prepared
from imatch_tpu_torch.parallel.mesh import make_mesh
from imatch_tpu_torch.runtime.scheduler import GATE
from imatch_tpu_torch.utils.metrics import METRICS

logger = logging.getLogger("imatch.store")

_MIN_CAP = 1024

_SCORE_DTYPES = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp32": torch.float32,
    "float32": torch.float32,
    "int8": torch.int8,
}
# engine -> tile_n, as the JAX engines use them (the IVF kinds have no tiles)
_ENGINES = {
    "tilemax": 512,
    "pallas": 2048,
    "tilemax-host": 512,
    "sharded": 512,
    "ivf": None,
    "ivf-sharded": None,
}
IVF_MARGIN = 32  # the IVF probe's phase-1 survivors beyond k (JAX ivf_topk's default)


def _norm_row_lists(rows, n: int, what: str) -> list:
    """Per-row sidecar list (metadatas/documents) normalized to exactly n
    entries: None or empty -> n Nones; a list of another length is a
    client error (it would misalign the sidecars with the ids)."""
    if rows is None or len(rows) == 0:
        return [None] * n
    rows = list(rows)
    if len(rows) != n:
        raise ValueError(f"{n} ids but {len(rows)} {what}")
    return rows


class _PendingRows:
    """The rows of a device-resident add on their way to the host mirror.
    On the card the copy into pinned host memory is started at once
    (``non_blocking``, asynchronous only into pinned memory) and a CUDA
    event recorded behind it; ``np.asarray`` waits on that event, not on
    the stream, and returns the rows. On the CPU the rows are copied. The
    source may be freed at once: the caching allocator hands its memory
    only to work queued after the copy on the same stream."""

    def __init__(self, rows: torch.Tensor):
        self._event = None
        if rows.is_cuda:
            self._host = torch.empty(rows.shape, dtype=torch.float32, pin_memory=True)
            self._host.copy_(rows, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(rows.device))
        else:
            self._host = rows.detach().clone()

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        out = self._host.numpy()
        return out if dtype is None else out.astype(dtype, copy=False)


def _env_engine() -> str:
    return os.environ.get("IMATCH_INDEX_ENGINE", "tilemax").lower()


def _rebuild_frac() -> float:
    """IMATCH_IVF_REBUILD_FRAC: live-set growth since the last k-means past
    which the IVF clustering is stale and retrains (default 0.3)."""
    return float(os.environ.get("IMATCH_IVF_REBUILD_FRAC", "0.3"))


def _score_dtype(name: str) -> torch.dtype:
    name = name.lower()
    if name not in _SCORE_DTYPES:
        raise ValueError(
            f"unknown score dtype {name!r}; valid: {sorted(_SCORE_DTYPES)}"
        )
    return _SCORE_DTYPES[name]


class VectorStore:
    def __init__(
        self,
        dim: Optional[int] = None,
        persist_dir: Optional[str] = None,
        engine: Optional[str] = None,
        score_dtype: Optional[str] = None,
        capacity: Optional[int] = None,
        device: DeviceLike = None,
        coalesce: Optional[bool] = None,
        mesh: Optional[Sequence] = None,
    ):
        self.device = resolve_device(device)
        self.dim = dim
        # the sharded engines' devices, in shard order (parallel/mesh.py)
        if mesh is not None:
            self._mesh = make_mesh(mesh)
        else:
            self._mesh = make_mesh() if self.device.type == "cuda" else (self.device,)
        self.engine = (engine or _env_engine()).lower()
        self._auto = self.engine == "auto"
        if self._auto:
            # the mesh-sharded exact engine on more than one device (the
            # same answers, N/P rows a device), else the single-device one;
            # either escalates per build to the capacity tier (_engine_for)
            self.engine = "sharded" if len(self._mesh) > 1 else "tilemax"
        if self.engine not in _ENGINES:
            raise ValueError(f"unknown index engine {self.engine!r}")
        self.tile_n = _ENGINES[self.engine]
        self.score_dtype = _score_dtype(
            score_dtype or os.environ.get("IMATCH_SCORE_DTYPE", "bf16")
        )
        if self.engine == "tilemax":
            default = "16" if self.score_dtype == torch.int8 else "4"
            self.margin = int(os.environ.get("IMATCH_TILEMAX_MARGIN", default))
        elif self.engine == "sharded":
            # int8 scoring runs as bf16 there, with bf16's margin
            self.margin = int(os.environ.get("IMATCH_TILEMAX_MARGIN", "4"))
        elif self.engine in ("ivf", "ivf-sharded"):
            self.margin = IVF_MARGIN
        elif self.engine == "tilemax-host":
            # for stats(): the host tier's phase 1 takes HOST_MARGIN itself,
            # also when auto escalates a tilemax store to it
            self.margin = HOST_MARGIN
        else:
            self.margin = 4
        # When set, every mutation appends to journal.jsonl in it, and a
        # snapshot (save) compacts the journal.
        self.persist_dir = persist_dir
        self._journal_len = 0
        self._lock = threading.RLock()
        self._ids: List[str] = []
        self._slot: Dict[str, int] = {}
        self._meta: List[Optional[dict]] = []
        self._docs: List[Optional[str]] = []
        self._emb: Optional[np.ndarray] = None  # (cap, D) fp32
        self._alive: Optional[np.ndarray] = None  # (cap,) bool
        self._n = 0  # slots in use (incl. tombstones)
        self._dead = 0
        self._device_corpus = None  # (engine tag, state), patched or dropped on mutation
        self._gen = 0  # bumped on every invalidation or patch (build-outside-lock)
        # queries holding a reference to the prepared state, between the
        # snapshot and their results on the host; while zero, patches
        # write into the state's tensors in place (index/patch.py)
        self._inflight = 0
        self._patched = 0  # mutations absorbed by an O(batch) patch
        self._patch_rebuilds = 0  # mutations that fell back to invalidate
        # IVF host state surviving device invalidations (lock-guarded;
        # cents immutable once trained): kind, cents, assign (int32 a slot,
        # -1 unassigned), built_live, last_mode, the append's counts (and
        # pruned_map, or the sharded kind's dp and rows)
        self._ivf_host: Optional[dict] = None
        self._last_build: Optional[dict] = None
        self._last_load: Optional[dict] = None  # stats(): load()'s seconds
        # device-resident adds whose host mirror rows and journal entries
        # are deferred: (base, k, _PendingRows, ids, metadatas, documents),
        # completed first in, first out by _drain_pending
        self._pending: List[tuple] = []
        # A slot reservation: a right-sized one means steady-state ingest
        # never grows the capacity, so every add patches. Remembered, not
        # only applied here: load() builds the store with dim=None, so the
        # first _ensure_capacity once dim is known honours it.
        if capacity is None:
            capacity = int(os.environ.get("IMATCH_STORE_CAPACITY", "0")) or None
        self._reserve = int(capacity) if capacity else 0
        if self._reserve and dim:
            self._ensure_capacity(0)
        # The dynamic-batching front, decided at construction; the worker
        # starts at the first submit. ``coalesce=None`` reads
        # IMATCH_COALESCE, for a store on the card only (JAX gates it to an
        # accelerator backend: batched scoring on the CPU is bound by its
        # multiply-adds); True forces it.
        self._coalescer = None
        if coalesce is None:
            coalesce = (
                os.environ.get("IMATCH_COALESCE", "").lower() in ("1", "true", "yes", "on")
                and self.device.type == "cuda"
            )
        if coalesce:
            self.set_coalescing(True)

    # -- capacity -----------------------------------------------------------

    def _ensure_capacity(self, extra: int):
        need = max(self._n + extra, self._reserve)
        cap = 0 if self._emb is None else self._emb.shape[0]
        if need <= cap:
            return
        new_cap = max(_MIN_CAP, cap or _MIN_CAP)
        while new_cap < need:
            new_cap *= 2
        emb = np.zeros((new_cap, self.dim), dtype=np.float32)
        alive = np.zeros((new_cap,), dtype=bool)
        if self._emb is not None:
            emb[: self._n] = self._emb[: self._n]
            alive[: self._n] = self._alive[: self._n]
        self._emb, self._alive = emb, alive
        if self._ivf_host is not None:
            if self._ivf_host.get("kind") == "ivf-sharded":
                # a growth moves the shard boundaries: per-shard
                # assignments mean nothing afterwards, so retrain
                self._ivf_host = None
            else:
                grown = np.full((new_cap,), -1, np.int32)
                old = self._ivf_host["assign"]
                grown[: old.shape[0]] = old
                self._ivf_host["assign"] = grown
        self._device_corpus = None
        self._gen += 1

    def _maybe_compact(self):
        if self._dead * 2 > self._n and self._n >= _MIN_CAP:
            keep = [i for i in range(self._n) if self._alive[i]]
            self._ids = [self._ids[i] for i in keep]
            self._meta = [self._meta[i] for i in keep]
            self._docs = [self._docs[i] for i in keep]
            emb = np.zeros_like(self._emb)
            emb[: len(keep)] = self._emb[keep]
            self._emb = emb
            self._alive = np.zeros_like(self._alive)
            self._alive[: len(keep)] = True
            self._n = len(keep)
            self._dead = 0
            self._slot = {d: i for i, d in enumerate(self._ids)}
            if self._ivf_host is not None:
                if self._ivf_host.get("kind") == "ivf-sharded":
                    # rows cross shard boundaries: shard-local clusters
                    # do not transfer, so retrain
                    self._ivf_host = None
                else:
                    remapped = np.full_like(self._ivf_host["assign"], -1)
                    remapped[: len(keep)] = self._ivf_host["assign"][keep]
                    self._ivf_host["assign"] = remapped
            self._device_corpus = None
            self._gen += 1

    # -- journal ------------------------------------------------------------

    @staticmethod
    def _enc_emb(vec: np.ndarray) -> str:
        return base64.b64encode(np.asarray(vec, np.float32).tobytes()).decode("ascii")

    @staticmethod
    def _dec_emb(s: str) -> np.ndarray:
        return np.frombuffer(base64.b64decode(s), dtype=np.float32)

    def _journal(self, *ops: dict):
        if self.persist_dir is None or not ops:
            return
        os.makedirs(self.persist_dir, exist_ok=True)
        path = os.path.join(self.persist_dir, "journal.jsonl")
        with open(path, "a", encoding="utf-8") as f:
            for op in ops:
                f.write(json.dumps(op) + "\n")
            f.flush()
            # one fsync a batch: power loss loses no acknowledged op;
            # IMATCH_JOURNAL_FSYNC=0 trades that for latency
            if os.environ.get("IMATCH_JOURNAL_FSYNC", "1") != "0":
                os.fsync(f.fileno())
        self._journal_len += len(ops)

    def checkpoint(self, force: bool = False):
        """Compact the journal into a snapshot when it has grown past a
        quarter of the live set (at least 256 ops), or always with force."""
        if self.persist_dir is None:
            return
        with self._lock:
            if force or self._journal_len >= max(256, self.count() // 4):
                self.save(self.persist_dir)

    # -- incremental device-state maintenance --------------------------------

    def _patch_or_invalidate(self, kind: str, slots, rows=None):
        """Mutation epilogue (caller holds the lock): absorb the mutation
        into the prepared state with an O(batch) patch (index/patch.py)
        instead of dropping it, which would make the next query copy and
        upload the whole corpus again. Falls back to invalidation when the
        engine or the patch declines (an IVF append past the staleness
        budget, into a pruned cluster or a full member list). The state's
        tensors are written in place only while no query holds it."""
        self._gen += 1
        dc = self._device_corpus
        if dc is None:
            return
        if not (_patch.enabled() and len(slots)):
            self._device_corpus = None
            self._patch_rebuilds += 1
            return
        slots = np.asarray(slots, np.int64)
        in_place = self._inflight == 0
        tag = dc[0]
        h = None
        if kind == "append" and tag in ("ivf", "ivf-sharded"):
            h = self._ivf_host
            if (
                h is None
                or h.get("kind") != tag
                or "counts" not in h
                or (self._n - self._dead) > h["built_live"] * (1.0 + _rebuild_frac())
            ):
                # a stale clustering: the next build retrains or repairs
                # instead of packing rows into a layout about to be replaced
                self._device_corpus = None
                self._patch_rebuilds += 1
                return
        try:
            if kind == "append":
                res = _patch.append_rows(dc, slots, rows, in_place=in_place, ivf_host=h)
                if res is not None:
                    res, host_upd = res
                    if host_upd is not None:
                        cl, counts = host_upd
                        h["assign"][slots] = cl
                        if isinstance(counts, dict):  # the sharded kind: a fill a shard
                            for s, nc in counts.items():
                                h["counts"][s] = nc
                        else:
                            h["counts"] = counts
            elif kind == "delete":
                res = _patch.delete_rows(dc, slots, in_place=in_place)
            else:
                res = _patch.update_rows(dc, slots, rows, in_place=in_place)
            if res is not None:
                self._device_corpus = res
                self._patched += 1
                return
        except Exception:
            # a failed patch degrades to the always-correct rebuild (an
            # in-place write may have run part way: the state is dropped)
            logger.exception("incremental %s patch failed; falling back to a rebuild", kind)
        self._device_corpus = None
        self._patch_rebuilds += 1

    # -- device-resident add -------------------------------------------------

    def _drain_pending(self):
        """Complete deferred device-resident adds, first in first out: the
        host mirror rows, then their journal entries (journal order is op
        order). Each batch is popped only once it has fully drained: a
        failed copy leaves it and the batches behind it pending for the
        next drain point, never dropped with live ids whose mirror rows
        are zeros and whose journal entries never land."""
        if not self._pending:
            return
        with self._lock:
            while self._pending:
                base, k, rows, ids, mds, docs = self._pending[0]
                host = np.asarray(rows, np.float32)
                self._emb[base : base + k] = host
                if self.persist_dir is not None:
                    self._journal(
                        *(
                            {
                                "op": "add",
                                "id": id_,
                                "metadata": md,
                                "document": doc,
                                "embedding": self._enc_emb(host[i]),
                            }
                            for i, (id_, md, doc) in enumerate(zip(ids, mds, docs))
                        )
                    )
                self._pending.pop(0)

    def _add_device(self, ids, emb: torch.Tensor, metadatas, documents):
        """``add`` with the embeddings in a tensor (straight out of the
        image tower): the rows are scattered device to device into the
        prepared state (index/patch.py) and never cross to the host on the
        hot path. The host fp32 mirror and the journal entries wait for
        the next drain point (``_drain_pending``); ``flush``,
        ``checkpoint`` and the launcher's SIGTERM snapshot drain first.
        With a journal, an op's durability widens to that drain point.

        The caller (``add``) holds the lock and has checked ``ids``."""
        if emb.ndim == 1:
            emb = emb[None]
        if emb.ndim != 2 or emb.shape[0] != len(ids):
            raise ValueError(f"{len(ids)} ids but embeddings of shape {tuple(emb.shape)}")
        if self.dim is None:
            self.dim = int(emb.shape[1])
        elif int(emb.shape[1]) != self.dim:
            # the host path would raise at the slice copy; the device path
            # must not find out at drain time
            raise ValueError(f"embedding dim {emb.shape[1]} != store dim {self.dim}")
        metadatas = _norm_row_lists(metadatas, len(ids), "metadatas")
        documents = _norm_row_lists(documents, len(ids), "documents")
        seen = set()
        for i in ids:
            if i in self._slot or i in seen:
                raise ValueError(f"duplicate id {i}")
            seen.add(i)
        emb = emb.detach().to(device=self.device, dtype=torch.float32)
        rows = _PendingRows(emb)
        self._ensure_capacity(len(ids))
        base = self._n
        self._alive[base : base + len(ids)] = True
        self._ids.extend(ids)
        self._meta.extend(metadatas)
        self._docs.extend(documents)
        self._slot.update(zip(ids, range(base, base + len(ids))))
        self._n = base + len(ids)
        self._pending.append((base, len(ids), rows, list(ids), list(metadatas), list(documents)))
        self._patch_or_invalidate("append", np.arange(base, self._n, dtype=np.int64), emb)
        # bound the pinned host memory of undrained batches and how far the
        # journal lags behind the acknowledged adds
        if len(self._pending) >= int(os.environ.get("IMATCH_PENDING_MAX", "64")):
            self._drain_pending()

    def flush(self):
        """Complete any deferred device-resident adds (host mirror and
        journal). A no-op unless ``add`` was given a tensor."""
        with self._lock:
            self._drain_pending()

    # -- chroma-like API ----------------------------------------------------

    def add(
        self,
        ids: Sequence[str],
        embeddings,
        metadatas: Optional[Sequence[dict]] = None,
        documents: Optional[Sequence[Optional[str]]] = None,
    ):
        if not len(ids):
            # chroma parity: an empty add is a client error
            raise ValueError("expected non-empty ids for add")
        with self._lock:
            if isinstance(embeddings, torch.Tensor):
                return self._add_device(ids, embeddings, metadatas, documents)
            if self._pending and self.persist_dir is not None:
                # journal order is op order: deferred device adds first
                self._drain_pending()
            embeddings = np.asarray(embeddings, dtype=np.float32)
            if embeddings.ndim == 1:
                embeddings = embeddings[None]
            # every check precedes any mutation
            if embeddings.shape[0] != len(ids):
                raise ValueError(
                    f"{len(ids)} ids but {embeddings.shape[0]} embeddings"
                )
            if self.dim is None:
                self.dim = int(embeddings.shape[1])
            elif embeddings.ndim != 2 or int(embeddings.shape[1]) != self.dim:
                raise ValueError(
                    f"embedding shape {embeddings.shape} != "
                    f"({len(ids)}, {self.dim})"
                )
            metadatas = _norm_row_lists(metadatas, len(ids), "metadatas")
            documents = _norm_row_lists(documents, len(ids), "documents")
            seen = set()
            for i in ids:
                # duplicates against the collection AND within the batch
                if i in self._slot or i in seen:
                    raise ValueError(f"duplicate id {i}")
                seen.add(i)
            self._ensure_capacity(len(ids))
            base = self._n
            self._emb[base : base + len(ids)] = embeddings
            self._alive[base : base + len(ids)] = True
            self._ids.extend(ids)
            self._meta.extend(metadatas)
            self._docs.extend(documents)
            self._slot.update(zip(ids, range(base, base + len(ids))))
            self._n = base + len(ids)
            self._patch_or_invalidate("append", np.arange(base, self._n, dtype=np.int64), embeddings)
            if self.persist_dir is not None:
                # ops are built only when a journal exists: the base64
                # encode dominates a bulk add otherwise
                self._journal(
                    *(
                        {
                            "op": "add",
                            "id": id_,
                            "metadata": md,
                            "document": doc,
                            "embedding": self._enc_emb(embeddings[i]),
                        }
                        for i, (id_, md, doc) in enumerate(zip(ids, metadatas, documents))
                    )
                )

    def get(
        self,
        ids: Optional[Sequence[str]] = None,
        include: Sequence[str] = ("metadatas", "documents"),
    ) -> dict:
        with self._lock:
            if "embeddings" in include:
                self._drain_pending()
            if ids is None:
                slots = [i for i in range(self._n) if self._alive[i]]
            else:
                slots = [
                    self._slot[i]
                    for i in ids
                    if i in self._slot and self._alive[self._slot[i]]
                ]
            out = {"ids": [self._ids[s] for s in slots]}
            if "metadatas" in include:
                out["metadatas"] = [self._meta[s] for s in slots]
            if "documents" in include:
                out["documents"] = [self._docs[s] for s in slots]
            if "embeddings" in include:
                out["embeddings"] = (
                    self._emb[slots].copy() if slots else np.zeros((0, self.dim or 0))
                )
            return out

    def update(
        self,
        ids: Sequence[str],
        embeddings=None,
        metadatas: Optional[Sequence[dict]] = None,
    ):
        with self._lock:
            # a pending device add of one of these slots drains first, or
            # its deferred host fill would overwrite the update (and the
            # journal would hold the ops out of order)
            self._drain_pending()
            # validate every id, length and shape before touching any state
            slots_all: List[int] = []
            for id_ in ids:
                slot = self._slot.get(id_)
                if slot is None or not self._alive[slot]:
                    raise KeyError(id_)
                slots_all.append(slot)
            if metadatas is not None and len(metadatas) != len(ids):
                raise ValueError(f"{len(ids)} ids but {len(metadatas)} metadatas")
            if embeddings is not None:
                if isinstance(embeddings, torch.Tensor):
                    embeddings = embeddings.detach().float().cpu().numpy()
                embeddings = np.asarray(embeddings, dtype=np.float32)
                if embeddings.ndim == 1:
                    embeddings = embeddings[None]
                if embeddings.shape != (len(ids), self.dim):
                    raise ValueError(
                        f"embedding shape {embeddings.shape} != "
                        f"({len(ids)}, {self.dim})"
                    )
            emb_slots: List[int] = []
            ops: List[dict] = []
            for i, (id_, slot) in enumerate(zip(ids, slots_all)):
                if metadatas is not None:
                    self._meta[slot] = metadatas[i]
                if embeddings is not None:
                    self._emb[slot] = embeddings[i]
                    if self._ivf_host is not None:
                        # its nearest centroid may have changed: -1
                        # re-enters it through the repair pass
                        self._ivf_host["assign"][slot] = -1
                    emb_slots.append(slot)
                op = {"op": "update", "id": id_}
                if metadatas is not None:
                    op["metadata"] = metadatas[i]
                if embeddings is not None:
                    op["embedding"] = self._enc_emb(embeddings[i])
                ops.append(op)
            # one journal write and fsync for the whole batch
            self._journal(*ops)
            if emb_slots:
                self._patch_or_invalidate(
                    "update", np.asarray(emb_slots, np.int64), self._emb[emb_slots]
                )

    def delete(self, ids: Sequence[str]):
        with self._lock:
            self._drain_pending()  # journal order; compaction reads the mirror
            deleted = []
            slots = []
            for id_ in ids:
                slot = self._slot.pop(id_, None)
                if slot is not None and self._alive[slot]:
                    self._alive[slot] = False
                    self._dead += 1
                    deleted.append(id_)
                    slots.append(slot)
            if deleted:
                gen0 = self._gen
                self._maybe_compact()
                if self._gen == gen0:
                    # no compaction: clearing validity entries suffices
                    self._patch_or_invalidate("delete", np.asarray(slots, np.int64))
            self._journal(*({"op": "delete", "id": i} for i in deleted))

    def count(self) -> int:
        with self._lock:
            return self._n - self._dead

    def stats(self) -> dict:
        """Operational snapshot: engine, occupancy, journal, patches and
        the last device build."""
        with self._lock:
            cap = 0 if self._emb is None else self._emb.shape[0]
            out = {
                "engine": self.engine,
                "device": str(self.device),
                "dim": self.dim,
                "live": self._n - self._dead,
                "slots": self._n,
                "tombstones": self._dead,
                "capacity": cap,
                "score_dtype": str(self.score_dtype).replace("torch.", ""),
                "tile_n": self.tile_n,
                "margin": self.margin,
                "coalescing": self._coalescer is not None,
                "device_ready": self._device_corpus is not None,
                "journal_ops": self._journal_len,
                # incremental mutation health: patched should dominate
                # rebuilds in steady state (index/patch.py)
                "patched_mutations": self._patched,
                "rebuild_mutations": self._patch_rebuilds,
                # device-resident adds whose host mirror rows and journal
                # entries wait for the next drain point
                "pending_host_syncs": len(self._pending),
            }
            h = self._ivf_host
            if h is not None:
                cents = h["cents"] if isinstance(h["cents"], list) else [h["cents"]]
                out["ivf"] = {
                    "kind": h["kind"],
                    "clusters": sum(int(c.shape[0]) for c in cents),
                    "built_live": int(h["built_live"]),
                    "last_mode": h.get("last_mode"),
                }
            if self._last_build is not None:
                out["last_build"] = dict(self._last_build)
            if self._last_load is not None:
                out["last_load"] = dict(self._last_load)
            return out

    # -- search -------------------------------------------------------------

    def _engine_for(self, emb_copy: np.ndarray) -> str:
        """Effective engine for one build (JAX ``_engine_for``). With
        IMATCH_INDEX_ENGINE=auto, when the device copies of the tilemax or
        sharded engine (score dtype, int8 counted as 2 bytes as in JAX,
        plus the fp32 rescore copy; for sharded, divided over the mesh's
        distinct devices) would exceed IMATCH_AUTO_HBM_FRAC (default 0.5)
        of a card's memory (IMATCH_DEVICE_BYTES_BUDGET, else the card's
        total), the build escalates to tilemax-host, whose int8 codes on
        one card are the only device copy, where that is the smaller
        footprint. The footprint counts the capacity buffer the build
        uploads (``emb_copy``), as JAX's does. A non-auto engine is never
        overridden."""
        eng = self.engine
        if not self._auto or eng not in ("tilemax", "sharded"):
            return eng
        budget = os.environ.get("IMATCH_DEVICE_BYTES_BUDGET")
        if budget is None and self.device.type == "cuda":
            budget = torch.cuda.mem_get_info(self.device)[1]
        if not budget:
            return eng
        elems = emb_copy.size
        score_bytes = 2 if self.score_dtype == torch.int8 else self.score_dtype.itemsize
        per_device = elems * (score_bytes + 4)
        if eng == "sharded":
            per_device //= len(set(self._mesh))
        host_tier = elems  # the int8 codes alone
        frac = float(os.environ.get("IMATCH_AUTO_HBM_FRAC", "0.5"))
        limit = frac * float(budget)
        if per_device > limit and host_tier < per_device:
            logger.warning(
                "auto index engine: %.2f GB on the device exceeds %.0f%% of "
                "%.2f GB%s; escalating to tilemax-host for this build",
                per_device / 2**30,
                frac * 100,
                float(budget) / 2**30,
                " and even the int8 host tier exceeds it" if host_tier > limit else "",
            )
            return "tilemax-host"
        return eng

    def _capture_ivf(self) -> Optional[dict]:
        """A copy of the IVF host state for a build off the lock (caller
        holds the lock): ``assign`` is copied, since the repair writes into
        it while writers may mutate the original; ``cents`` are immutable
        once trained."""
        h = self._ivf_host
        if h is None:
            return None
        snap = dict(h)
        snap["assign"] = h["assign"].copy()
        return snap

    def _build_ivf(self, emb_copy: np.ndarray, alive_copy: np.ndarray, snap: Optional[dict]):
        """The single-device IVF build with incremental repair (JAX
        ``_build_ivf``). With host state from an earlier build and a live
        set grown at most IMATCH_IVF_REBUILD_FRAC since its k-means, only
        rows with no cluster yet (new adds, updated vectors, reused slots)
        are assigned against the EXISTING centroids, and the member lists
        repacked; past it the clustering is stale and k-means reruns.
        Returns ``(state, host_state)``."""
        cap = emb_copy.shape[0]
        live = int(alive_copy.sum())
        corpus = _ivf._as_corpus(emb_copy, self.device)  # one upload for every stage
        if (
            snap is not None
            and snap.get("kind", "ivf") == "ivf"
            and snap["cents"].shape[1] == emb_copy.shape[1]
            and live <= snap["built_live"] * (1.0 + _rebuild_frac())
        ):
            assign = snap["assign"]
            if assign.shape[0] < cap:
                assign = np.concatenate([assign, np.full((cap - assign.shape[0],), -1, np.int32)])
            else:
                assign = assign[:cap]
            assign[~alive_copy] = -1  # dead slots: a reused slot must repair
            fresh = np.nonzero((assign == -1) & alive_copy)[0]
            try:
                if fresh.size:
                    rows = corpus[torch.from_numpy(fresh).to(self.device)]
                    assign[fresh] = _ivf.assign_rows(rows, snap["cents"])
                state, pack_stats = _ivf.pack_ivf_stats(corpus, alive_copy, snap["cents"], assign)
            except (IndexError, ValueError) as e:
                # semantically corrupt host state (a bad sidecar past the
                # load's checks) retrains, never poisons the serving path
                logger.warning("IVF repair failed (%s); retraining from scratch", e)
                return self._build_ivf(emb_copy, alive_copy, None)
            host = {
                "kind": "ivf",
                "cents": snap["cents"],
                "assign": assign,
                "built_live": snap["built_live"],
                "last_mode": "repair",
                **pack_stats,
            }
            return state, host
        cents = _ivf.train_centroids(corpus, alive_copy)
        assign = _ivf.assign_rows(corpus, cents)
        # the streamed argmax assigned EVERY slot, dead and padding rows
        # (zeros) too: stamped unassigned, or rows added there later would
        # pass as placed and be packed into the wrong member list
        assign[~alive_copy] = -1
        cents_np = cents.cpu().numpy()
        state, pack_stats = _ivf.pack_ivf_stats(corpus, alive_copy, cents_np, assign)
        return state, {
            "kind": "ivf",
            "cents": cents_np,
            "assign": assign,
            "built_live": live,
            "last_mode": "train",
            **pack_stats,
        }

    def _build_device(self, emb_copy: np.ndarray, alive_copy: np.ndarray, ivf_snap: Optional[dict] = None):
        """``((engine tag, state), ivf_host)`` over the whole capacity
        buffer, from COPIES of the host buffers (on the CPU a tensor can
        alias numpy memory that writers mutate in place), and for the IVF
        kinds ``ivf_snap`` (``_capture_ivf``). ``ivf_host`` is the IVF
        kinds' updated host state (None for the other engines), installed
        by the caller under the same generation check as the device state.
        Runs outside the store lock: at capacity scale the upload and
        quantize take from a second to ten, and must not block writers."""
        t0 = time.perf_counter()
        eng = self._engine_for(emb_copy)
        ivf_host = None
        if eng == "tilemax-host":
            # host-side quantize: only the int8 codes cross to the card
            state = prepare_host_rescore_corpus(
                emb_copy, alive_copy, tile_n=self.tile_n, device=self.device
            )
        elif eng == "sharded":
            state = prepare_sharded_corpus(
                emb_copy, alive_copy, mesh=self._mesh, score_dtype=self.score_dtype, tile_n=512, margin=self.margin
            )
        elif eng == "ivf":
            state, ivf_host = self._build_ivf(emb_copy, alive_copy, ivf_snap)
        elif eng == "ivf-sharded":
            snap = ivf_snap if ivf_snap and ivf_snap.get("kind") == "ivf-sharded" else None
            state, ivf_host = prepare_sharded_ivf_incremental(emb_copy, alive_copy, mesh=self._mesh, snap=snap)
        else:
            dtype = self.score_dtype
            if eng == "pallas" and dtype == torch.int8:
                dtype = torch.bfloat16  # int8 is a tilemax option, as in JAX
            state = prepare_device_corpus(
                emb_copy,
                alive_copy,
                tile_n=self.tile_n,
                score_dtype=dtype,
                margin=self.margin,
                device=self.device,
            )
        for dev in set(self._mesh) | {self.device}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # the build's time, not its enqueue
        # info-only write; racing builds yield slightly stale stats()
        self._last_build = {
            "engine": eng,
            "seconds": round(time.perf_counter() - t0, 3),
            "rows": int(emb_copy.shape[0]),
        }
        return (eng, state), ivf_host

    def _device_state(self):
        """The prepared state, built under the lock if there is none
        (caller need not hold it). For internal and test use: the query
        path goes through ``_snapshot_for_query``, which builds outside
        the lock. A mutation after this returns may patch the state in
        place; do not hold it across mutations."""
        with self._lock:
            if self._device_corpus is None:
                if self._emb is None:
                    return None
                self._drain_pending()  # the build reads the host mirror
                dc, ivf_host = self._build_device(self._emb.copy(), self._alive.copy(), self._capture_ivf())
                self._device_corpus = dc
                if ivf_host is not None:
                    self._ivf_host = ivf_host
            return self._device_corpus

    def _run_engine(self, q, dc, k: int):
        """One engine call on the prepared state ``dc`` (``_build_device``'s
        pair): (Q, k) scores and indices as numpy arrays, so the results
        are on the host when it returns."""
        if not isinstance(q, torch.Tensor):
            q = torch.from_numpy(np.asarray(q, dtype=np.float32))
        eng, state = dc
        q = q.float().to(self.device)
        if eng == "tilemax-host":
            return host_rescore_topk(q, state, k=k)
        if eng == "sharded":
            scores, idx = sharded_topk_prepared(q, state, k=k)
        elif eng in ("ivf", "ivf-sharded"):
            n_probe = int(os.environ.get("IMATCH_IVF_NPROBE", "8"))
            topk = _ivf.ivf_topk if eng == "ivf" else sharded_ivf_topk
            scores, idx = topk(q, state, k=k, n_probe=n_probe, rescore_margin=self.margin)
        else:
            scores, idx = tilemax_topk(q, state, k=k)
        with METRICS.timer("index.fetch"):
            return scores.cpu().numpy(), idx.cpu().numpy()

    @staticmethod
    def _k_bucket(k: int) -> int:
        """The next power of two: the JAX store runs its engines at this k
        (a jit cache key there), so its candidate tiles are k_c + margin."""
        return 1 << max(0, k - 1).bit_length()

    def _snapshot_for_query(self):
        """Consistent (live count, device state, id/meta/doc lists). Safe
        to read lock-free afterwards: ``add`` only appends (indices in the
        captured state stay valid), ``delete`` only flips the alive mask,
        and compaction *rebinds* the lists rather than mutating them, so
        the captured references keep the layout the captured state was
        built from. A patch writes into the captured tensors only when no
        query holds them: this one does, from here to ``_release_snapshot``.

        The buffer COPY happens under the lock (consistency), but the
        build (upload and quantize, seconds at capacity scale) runs
        OUTSIDE it and is installed with a generation check, so writers
        never wait on a rebuild."""
        with self._lock:
            live = self.count()
            dc = self._device_corpus
            ids_l, meta_l, docs_l = self._ids, self._meta, self._docs
            gen = self._gen
            if dc is None:
                if self._emb is None:
                    return live, None, ids_l, meta_l, docs_l
                self._drain_pending()  # the build reads the host mirror
                emb = self._emb.copy()
                alive = self._alive.copy()
                ivf_snap = self._capture_ivf()
            else:
                self._inflight += 1
        if dc is None:
            dc, ivf_host = self._build_device(emb, alive, ivf_snap)
            with self._lock:
                if self._gen == gen and self._device_corpus is None:
                    self._device_corpus = dc
                    if ivf_host is not None:
                        self._ivf_host = ivf_host
                # a concurrent mutation invalidated or patched the store:
                # dc is still consistent with the lists captured above, so
                # THIS query serves it (its host state is discarded); the
                # next one builds afresh. Either way it now holds a state a
                # later patch could write into.
                self._inflight += 1
        return live, dc, ids_l, meta_l, docs_l

    def _release_snapshot(self, dc):
        """Drop the hold taken by ``_snapshot_for_query`` (none was taken
        for an empty store)."""
        if dc is None:
            return
        with self._lock:
            self._inflight -= 1

    def warm(
        self,
        n_results_list: Sequence[int] = (1, 10, 25, 50, 100, 1000),
        q_counts: Sequence[int] = (1,),
    ):
        """Run the engine once for each (Q bucket, k bucket) pair that
        serving uses (the limit select's 10/25/50/100/All -> 1000, and
        ``q_counts``, the query counts of ``/api/search/batch`` and the
        coalescer, bucketed to powers of two), on the live state: the
        kernels are built and loaded and the allocator holds the buffers
        before the first request. ``query`` runs at the real count (no jit
        cache to key), so the Q buckets only size those buffers. Mutates
        nothing."""
        live, dc, _, _, _ = self._snapshot_for_query()
        try:
            if dc is None or live == 0:
                return
            seen = set()
            for qc in q_counts:
                q = torch.zeros((self._k_bucket(qc), self.dim), dtype=torch.float32)
                for nr in n_results_list:
                    k_c = self._k_bucket(min(nr, live))
                    if (q.shape[0], k_c) in seen:
                        continue
                    seen.add((q.shape[0], k_c))
                    self._run_engine(q, dc, k_c)
        finally:
            self._release_snapshot(dc)

    def set_coalescing(self, enabled: bool):
        """Turn the dynamic-batching front on or off; off stops the
        worker thread and drops its reference to this store."""
        if enabled and self._coalescer is None:
            from imatch_tpu_torch.runtime.coalesce import QueryCoalescer

            self._coalescer = QueryCoalescer(self._query_impl)
        elif not enabled and self._coalescer is not None:
            self._coalescer.close()
            self._coalescer = None

    @property
    def coalescing(self) -> bool:
        return self._coalescer is not None

    def query(
        self,
        query_embeddings,
        n_results: int = 10,
        include: Sequence[str] = ("metadatas", "distances"),
    ) -> dict:
        """Chroma-shaped result: lists of lists, ascending cosine distance.
        ``query_embeddings`` may be a tensor already on the device (the
        embedder's output), which then feeds the engine with no host copy.
        The engine runs outside the store lock: writers never wait for a
        query. With coalescing on, concurrent single-row queries share one
        engine call (runtime/coalesce.py)."""
        if isinstance(query_embeddings, torch.Tensor):
            q = query_embeddings.float()
        else:
            q = torch.from_numpy(np.asarray(query_embeddings, dtype=np.float32))
        if q.ndim == 1:
            q = q[None]
        with METRICS.timer("index.query"):
            c = self._coalescer  # one read: set_coalescing(False) may race
            if q.shape[0] == 1 and c is not None:
                from imatch_tpu_torch.runtime.coalesce import CoalescerClosed

                try:
                    return c.submit(q, n_results, tuple(include))
                except CoalescerClosed:
                    pass  # turned off meanwhile: serve directly
            return self._query_impl(q, n_results, include)

    def _query_impl(self, q: torch.Tensor, n_results: int, include: Sequence[str]) -> dict:
        """``query`` on a (Q, D) tensor, without the coalescer."""
        qn = q.shape[0]
        live, dc, ids_l, meta_l, docs_l = self._snapshot_for_query()
        try:
            out = {"ids": [], "distances": [], "metadatas": [], "documents": []}
            k = min(n_results, live)
            if live == 0 or k <= 0:
                for key in out:
                    out[key] = [[] for _ in range(qn)]
                return self._strip_include(out, include)
            # Q is not padded to a power of two as in JAX, where it keys
            # the jit cache: the port has none, and a zero row would cost
            # phase 2 a full rescore and K1 a corpus read a 16-row block
            with METRICS.timer("index.dispatch"), GATE.priority():
                # the section ends with the results on the host: bulk
                # streams park at their next checkpoint until then
                scores, idx = self._run_engine(q, dc, self._k_bucket(k))
        finally:
            self._release_snapshot(dc)
        scores, idx = scores[:, :k], idx[:, :k]
        with METRICS.timer("index.rows"):
            for qi in range(qn):
                row_ids, row_d, row_m, row_doc = [], [], [], []
                for s, i in zip(scores[qi], idx[qi]):
                    if i < 0:
                        continue
                    row_ids.append(ids_l[i])
                    row_d.append(float(1.0 - s))  # chroma cosine distance
                    row_m.append(meta_l[i])
                    row_doc.append(docs_l[i])
                out["ids"].append(row_ids)
                out["distances"].append(row_d)
                out["metadatas"].append(row_m)
                out["documents"].append(row_doc)
        return self._strip_include(out, include)

    @staticmethod
    def _strip_include(out: dict, include: Sequence[str]) -> dict:
        """Drop the keys the caller did not ask for; one definition for
        the empty store and the scored path."""
        for key in ("metadatas", "documents", "distances"):
            if key not in include:
                out.pop(key)
        return out

    # -- persistence --------------------------------------------------------

    def save(self, path: Optional[str] = None):
        """Atomic durable snapshot (compacted); resets the journal.

        Data files are written under new ``embeddings-<gen>.npy`` /
        ``records-<gen>.json`` names (the records one JSON array) and the
        manifest, replaced last, is the commit record that points at them:
        a crash at any point leaves the previous generation intact.

        The IVF sidecar ``ivf-<gen>.npz`` (JAX's keys: ``kind``, ``cents``
        or the sharded kind's ``cents_{i}``, ``dp`` and ``rows``,
        ``assign`` in snapshot order, ``built_live``, the live count at the
        last k-means) lets a restarted IVF store repair instead of
        retraining. The sharded kind's assignments depend on slot
        positions (shard = slot // rows), so it is written only when the
        snapshot keeps them: with no tombstones."""
        path = path or self.persist_dir
        if path is None:
            raise ValueError("no path and no persist_dir")
        with self._lock:
            self._drain_pending()  # the snapshot reads the host mirror
            os.makedirs(path, exist_ok=True)
            slots = [i for i in range(self._n) if self._alive[i]]
            gen = int(time.time() * 1e6)
            emb_name = f"embeddings-{gen}.npy"
            rec_name = f"records-{gen}.json"
            h = self._ivf_host
            ivf_name = (
                f"ivf-{gen}.npz"
                if h is not None
                and (h.get("kind") == "ivf" or (h.get("kind") == "ivf-sharded" and self._dead == 0))
                else None
            )
            tmp = tempfile.mkdtemp(dir=path, prefix=".snapshot-")
            try:
                with open(os.path.join(tmp, emb_name), "wb") as f:
                    np.save(
                        f,
                        self._emb[slots] if slots else np.zeros((0, self.dim or 0), np.float32),
                    )
                    f.flush()
                    os.fsync(f.fileno())
                with open(os.path.join(tmp, rec_name), "w", encoding="utf-8") as f:
                    json.dump(
                        [
                            {"id": self._ids[s], "metadata": self._meta[s], "document": self._docs[s]}
                            for s in slots
                        ],
                        f,
                    )
                    f.flush()
                    os.fsync(f.fileno())
                if ivf_name is not None:
                    with open(os.path.join(tmp, ivf_name), "wb") as f:
                        np.savez(f, **self._ivf_payload(slots))
                        f.flush()
                        os.fsync(f.fileno())
                os.replace(os.path.join(tmp, emb_name), os.path.join(path, emb_name))
                os.replace(os.path.join(tmp, rec_name), os.path.join(path, rec_name))
                if ivf_name is not None:
                    os.replace(os.path.join(tmp, ivf_name), os.path.join(path, ivf_name))
                mpath = os.path.join(tmp, "manifest.json")
                manifest = {
                    "dim": self.dim,
                    "count": len(slots),
                    "embeddings": emb_name,
                    "records": rec_name,
                    "generation": gen,
                }
                if ivf_name is not None:
                    manifest["ivf"] = ivf_name
                with open(mpath, "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(mpath, os.path.join(path, "manifest.json"))
            finally:
                for leftover in os.listdir(tmp):
                    os.unlink(os.path.join(tmp, leftover))
                os.rmdir(tmp)
            journal = os.path.join(path, "journal.jsonl")
            if os.path.exists(journal):
                os.unlink(journal)
            self._journal_len = 0
            # collect superseded generations (and legacy names)
            for f in os.listdir(path):
                if f.startswith(("embeddings", "records", "ivf")) and f not in (emb_name, rec_name, ivf_name):
                    try:
                        os.unlink(os.path.join(path, f))
                    except OSError:
                        pass

    def _ivf_payload(self, slots) -> dict:
        """The IVF sidecar's arrays for a snapshot of ``slots``."""
        h = self._ivf_host
        payload = {"assign": h["assign"][slots] if slots else np.zeros((0,), np.int32)}
        if h.get("kind") == "ivf-sharded":
            payload.update(kind=np.str_("ivf-sharded"), dp=np.int64(h["dp"]), rows=np.int64(h["rows"]))
            for si, c in enumerate(h["cents"]):
                payload[f"cents_{si}"] = c
        else:
            payload.update(kind=np.str_("ivf"), cents=h["cents"])
        # the live count at the LAST K-MEANS, not the snapshot's: the
        # snapshot's would ratchet the retrain baseline up across restarts
        payload["built_live"] = np.int64(h["built_live"])
        return payload

    @staticmethod
    def _read_ivf_sidecar(path: str, dim: int, n_records: int) -> Optional[dict]:
        """The IVF host state of a sidecar (``assign`` in snapshot order),
        or None where it is unreadable or does not match the snapshot (the
        dim, the row count, assignments out of range): a bad sidecar is
        logged and the next build retrains; it never blocks a restart. For
        the sharded kind the build decides whether ``dp`` and ``rows`` fit
        the current mesh and capacity (parallel/dist_ivf.py)."""
        try:
            with np.load(path) as z:
                kind = str(z["kind"]) if "kind" in z else "ivf"
                assign = np.asarray(z["assign"], np.int32)
                built_live = int(z["built_live"]) if "built_live" in z else n_records
                if kind == "ivf-sharded":
                    cents = [np.asarray(z[f"cents_{si}"], np.float32) for si in range(int(z["dp"]))]
                    extra = {"dp": int(z["dp"]), "rows": int(z["rows"])}
                    dim_ok = all(c.ndim == 2 and c.shape[1] == dim for c in cents)
                    max_c = max((c.shape[0] for c in cents), default=0)
                else:
                    cents = np.asarray(z["cents"], np.float32)
                    extra = {}
                    dim_ok = cents.ndim == 2 and cents.shape[1] == dim
                    max_c = cents.shape[0]
                range_ok = bool(np.all(assign >= -1) and np.all(assign < max_c)) if assign.size else True
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            logger.warning("ignoring unreadable IVF sidecar %s", path)
            return None
        if not (dim_ok and range_ok and assign.shape[0] == n_records):
            logger.warning("ignoring IVF sidecar %s: it does not match the snapshot", path)
            return None
        return {"kind": kind, "cents": cents, "assign": assign, "built_live": built_live, **extra}

    @classmethod
    def load(
        cls, path: str, persist: bool = True, device: DeviceLike = None, mesh: Optional[Sequence] = None
    ) -> "VectorStore":
        """Rehydrate: snapshot first, then the IVF sidecar (before the
        replay, so replayed mutations are tracked as unassigned rows), then
        the journal. With ``persist`` the returned store keeps journaling
        into ``path``. Engine and score dtype come from the environment,
        as in JAX; the store lives on ``device`` (the card unless the CPU
        is asked for), its sharded engines on ``mesh``.
        ``stats()["last_load"]`` records the seconds of the snapshot read
        and of the replay."""
        t0 = time.perf_counter()
        manifest_path = os.path.join(path, "manifest.json")
        store = cls(device=device, mesh=mesh)
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                manifest = json.load(f)
            store.dim = manifest["dim"]
            emb_file = manifest.get("embeddings", "embeddings.npy")
            rec_file = manifest.get("records", "records.jsonl")
            emb = np.load(os.path.join(path, emb_file))
            with open(os.path.join(path, rec_file), encoding="utf-8") as f:
                if rec_file.endswith(".jsonl"):
                    # legacy line-per-record snapshots
                    records = [json.loads(line) for line in f if line.strip()]
                else:
                    records = json.load(f)
            count = manifest.get("count", len(records))
            if not (len(records) == count == emb.shape[0]):
                raise ValueError(
                    f"corrupt snapshot in {path}: manifest count {count}, "
                    f"{len(records)} records, {emb.shape[0]} embedding rows"
                )
            if records:
                store.add(
                    ids=[r["id"] for r in records],
                    embeddings=emb,
                    metadatas=[r["metadata"] for r in records],
                    documents=[r["document"] for r in records],
                )
            ivf_file = manifest.get("ivf")
            if ivf_file and store._emb is not None:
                h = cls._read_ivf_sidecar(os.path.join(path, ivf_file), store.dim, len(records))
                if h is not None:
                    full = np.full((store._emb.shape[0],), -1, np.int32)
                    full[: h["assign"].shape[0]] = h["assign"]
                    store._ivf_host = {**h, "assign": full}
        t1 = time.perf_counter()
        journal = os.path.join(path, "journal.jsonl")
        replayed = 0
        if os.path.exists(journal):
            with open(journal, "rb") as bf:
                raw = bf.read()
            # scan by byte offset, so a torn tail (a crash mid-append) can
            # be TRUNCATED: the next append would glue onto the fragment
            # and every later op would be lost at the next restart
            good_end = 0
            torn = False
            pos = 0
            for chunk in raw.split(b"\n"):
                end = min(pos + len(chunk) + 1, len(raw))
                line = chunk.decode("utf-8", "replace").strip()
                if not line:
                    pos = good_end = end
                    continue
                try:
                    op = json.loads(line)
                except json.JSONDecodeError:
                    torn = True
                    break
                pos = good_end = end
                try:
                    if op["op"] == "add":
                        store.add(
                            ids=[op["id"]],
                            embeddings=[cls._dec_emb(op["embedding"])],
                            metadatas=[op.get("metadata")],
                            documents=[op.get("document")],
                        )
                    elif op["op"] == "update":
                        store.update(
                            ids=[op["id"]],
                            embeddings=[cls._dec_emb(op["embedding"])] if "embedding" in op else None,
                            metadatas=[op["metadata"]] if "metadata" in op else None,
                        )
                    elif op["op"] == "delete":
                        store.delete([op["id"]])
                    replayed += 1
                except (KeyError, ValueError):
                    continue  # idempotent replay: duplicate adds etc.
            if torn and persist:
                with open(journal, "r+b") as bf:
                    bf.truncate(good_end)
        if persist:
            store.persist_dir = path
            store._journal_len = replayed
        store._last_load = {
            "snapshot_s": round(t1 - t0, 3),
            "replay_s": round(time.perf_counter() - t1, 3),
            "replayed_ops": replayed,
        }
        return store
