"""Vector store with ChromaDB-collection semantics, on the card.

Counterpart of ``imatch_tpu/index/store.py`` ``VectorStore``, with this
slice's subset of it: ``add`` (with the up-front validation), ``get``
with ``include=``, ``update``, ``delete`` (tombstones), ``count``,
``stats`` and ``query``, which returns cosine *distance* ``1 - cos`` like
a chroma cosine collection (pipeline/search.py maps similarity
``1 - d/2`` on top).

- The host copy (fp32 numpy rows + id/metadata/document lists) is the
  source of truth. Slot capacity doubles from 1024 as rows arrive.
- The device state (``index/search.py`` ``DeviceCorpus``) is built on the
  store's device at the first query after a mutation and reused until the
  next one; it covers the slots in use, padded to whole tiles.
- Deletes are tombstones; compaction rewrites the rows when more than
  half the slots are dead.
- Engines: ``tilemax`` (tile_n 512, margin IMATCH_TILEMAX_MARGIN, default
  4, or 16 with int8 scoring), ``pallas`` (tile_n 2048, margin 4; int8
  scoring is coerced to bf16 there, as in JAX), ``tilemax-host`` (int8
  codes on the device, fp32 rescore on the host; margin 16) and ``auto``
  (``tilemax`` on one GPU, escalated per build to ``tilemax-host`` when
  the device copies would outgrow the card, ``_engine_for``). Phase 1 of
  each runs on K1, the int8 tiers on its int8 variant. Score dtypes bf16
  (default), fp32 and int8.
- Each build is tagged with the engine that built it, and ``query``
  dispatches on the tag; ``stats()["last_build"]["engine"]`` reports it.
- ``query`` runs the engine at the next power of two of k and keeps the
  first k, as the JAX store does: the candidate tiles (k_c + margin) and
  so the answers on near-tied corpora are JAX's.

Not in this slice (ROADMAP.md, Queue 1): the journal, snapshots and
``load``, incremental device patching (index/patch.py), the query
coalescer, ``cosine_topk``, and the sharded and IVF engines, which raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from imatch_tpu_torch.device import DeviceLike, resolve_device
from imatch_tpu_torch.index.search import (
    HOST_MARGIN,
    host_rescore_topk,
    prepare_device_corpus,
    prepare_host_rescore_corpus,
    tilemax_topk,
)

logger = logging.getLogger("imatch.store")

_MIN_CAP = 1024

_SCORE_DTYPES = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp32": torch.float32,
    "float32": torch.float32,
    "int8": torch.int8,
}
_LATER = {
    "sharded": "ROADMAP.md Queue 1 step 12 (multi-GPU and parallel)",
    "ivf": "ROADMAP.md Queue 1 step 11 (IVF ANN tier)",
    "ivf-sharded": "ROADMAP.md Queue 1 step 11 (IVF ANN tier) and step 12",
}
# engine -> tile_n, as the JAX engines use them
_ENGINES = {"tilemax": 512, "pallas": 2048, "tilemax-host": 512}


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


def _env_engine() -> str:
    return os.environ.get("IMATCH_INDEX_ENGINE", "tilemax").lower()


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
        engine: Optional[str] = None,
        score_dtype: Optional[str] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.dim = dim
        self.engine = (engine or _env_engine()).lower()
        self._auto = self.engine == "auto"
        if self._auto:
            # one GPU: the single-device exact engine, escalated per build
            # to the capacity tier when the corpus outgrows the card
            self.engine = "tilemax"
        if self.engine in _LATER:
            raise NotImplementedError(
                f"index engine {self.engine!r} is not ported yet: {_LATER[self.engine]}"
            )
        if self.engine not in _ENGINES:
            raise ValueError(f"unknown index engine {self.engine!r}")
        self.tile_n = _ENGINES[self.engine]
        self.score_dtype = _score_dtype(
            score_dtype or os.environ.get("IMATCH_SCORE_DTYPE", "bf16")
        )
        if self.engine == "tilemax":
            default = "16" if self.score_dtype == torch.int8 else "4"
            self.margin = int(os.environ.get("IMATCH_TILEMAX_MARGIN", default))
        elif self.engine == "tilemax-host":
            # for stats(): the host tier's phase 1 takes HOST_MARGIN itself,
            # also when auto escalates a tilemax store to it
            self.margin = HOST_MARGIN
        else:
            self.margin = 4
        self._lock = threading.RLock()
        self._ids: List[str] = []
        self._slot: Dict[str, int] = {}
        self._meta: List[Optional[dict]] = []
        self._docs: List[Optional[str]] = []
        self._emb: Optional[np.ndarray] = None  # (cap, D) fp32
        self._alive: Optional[np.ndarray] = None  # (cap,) bool
        self._n = 0  # slots in use (incl. tombstones)
        self._dead = 0
        self._device_corpus = None  # (engine tag, state), dropped on mutation
        self._last_build: Optional[dict] = None

    # -- capacity -----------------------------------------------------------

    def _ensure_capacity(self, extra: int):
        need = self._n + extra
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
                embeddings = embeddings.detach().float().cpu().numpy()
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
            self._device_corpus = None

    def get(
        self,
        ids: Optional[Sequence[str]] = None,
        include: Sequence[str] = ("metadatas", "documents"),
    ) -> dict:
        with self._lock:
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
            for i, slot in enumerate(slots_all):
                if metadatas is not None:
                    self._meta[slot] = metadatas[i]
                if embeddings is not None:
                    self._emb[slot] = embeddings[i]
            if embeddings is not None and slots_all:
                self._device_corpus = None

    def delete(self, ids: Sequence[str]):
        with self._lock:
            deleted = False
            for id_ in ids:
                slot = self._slot.pop(id_, None)
                if slot is not None and self._alive[slot]:
                    self._alive[slot] = False
                    self._dead += 1
                    deleted = True
            if deleted:
                self._maybe_compact()
                self._device_corpus = None

    def count(self) -> int:
        with self._lock:
            return self._n - self._dead

    def stats(self) -> dict:
        """Operational snapshot: engine, occupancy, last device build."""
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
                "device_ready": self._device_corpus is not None,
            }
            if self._last_build is not None:
                out["last_build"] = dict(self._last_build)
            return out

    # -- search -------------------------------------------------------------

    def _engine_for(self) -> str:
        """Effective engine for one build (JAX ``_engine_for``). With
        IMATCH_INDEX_ENGINE=auto, when the device copies of the tilemax
        engine (score dtype, int8 counted as 2 bytes as in JAX, plus the
        fp32 rescore copy) would exceed IMATCH_AUTO_HBM_FRAC (default 0.5)
        of the card's memory (IMATCH_DEVICE_BYTES_BUDGET, else the card's
        total), the build escalates to tilemax-host, whose int8 codes are
        the only device copy. The footprint counts the slot capacity, as
        JAX's does, so both packages escalate at the same row count; the
        port uploads only the slots in use, which is at most that. A
        non-auto engine is never overridden."""
        eng = self.engine
        if not self._auto or eng != "tilemax":
            return eng
        budget = os.environ.get("IMATCH_DEVICE_BYTES_BUDGET")
        if budget is None and self.device.type == "cuda":
            budget = torch.cuda.mem_get_info(self.device)[1]
        if not budget:
            return eng
        elems = self._emb.size
        score_bytes = 2 if self.score_dtype == torch.int8 else self.score_dtype.itemsize
        per_device = elems * (score_bytes + 4)
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

    def _build(self, eng: str):
        """The prepared state of engine ``eng`` over the slots in use."""
        emb, alive = self._emb[: self._n], self._alive[: self._n]
        if eng == "tilemax-host":
            # host-side quantize: only the int8 codes cross to the card
            return prepare_host_rescore_corpus(
                emb.copy(), alive.copy(), tile_n=self.tile_n, device=self.device
            )
        dtype = self.score_dtype
        if eng == "pallas" and dtype == torch.int8:
            dtype = torch.bfloat16  # int8 is a tilemax option, as in JAX
        return prepare_device_corpus(
            emb,
            alive,
            tile_n=self.tile_n,
            score_dtype=dtype,
            margin=self.margin,
            device=self.device,
        )

    @staticmethod
    def _k_bucket(k: int) -> int:
        """The next power of two: the JAX store runs its engines at this k
        (a jit cache key there), so its candidate tiles are k_c + margin."""
        return 1 << max(0, k - 1).bit_length()

    def _snapshot_for_query(self):
        """(live count, device corpus, id/meta/doc lists), consistent with
        each other. Lock-free use afterwards is safe: ``add`` only appends
        to the lists, ``delete`` flips host flags the built corpus no
        longer reads, compaction rebinds the lists, and a mutation drops
        the device corpus for a new one instead of writing into it."""
        with self._lock:
            live = self.count()
            if self._device_corpus is None and live:
                t0 = time.perf_counter()
                eng = self._engine_for()
                self._device_corpus = (eng, self._build(eng))
                self._last_build = {
                    "engine": eng,
                    "seconds": round(time.perf_counter() - t0, 3),
                    "rows": self._n,
                }
            return live, self._device_corpus, self._ids, self._meta, self._docs

    def query(
        self,
        query_embeddings,
        n_results: int = 10,
        include: Sequence[str] = ("metadatas", "distances"),
    ) -> dict:
        """Chroma-shaped result: lists of lists, ascending cosine distance.
        ``query_embeddings`` may be a tensor already on the device (the
        embedder's output), which then feeds the engine with no host copy."""
        if isinstance(query_embeddings, torch.Tensor):
            q = query_embeddings.float()
        else:
            q = torch.from_numpy(np.asarray(query_embeddings, dtype=np.float32))
        if q.ndim == 1:
            q = q[None]
        qn = q.shape[0]
        live, dc, ids_l, meta_l, docs_l = self._snapshot_for_query()
        out = {"ids": [], "distances": [], "metadatas": [], "documents": []}
        k = min(n_results, live)
        if live == 0 or k <= 0:
            for key in out:
                out[key] = [[] for _ in range(qn)]
            return self._strip_include(out, include)
        k_c = self._k_bucket(k)
        eng, state = dc
        if eng == "tilemax-host":
            scores, idx = host_rescore_topk(q.to(self.device), state, k=k_c)
        else:
            scores, idx = tilemax_topk(q.to(self.device), state, k=k_c)
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        scores, idx = scores[:, :k], idx[:, :k]
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
