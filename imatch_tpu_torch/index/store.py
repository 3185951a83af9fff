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

Not ported yet (ROADMAP.md, Queue 1): ``add`` with a device tensor that
stays on the device (JAX ``_add_device``, ``flush``), the query
coalescer, ``cosine_topk`` and ``warm``, the IVF snapshot sidecar, and
the sharded and IVF engines, which raise ``NotImplementedError`` naming
their ROADMAP item.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from imatch_tpu_torch.device import DeviceLike, resolve_device
from imatch_tpu_torch.index import patch as _patch
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
        persist_dir: Optional[str] = None,
        engine: Optional[str] = None,
        score_dtype: Optional[str] = None,
        capacity: Optional[int] = None,
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
        self._last_build: Optional[dict] = None
        self._last_load: Optional[dict] = None  # stats(): load()'s seconds
        # A slot reservation: a right-sized one means steady-state ingest
        # never grows the capacity, so every add patches. Remembered, not
        # only applied here: load() builds the store with dim=None, so the
        # first _ensure_capacity once dim is known honours it.
        if capacity is None:
            capacity = int(os.environ.get("IMATCH_STORE_CAPACITY", "0")) or None
        self._reserve = int(capacity) if capacity else 0
        if self._reserve and dim:
            self._ensure_capacity(0)

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
        engine or the patch declines. The state's tensors are written in
        place only while no query holds it."""
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
        try:
            if kind == "append":
                res = _patch.append_rows(dc, slots, rows, in_place=in_place)
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
            emb_slots: List[int] = []
            ops: List[dict] = []
            for i, (id_, slot) in enumerate(zip(ids, slots_all)):
                if metadatas is not None:
                    self._meta[slot] = metadatas[i]
                if embeddings is not None:
                    self._emb[slot] = embeddings[i]
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
                "device_ready": self._device_corpus is not None,
                "journal_ops": self._journal_len,
                # incremental mutation health: patched should dominate
                # rebuilds in steady state (index/patch.py)
                "patched_mutations": self._patched,
                "rebuild_mutations": self._patch_rebuilds,
            }
            if self._last_build is not None:
                out["last_build"] = dict(self._last_build)
            if self._last_load is not None:
                out["last_load"] = dict(self._last_load)
            return out

    # -- search -------------------------------------------------------------

    def _engine_for(self, emb_copy: np.ndarray) -> str:
        """Effective engine for one build (JAX ``_engine_for``). With
        IMATCH_INDEX_ENGINE=auto, when the device copies of the tilemax
        engine (score dtype, int8 counted as 2 bytes as in JAX, plus the
        fp32 rescore copy) would exceed IMATCH_AUTO_HBM_FRAC (default 0.5)
        of the card's memory (IMATCH_DEVICE_BYTES_BUDGET, else the card's
        total), the build escalates to tilemax-host, whose int8 codes are
        the only device copy. The footprint counts the capacity buffer the
        build uploads (``emb_copy``), as JAX's does. A non-auto engine is
        never overridden."""
        eng = self.engine
        if not self._auto or eng != "tilemax":
            return eng
        budget = os.environ.get("IMATCH_DEVICE_BYTES_BUDGET")
        if budget is None and self.device.type == "cuda":
            budget = torch.cuda.mem_get_info(self.device)[1]
        if not budget:
            return eng
        elems = emb_copy.size
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

    def _build_device(self, emb_copy: np.ndarray, alive_copy: np.ndarray):
        """``(engine tag, state)`` over the whole capacity buffer, from
        COPIES of the host buffers (on the CPU a tensor can alias numpy
        memory that writers mutate in place). Runs outside the store lock:
        at capacity scale the upload and quantize take from a second to
        ten, and must not block writers."""
        t0 = time.perf_counter()
        eng = self._engine_for(emb_copy)
        if eng == "tilemax-host":
            # host-side quantize: only the int8 codes cross to the card
            state = prepare_host_rescore_corpus(
                emb_copy, alive_copy, tile_n=self.tile_n, device=self.device
            )
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
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # the build's time, not its enqueue
        # info-only write; racing builds yield slightly stale stats()
        self._last_build = {
            "engine": eng,
            "seconds": round(time.perf_counter() - t0, 3),
            "rows": int(emb_copy.shape[0]),
        }
        return eng, state

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
                self._device_corpus = self._build_device(self._emb.copy(), self._alive.copy())
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
        scores, idx = tilemax_topk(q, state, k=k)
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
                emb = self._emb.copy()
                alive = self._alive.copy()
            else:
                self._inflight += 1
        if dc is None:
            dc = self._build_device(emb, alive)
            with self._lock:
                if self._gen == gen and self._device_corpus is None:
                    self._device_corpus = dc
                # a concurrent mutation invalidated or patched the store:
                # dc is still consistent with the lists captured above, so
                # THIS query serves it; the next one builds afresh. Either
                # way it now holds a state a later patch could write into.
                self._inflight += 1
        return live, dc, ids_l, meta_l, docs_l

    def _release_snapshot(self, dc):
        """Drop the hold taken by ``_snapshot_for_query`` (none was taken
        for an empty store)."""
        if dc is None:
            return
        with self._lock:
            self._inflight -= 1

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
        query."""
        if isinstance(query_embeddings, torch.Tensor):
            q = query_embeddings.float()
        else:
            q = torch.from_numpy(np.asarray(query_embeddings, dtype=np.float32))
        if q.ndim == 1:
            q = q[None]
        qn = q.shape[0]
        live, dc, ids_l, meta_l, docs_l = self._snapshot_for_query()
        try:
            out = {"ids": [], "distances": [], "metadatas": [], "documents": []}
            k = min(n_results, live)
            if live == 0 or k <= 0:
                for key in out:
                    out[key] = [[] for _ in range(qn)]
                return self._strip_include(out, include)
            scores, idx = self._run_engine(q, dc, self._k_bucket(k))
        finally:
            self._release_snapshot(dc)
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

    # -- persistence --------------------------------------------------------

    def save(self, path: Optional[str] = None):
        """Atomic durable snapshot (compacted); resets the journal.

        Data files are written under new ``embeddings-<gen>.npy`` /
        ``records-<gen>.json`` names (the records one JSON array) and the
        manifest, replaced last, is the commit record that points at them:
        a crash at any point leaves the previous generation intact. JAX's
        IVF sidecar (``ivf-<gen>.npz``) is never written: the port has no
        IVF state (ROADMAP.md Queue 1 step 11)."""
        path = path or self.persist_dir
        if path is None:
            raise ValueError("no path and no persist_dir")
        with self._lock:
            os.makedirs(path, exist_ok=True)
            slots = [i for i in range(self._n) if self._alive[i]]
            gen = int(time.time() * 1e6)
            emb_name = f"embeddings-{gen}.npy"
            rec_name = f"records-{gen}.json"
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
                os.replace(os.path.join(tmp, emb_name), os.path.join(path, emb_name))
                os.replace(os.path.join(tmp, rec_name), os.path.join(path, rec_name))
                mpath = os.path.join(tmp, "manifest.json")
                manifest = {
                    "dim": self.dim,
                    "count": len(slots),
                    "embeddings": emb_name,
                    "records": rec_name,
                    "generation": gen,
                }
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
            # collect superseded generations (and legacy names, and a
            # JAX store's IVF sidecars, which this snapshot no longer pairs)
            for f in os.listdir(path):
                if f.startswith(("embeddings", "records", "ivf")) and f not in (emb_name, rec_name):
                    try:
                        os.unlink(os.path.join(path, f))
                    except OSError:
                        pass

    @classmethod
    def load(cls, path: str, persist: bool = True, device: DeviceLike = None) -> "VectorStore":
        """Rehydrate: snapshot first, then replay the journal. With
        ``persist`` the returned store keeps journaling into ``path``.
        Engine and score dtype come from the environment, as in JAX; the
        store lives on ``device`` (the card unless the CPU is asked for).
        A manifest's ``ivf`` sidecar is ignored: the next build is a full
        one, as JAX's is without the sidecar. ``stats()["last_load"]``
        records the seconds of the snapshot read and of the replay."""
        t0 = time.perf_counter()
        manifest_path = os.path.join(path, "manifest.json")
        store = cls(device=device)
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
