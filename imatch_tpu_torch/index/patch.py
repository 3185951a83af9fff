"""Incremental device-state patching: O(batch) index mutations.

Counterpart of ``imatch_tpu/index/patch.py`` for the port's engines.
Without it every ``add``, ``update`` and ``delete`` drops the store's
prepared state, and the next query copies and uploads the whole corpus
again (3 GiB at 2^20 x 768). The store's device build covers its whole
capacity buffer (index/store.py), so a mutation is a patch in place:

- **appends** land in fresh slots inside the already-uploaded padding:
  a scatter of just the new rows (plus the per-row cast or quantize the
  full build does);
- **deletes** only clear validity entries;
- **updates** scatter the changed rows.

Engine coverage (``None`` asks the caller for a full rebuild, which is
always correct):

- ``tilemax`` (bf16, fp32, int8) and ``pallas`` (a ``DeviceCorpus`` with
  tile_n 2048; the port masks with ``valid``, not JAX's penalty column,
  so there is no column to write): append, delete, update. The rows are
  made as ``search.prepare_device_corpus`` makes them: the score-dtype
  cast after the same column padding, or the codes and scales of
  ``search._int8_rows``, so a patched row equals a built row bit for bit.
- ``tilemax-host`` (``HostRescoreCorpus``): append and delete. The int8
  rows are quantized with the numpy code of
  ``search.prepare_host_rescore_corpus``; the state's host fp32 matrix is
  written in place (old states cannot reach the new slots: their copy of
  the host validity masks them) and the host validity is copy-on-write.
  Updates fall back: an in-place rewrite of a live host row could tear
  under a concurrent lock-free rescore.

PyTorch's counterpart of JAX's buffer donation is ``in_place``: the store
passes True when no query holds the current state (its ``_inflight``
count is zero) and the patch writes into the state's tensors
(``index_put_``); otherwise each tensor the patch writes is cloned first
and the clone is patched, so a query that captured the old state keeps
reading it. A query holds its count until its results are on the host
(``.cpu()`` synchronises), and every kernel and patch runs on the current
stream, so an in-place patch never overwrites rows a launched K1 is
still reading. Each tensor the state holds is patched on its own:
``scoring`` and ``exact`` are separate tensors even in fp32.

Rows may be numpy (the host path) or a tensor already on the card (a
device-resident add, ``VectorStore._add_device``): the device engines
then scatter them device to device with no host round trip, and the int8
tier quantizes them on the card with ``search._int8_rows``, the same ops
on the same device as the full build, so the codes and scales equal the
build's bit for bit. ``tilemax-host`` brings them to the host first (JAX
``_rows_f32``), for its numpy quantization and host rows.

- ``sharded`` (``ShardedCorpus``, parallel/dist_search.py): append,
  delete, update. Each global slot maps to (shard, local slot), and each
  shard's rows go through the ``DeviceCorpus`` patch above on the shard's
  device (over a grid that spans processes, only this process's shards).
- ``ivf`` (``IVFIndex``): append and delete. New rows are assigned
  against the EXISTING centroids (the FAISS add discipline) and written
  into free member-table slots (``_insert_positions``: their cluster's
  fill plus their rank in the batch), so a patched table equals a
  repack's. Falls back when a row lands in a pruned cluster or a full
  member list; the store falls back before calling when the live set
  outgrew the retrain threshold. Updates fall back (the member lists
  would go stale), as in JAX.
- ``ivf-sharded`` (``ShardedIVF``, parallel/dist_ivf.py): append (each
  shard's rows against its own centroids, into its table of local ids;
  the cluster becomes ``nonempty``) and delete; updates fall back.

An IVF append returns the host bookkeeping it changed beside the state:
the rows' unpruned (for the sharded kind, shard-local) cluster ids for
the store's ``assign``, and the new member-list fill (for the sharded
kind, a dict shard -> fill).

JAX pads each batch to a power of two (``_bucket``, ``_pad_idx``,
``_pad_rows``) for its jit cache. The port has no jit cache and patches
the batch as it comes.

Kill switch: ``IMATCH_INCREMENTAL=0`` restores invalidate-on-mutation.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from imatch_tpu_torch.index import ivf as _ivf
from imatch_tpu_torch.index.search import DeviceCorpus, HostRescoreCorpus, _int8_rows


def enabled() -> bool:
    return os.environ.get("IMATCH_INCREMENTAL", "1").lower() not in ("0", "false", "no", "off")


def _write(t: torch.Tensor, idx: torch.Tensor, values: torch.Tensor, in_place: bool) -> torch.Tensor:
    """``t[idx] = values``, into ``t`` itself or into a clone of it."""
    if not in_place:
        t = t.clone()
    return t.index_put_((idx,), values)


def _rows_f32(rows, dev: torch.device) -> torch.Tensor:
    """(b, D) fp32 rows on ``dev``: a tensor stays where it is when it is
    already there (no host round trip), numpy rows are uploaded."""
    if isinstance(rows, torch.Tensor):
        return rows.detach().to(device=dev, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(dev)


def _host_rows(rows) -> np.ndarray:
    if isinstance(rows, torch.Tensor):
        return rows.detach().to(device="cpu", dtype=torch.float32).numpy()
    return np.ascontiguousarray(rows, np.float32)


def _dense_rows(state: DeviceCorpus, slots: np.ndarray, rows, in_place: bool) -> DeviceCorpus:
    """Rows written at ``slots`` of a ``DeviceCorpus``, made as the full
    build makes them, and marked valid."""
    dev = state.exact.device
    idx = torch.from_numpy(slots).to(dev)
    rows32 = _rows_f32(rows, dev)
    pad = (0, state.scoring.shape[1] - rows32.shape[1])
    scale = state.scale
    if state.scoring.dtype == torch.int8:
        codes, sc = _int8_rows(rows32)
        scoring = _write(state.scoring, idx, F.pad(codes, pad), in_place)
        scale = _write(scale, idx, sc, in_place)
    else:
        scoring = _write(state.scoring, idx, F.pad(rows32, pad).to(state.scoring.dtype), in_place)
    return state._replace(
        scoring=scoring,
        exact=_write(state.exact, idx, rows32, in_place),
        valid=_write(state.valid, idx, torch.ones_like(idx, dtype=torch.bool), in_place),
        scale=scale,
    )


def _host_tier_append(
    state: HostRescoreCorpus, slots: np.ndarray, rows, in_place: bool
) -> HostRescoreCorpus:
    """tilemax-host append: numpy quantization identical to
    ``prepare_host_rescore_corpus``, a device scatter of codes, scales and
    validity, the host fp32 rows written in place (unreachable from old
    states), and a copy-on-write host validity."""
    rows = _host_rows(rows)
    amax = np.abs(rows).max(axis=1)
    sc = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(rows / sc[:, None]), -127, 127).astype(np.int8)
    q = np.pad(q, ((0, 0), (0, state.scoring.shape[1] - q.shape[1])))
    dev = state.scoring.device
    idx = torch.from_numpy(slots).to(dev)
    scoring = _write(state.scoring, idx, torch.from_numpy(q).to(dev), in_place)
    scale = _write(state.scale, idx, torch.from_numpy(sc).to(dev), in_place)
    valid = _write(state.valid, idx, torch.ones_like(idx, dtype=torch.bool), in_place)
    # host side: rows first, THEN the validity copy that reveals them
    state.host_exact[slots] = rows
    host_valid = state.host_valid.copy()
    host_valid[slots] = True
    return state._replace(scoring=scoring, valid=valid, scale=scale, host_valid=host_valid)


def _take(rows, sel: np.ndarray):
    """The rows at positions ``sel`` of a numpy or tensor batch."""
    if isinstance(rows, torch.Tensor):
        return rows[torch.from_numpy(sel).to(rows.device)]
    return np.asarray(rows)[sel]


def _by_shard(slots: np.ndarray, shard_rows: int):
    """(shard, positions in the batch, local slots) for each shard that
    holds some of ``slots``."""
    shard = slots // shard_rows
    for s in np.unique(shard):
        sel = np.nonzero(shard == s)[0]
        yield int(s), sel, slots[sel] % shard_rows


def _sharded_rows(state, slots: np.ndarray, rows, in_place: bool):
    """A ``ShardedCorpus`` with rows written at global ``slots``: each
    shard's through ``_dense_rows`` on its device (a shard another process
    owns, None here, is that process's to patch)."""
    shards = list(state.shards)
    for s, sel, local in _by_shard(slots, state.rows):
        if shards[s] is not None:
            shards[s] = _dense_rows(shards[s], local, _take(rows, sel), in_place)
    return state._replace(shards=tuple(shards))


def _flag(mask: torch.Tensor, slots: np.ndarray, value: bool, in_place: bool) -> torch.Tensor:
    """``mask[slots] = value`` for a bool mask, in place or in a clone."""
    idx = torch.from_numpy(slots).to(mask.device)
    return _write(mask, idx, torch.full(idx.shape, value, dtype=torch.bool, device=mask.device), in_place)


def _insert_positions(pr: np.ndarray, base_counts: np.ndarray) -> np.ndarray:
    """Member-table slot of each new row: its cluster's current fill plus
    its rank among the batch's rows landing in the same cluster."""
    order = np.argsort(pr, kind="stable")
    sorted_c = pr[order]
    if sorted_c.size:
        starts = np.r_[0, np.nonzero(np.diff(sorted_c))[0] + 1]
        lens = np.diff(np.r_[starts, sorted_c.size])
        within = np.arange(sorted_c.size) - np.repeat(starts, lens)
    else:
        within = np.zeros((0,), np.int64)
    pos = np.empty_like(within)
    pos[order] = within
    return base_counts + pos


def _ivf_rows(ix, slots: np.ndarray, rows32: torch.Tensor, midx: np.ndarray, in_place: bool):
    """An ``IVFIndex`` with ``slots`` written into its member table at the
    flat positions ``midx``, and the fp32 rows (on the index's device)
    written and marked valid at ``slots`` (the table's row ids)."""
    dev = ix.corpus.device
    idx = torch.from_numpy(slots).to(dev)
    flat = ix.members.view(-1) if in_place else ix.members.clone().view(-1)
    flat[torch.from_numpy(midx).to(dev)] = idx
    return ix._replace(
        members=flat.view(ix.members.shape),
        corpus=_write(ix.corpus, idx, rows32.to(ix.corpus.dtype), in_place),
        valid=_flag(ix.valid, slots, True, in_place),
    )


def _ivf_append(state, host, slots: np.ndarray, rows, in_place: bool):
    """Single-device IVF append. Returns ``(new_state, (clusters,
    counts))`` (unpruned cluster ids for ``assign``, the new pruned-space
    fill) or None."""
    if host is None or "counts" not in host or "pruned_map" not in host:
        return None
    rows32 = _rows_f32(rows, state.corpus.device)
    cl = _ivf.assign_rows(rows32, host["cents"])  # unpruned ids
    pr = host["pruned_map"][cl]
    if np.any(pr < 0):
        return None  # lands in a cluster pruned from the device table
    counts = host["counts"]
    m = state.members.shape[1]
    pos = _insert_positions(pr, counts[pr])
    if np.any(pos >= m):
        return None  # a member list is full: repack
    new_state = _ivf_rows(state, slots, rows32, pr.astype(np.int64) * m + pos, in_place)
    new_counts = counts.copy()
    np.add.at(new_counts, pr, 1)
    return new_state, (cl, new_counts)


def _ivf_sharded_append(state, host, slots: np.ndarray, rows, in_place: bool):
    """Sharded IVF append: each shard's rows assigned against its own
    centroids and written into its table. Returns ``(new_state, (shard-
    local clusters, {shard: new fill}))`` or None."""
    if host is None or "counts" not in host:
        return None
    cl = np.empty((slots.shape[0],), np.int32)
    plan = []
    for s, sel, local in _by_shard(slots, state.rows):
        ix = state.shards[s]
        rows_s = _rows_f32(_take(rows, sel), ix.corpus.device)
        cl[sel] = _ivf.assign_rows(rows_s, host["cents"][s])
        counts = host["counts"][s]
        pos = _insert_positions(cl[sel], counts[cl[sel]])
        if np.any(pos >= ix.members.shape[1]):
            return None
        plan.append((s, sel, local, rows_s, pos))
    shards, masks, counts_upd = list(state.shards), list(state.nonempty), {}
    for s, sel, local, rows_s, pos in plan:
        c = cl[sel].astype(np.int64)
        shards[s] = _ivf_rows(shards[s], local, rows_s, c * shards[s].members.shape[1] + pos, in_place)
        masks[s] = _flag(masks[s], c, True, in_place)
        nc = host["counts"][s].copy()
        np.add.at(nc, c, 1)
        counts_upd[s] = nc
    return state._replace(shards=tuple(shards), nonempty=tuple(masks)), (cl, counts_upd)


# -- public API (the store calls these under its lock) --------------------------


def append_rows(dc, slots: np.ndarray, rows, *, in_place: bool, ivf_host=None):
    """Patch freshly appended rows into a prepared state. Returns
    ``((tag, new_state), ivf_host_updates)`` (None but for the IVF kinds)
    or None to ask for a rebuild. ``slots`` are the store's slot indices
    (int64), ``rows`` the (b, D) fp32 embeddings, numpy or a tensor (on
    the card: scattered device to device); ``ivf_host`` the store's IVF
    host state."""
    tag, state = dc
    if tag in ("tilemax", "pallas"):
        return (tag, _dense_rows(state, slots, rows, in_place)), None
    if tag == "sharded":
        return (tag, _sharded_rows(state, slots, rows, in_place)), None
    if tag == "tilemax-host":
        return (tag, _host_tier_append(state, slots, rows, in_place)), None
    if tag in ("ivf", "ivf-sharded"):
        append = _ivf_append if tag == "ivf" else _ivf_sharded_append
        res = append(state, ivf_host, slots, rows, in_place)
        return None if res is None else ((tag, res[0]), res[1])
    return None


def delete_rows(dc, slots: np.ndarray, *, in_place: bool) -> Optional[Tuple[str, tuple]]:
    """Clear the validity of tombstoned slots. Returns ``(tag, new_state)``
    or None."""
    tag, state = dc
    if tag in ("tilemax", "pallas", "ivf"):
        return tag, state._replace(valid=_flag(state.valid, slots, False, in_place))
    if tag == "tilemax-host":
        host_valid = state.host_valid.copy()
        host_valid[slots] = False
        return tag, state._replace(valid=_flag(state.valid, slots, False, in_place), host_valid=host_valid)
    if tag in ("sharded", "ivf-sharded"):
        shards = list(state.shards)
        for s, _, local in _by_shard(slots, state.rows):
            if shards[s] is not None:  # None: another process's shard
                shards[s] = shards[s]._replace(valid=_flag(shards[s].valid, local, False, in_place))
        return tag, state._replace(shards=tuple(shards))
    return None


def update_rows(dc, slots: np.ndarray, rows: np.ndarray, *, in_place: bool) -> Optional[Tuple[str, tuple]]:
    """Scatter replaced embeddings (the exact device engines; the host tier
    and the IVF kinds fall back). Returns ``(tag, new_state)`` or None."""
    tag, state = dc
    if tag in ("tilemax", "pallas"):
        return tag, _dense_rows(state, slots, rows, in_place)
    if tag == "sharded":
        return tag, _sharded_rows(state, slots, rows, in_place)
    return None
