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


# -- public API (the store calls these under its lock) --------------------------


def append_rows(dc, slots: np.ndarray, rows, *, in_place: bool) -> Optional[Tuple[str, tuple]]:
    """Patch freshly appended rows into a prepared state. Returns
    ``(tag, new_state)`` or None to ask for a rebuild. ``slots`` are the
    store's slot indices (int64), ``rows`` the (b, D) fp32 embeddings,
    numpy or a tensor (on the card: scattered device to device)."""
    tag, state = dc
    if tag in ("tilemax", "pallas"):
        return tag, _dense_rows(state, slots, rows, in_place)
    if tag == "tilemax-host":
        return tag, _host_tier_append(state, slots, rows, in_place)
    return None


def delete_rows(dc, slots: np.ndarray, *, in_place: bool) -> Optional[Tuple[str, tuple]]:
    """Clear the validity of tombstoned slots. Returns ``(tag, new_state)``
    or None."""
    tag, state = dc
    idx = torch.from_numpy(slots).to(state.valid.device)
    valid = _write(state.valid, idx, torch.zeros_like(idx, dtype=torch.bool), in_place)
    if tag in ("tilemax", "pallas"):
        return tag, state._replace(valid=valid)
    if tag == "tilemax-host":
        host_valid = state.host_valid.copy()
        host_valid[slots] = False
        return tag, state._replace(valid=valid, host_valid=host_valid)
    return None


def update_rows(dc, slots: np.ndarray, rows: np.ndarray, *, in_place: bool) -> Optional[Tuple[str, tuple]]:
    """Scatter replaced embeddings (the device-only engines; the host tier
    falls back). Returns ``(tag, new_state)`` or None."""
    tag, state = dc
    if tag in ("tilemax", "pallas"):
        return tag, _dense_rows(state, slots, rows, in_place)
    return None
