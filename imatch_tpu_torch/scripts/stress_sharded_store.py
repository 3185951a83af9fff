"""Sharded-tier stress at a realistic scale: ``ivf-sharded`` over 8 shards.

Port of ``scripts/stress_sharded_store.py``. Small tests prove the sharded
engines at toy sizes, and shard-boundary bookkeeping faults live past
them. This run cycles an ``ivf-sharded`` VectorStore through n x d rows
(default 100_000 x 256) with mutations (appends, deletes and updates),
compaction, a snapshot and a restore with a journal replay, and checks
every checkpoint against a numpy exact-cosine oracle: with
IMATCH_IVF_NPROBE=100000 each query probes every cluster of every shard,
where sharded IVF must equal exact search (ids identical, similarities
within 1e-4).

The shards are logical: 8 entries of the one device list the sharded
engines take (parallel/mesh.py; a device may repeat), as the JAX script
runs 8 virtual CPU devices, so one card or the CPU holds all of them:
``cuda:0`` eight times by default, ``cpu`` eight times with ``--device
cpu`` (or IMATCH_DEVICE=cpu).

Usage:
    python -m imatch_tpu_torch.scripts.stress_sharded_store [n] [d] [--device cpu]

Prints one PASS/FAIL line a checkpoint and a JSON summary (with the wall
seconds and, on the card, the run's peak device memory above what its
process held before); exits non-zero on any mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from imatch_tpu_torch.device import resolve_device
from imatch_tpu_torch.index.store import VectorStore

FULL_PROBE = "100000"  # IMATCH_IVF_NPROBE: every cluster of every shard
SHARDS = 8


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


class Oracle:
    """Host mirror of the live set + exact cosine top-k."""

    def __init__(self, d):
        self.d = d
        self.vecs: dict = {}

    def add(self, ids, rows):
        for i, r in zip(ids, rows):
            self.vecs[i] = r

    def delete(self, ids):
        for i in ids:
            self.vecs.pop(i, None)

    def update(self, ids, rows):
        self.add(ids, rows)

    def topk(self, q, k):
        ids = list(self.vecs.keys())
        mat = np.stack([self.vecs[i] for i in ids])
        s = mat @ q
        order = np.lexsort((np.arange(len(ids)), -s))[:k]
        return [ids[i] for i in order], s[order]


def check(tag, store, oracle, qs, k=10):
    t0 = time.perf_counter()
    res = store.query(qs, n_results=k)
    dt = (time.perf_counter() - t0) * 1e3
    for qi in range(qs.shape[0]):
        want_ids, want_s = oracle.topk(qs[qi], k)
        got_ids = res["ids"][qi]
        got_s = [1.0 - d for d in res["distances"][qi]]
        if got_ids != want_ids or not np.allclose(got_s, want_s, atol=1e-4):
            print(f"FAIL {tag} q{qi}")
            print("  want", want_ids[:5], np.round(want_s[:5], 5))
            print("  got ", got_ids[:5], np.round(got_s[:5], 5))
            return False
    print(f"PASS {tag} ({dt:.0f} ms, live={store.count()})", flush=True)
    return True


def run(n: int, d: int, device: torch.device) -> dict:
    """The cycle on SHARDS logical shards of ``device``, under a full
    probe (IMATCH_IVF_NPROBE, read at each query, restored after): the
    ANN tier reduces to exact search, so the oracle can check it. Returns
    the summary; ``ok`` is False on any mismatch."""
    old = os.environ.get("IMATCH_IVF_NPROBE")
    os.environ["IMATCH_IVF_NPROBE"] = FULL_PROBE
    try:
        return _cycle(n, d, device)
    finally:
        if old is None:
            os.environ.pop("IMATCH_IVF_NPROBE", None)
        else:
            os.environ["IMATCH_IVF_NPROBE"] = old


def _cycle(n: int, d: int, device: torch.device) -> dict:
    mesh = [device] * SHARDS
    rng = np.random.default_rng(0)
    oracle = Oracle(d)
    summary = {"n": n, "d": d, "devices": len(mesh), "device": str(device)}
    ok = True
    t_start = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)  # the caller's tensors, not the run's

    with tempfile.TemporaryDirectory() as root:
        store = VectorStore(dim=d, engine="ivf-sharded", persist_dir=root, device=device, mesh=mesh)
        ids = [f"r{i:07d}" for i in range(n)]
        rows = _norm(rng.standard_normal((n, d)).astype(np.float32))
        t0 = time.perf_counter()
        store.add(ids=ids, embeddings=rows)
        oracle.add(ids, rows)
        summary["bulk_add_s"] = round(time.perf_counter() - t0, 3)
        qs = _norm(rng.standard_normal((4, d)).astype(np.float32))
        t0 = time.perf_counter()
        ok &= check("initial build", store, oracle, qs)
        summary["initial_build_s"] = round(time.perf_counter() - t0, 3)

        # mutation rounds: appends land in the capacity padding (patched),
        # deletes flip masks (patched), updates fall back to a repair
        for rnd in range(3):
            new_ids = [f"a{rnd}_{i:05d}" for i in range(2048)]
            new_rows = _norm(rng.standard_normal((2048, d)).astype(np.float32))
            store.add(ids=new_ids, embeddings=new_rows)
            oracle.add(new_ids, new_rows)
            dead = [f"r{i:07d}" for i in range(rnd * 3000, rnd * 3000 + 1500)]
            store.delete(dead)
            oracle.delete(dead)
            upd_ids = [f"a{rnd}_{i:05d}" for i in range(16)]
            upd_rows = _norm(rng.standard_normal((16, d)).astype(np.float32))
            store.update(upd_ids, embeddings=upd_rows)
            oracle.update(upd_ids, upd_rows)
            ok &= check(f"mutation round {rnd}", store, oracle, qs)
        summary["patched_mutations"] = store.stats()["patched_mutations"]

        # a snapshot, then a restore that replays the journal
        store.checkpoint(force=True)
        extra_ids = [f"j_{i:04d}" for i in range(512)]
        extra = _norm(rng.standard_normal((512, d)).astype(np.float32))
        store.add(ids=extra_ids, embeddings=extra)  # journal only
        oracle.add(extra_ids, extra)
        t0 = time.perf_counter()
        restored = VectorStore.load(root, device=device, mesh=mesh)
        summary["restore_s"] = round(time.perf_counter() - t0, 3)
        if restored.count() != store.count():
            print(f"FAIL snapshot+journal restore count {restored.count()} != {store.count()}")
            ok = False
        ok &= check("snapshot+journal restore", restored, oracle, qs)
        del restored

        # compaction: delete more than half of the live set
        live_ids = store.get(include=[])["ids"]
        victims = live_ids[: int(len(live_ids) * 0.55)]
        step = 20000
        for i in range(0, len(victims), step):
            store.delete(victims[i : i + step])
        oracle.delete(victims)
        ok &= check("post-compaction", store, oracle, qs)

        # a restore of the compacted state's snapshot
        store.checkpoint(force=True)
        restored2 = VectorStore.load(root, device=device, mesh=mesh)
        ok &= check("restore after compaction", restored2, oracle, qs)

        summary["stats"] = {
            k: v for k, v in store.stats().items() if k in ("engine", "live", "tombstones", "capacity", "ivf")
        }

    summary["wall_s"] = round(time.perf_counter() - t_start, 3)
    if device.type == "cuda":
        summary["peak_device_bytes"] = int(torch.cuda.max_memory_allocated(device) - held)
    summary["ok"] = bool(ok)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=100_000)
    ap.add_argument("d", nargs="?", type=int, default=256)
    ap.add_argument(
        "--device",
        default=os.environ.get("IMATCH_DEVICE") or None,
        help="cuda (default, cuda:0) or cpu; IMATCH_DEVICE sets the default",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    summary = run(args.n, args.d, device)
    print(json.dumps(summary, default=str))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
