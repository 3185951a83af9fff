"""The port's query coalescer and the store's concurrency contract, on the
CPU: ports of tests/test_concurrency.py:149-531.

- Concurrent searches overlap instead of serialising behind the store
  lock; batched (Q, d) queries racing writers stay well formed.
- With ``coalesce=True``, concurrent single-row queries return what direct
  calls return (and what the JAX store returns on the same rows) and share
  engine calls; engine errors reach every waiting caller and leave the
  worker alive; IMATCH_COALESCE alone does not enable it on a CPU store;
  mixed limits group by (k, include); ``close`` racing submitters strands
  no caller; a discarded store is collected.

Every thread is joined with a timeout, and a hung thread fails its test.
"""

import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from imatch_tpu.index.store import VectorStore as JaxStore
from imatch_tpu_torch.index.store import VectorStore
from imatch_tpu_torch.runtime.coalesce import CoalescerClosed, QueryCoalescer


def _store(**kw):
    return VectorStore(device="cpu", **kw)


def _unit(rng, n, d):
    e = rng.standard_normal((n, d)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _run_threads(targets, timeout=60):
    threads = [threading.Thread(target=t, args=a) for t, a in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive(), "a thread hung"


def test_concurrent_searches_pipeline_not_serialize():
    rng = np.random.default_rng(0)
    emb = _unit(rng, 256, 32)
    store = _store()
    store.add(ids=[f"i{i}" for i in range(256)], embeddings=emb)
    store.query([emb[0]], n_results=4)  # builds the device state
    orig = store._run_engine
    delay = 0.15

    def slow_engine(q, dc, k):
        time.sleep(delay)  # stands in for device latency
        return orig(q, dc, k)

    store._run_engine = slow_engine
    errors = []

    def one(i):
        try:
            assert store.query([emb[i]], n_results=4)["ids"][0][0] == f"i{i}"
        except Exception as e:
            errors.append(e)

    t0 = time.perf_counter()
    _run_threads([(one, (i,)) for i in range(8)], timeout=30)
    wall = time.perf_counter() - t0
    assert not errors, errors
    assert wall < 8 * delay / 2, f"searches serialized: {wall:.2f}s"


def test_batch_queries_race_writers():
    rng = np.random.default_rng(7)
    base = _unit(rng, 128, 32)
    store = _store()
    store.add(ids=[f"i{i}" for i in range(128)], embeddings=base)
    store.query(base[:3], n_results=4)
    stop = threading.Event()
    errors = []

    def writer():
        wrng = np.random.default_rng(100)
        try:
            j = 0
            while not stop.is_set():
                store.add(ids=[f"w{j}_{k}" for k in range(4)], embeddings=_unit(wrng, 4, 32))
                store.delete([f"w{j}_0"])
                j += 1
        except Exception as e:
            errors.append(("writer", e))

    def batch_reader(seed):
        rrng = np.random.default_rng(seed)
        try:
            for _ in range(25):
                r = store.query(base[rrng.integers(0, 128, size=3)], n_results=5)
                assert len(r["ids"]) == 3
                for row in r["ids"]:
                    assert 0 < len(row) <= 5
        except Exception as e:
            errors.append(("reader", e))

    w = threading.Thread(target=writer)
    w.start()
    try:
        _run_threads([(batch_reader, (s,)) for s in range(3)])
    finally:
        stop.set()
        w.join(timeout=30)
    assert not w.is_alive(), "writer hung"
    assert not errors, errors


def test_coalescer_batches_and_matches_direct():
    rng = np.random.default_rng(11)
    emb = _unit(rng, 200, 32)
    ids = [f"i{i}" for i in range(200)]
    direct = _store()
    direct.add(ids=ids, embeddings=emb)
    expected = [direct.query(emb[i], n_results=4)["ids"][0] for i in range(32)]
    jax_store = JaxStore()
    jax_store.add(ids=ids, embeddings=emb)
    assert expected == [jax_store.query(emb[i], n_results=4)["ids"][0] for i in range(32)]

    store = _store(coalesce=True)
    assert store.coalescing and store.stats()["coalescing"]
    store.add(ids=ids, embeddings=emb)
    store.query(emb[0], n_results=4)  # spins up the worker
    calls = []
    orig = store._run_engine

    def counting_engine(q, dc, k):
        calls.append(int(q.shape[0]))
        time.sleep(0.03)  # widen the window so batches form
        return orig(q, dc, k)

    store._run_engine = counting_engine
    results = [None] * 32
    errors = []

    def one(i):
        try:
            results[i] = store.query(emb[i], n_results=4)["ids"][0]
        except Exception as e:
            errors.append(e)

    _run_threads([(one, (i,)) for i in range(32)])
    assert not errors, errors
    assert results == expected
    assert sum(calls) == 32, calls  # the port pads no rows: one a request
    assert len(calls) < 32, f"no coalescing happened: {calls}"
    store.set_coalescing(False)


def test_coalescer_propagates_engine_errors():
    rng = np.random.default_rng(13)
    emb = _unit(rng, 64, 16)
    store = _store(coalesce=True)
    store.add(ids=[f"i{i}" for i in range(64)], embeddings=emb)
    store.query(emb[0], n_results=3)
    orig = store._run_engine

    def failing(q, dc, k):
        raise RuntimeError("engine down")

    store._run_engine = failing
    with pytest.raises(RuntimeError, match="engine down"):
        store.query(emb[1], n_results=3)
    store._run_engine = orig  # the worker still serves afterwards
    assert store.query(emb[2], n_results=3)["ids"][0][0] == "i2"
    store.set_coalescing(False)


def test_coalescer_gate_and_lifecycle(monkeypatch):
    """IMATCH_COALESCE enables coalescing on a card's store only (batched
    scoring on the CPU is bound by its multiply-adds); the constructor
    argument and set_coalescing always win."""
    monkeypatch.setenv("IMATCH_COALESCE", "1")
    assert not _store().coalescing
    assert not VectorStore.load("/nonexistent-store-dir", persist=False, device="cpu").coalescing
    store = _store(coalesce=True)
    assert store.coalescing
    emb = np.eye(4, dtype=np.float32)
    store.add(ids=["a", "b", "c", "d"], embeddings=emb)
    assert store.query(emb[1], n_results=1)["ids"][0] == ["b"]
    store.set_coalescing(False)
    assert not store.coalescing and not store.stats()["coalescing"]
    assert store.query(emb[2], n_results=1)["ids"][0] == ["c"]


def test_coalescer_mixed_limits_grouped_correctly():
    rng = np.random.default_rng(17)
    emb = _unit(rng, 100, 16)
    store = _store(coalesce=True)
    store.add(ids=[f"i{i}" for i in range(100)], embeddings=emb)
    store.query(emb[0], n_results=3)
    orig = store._run_engine

    def slow_engine(q, dc, k):
        time.sleep(0.02)  # lets mixed-k batches form
        return orig(q, dc, k)

    store._run_engine = slow_engine
    out, errors = {}, []

    def one(i, k):
        try:
            out[(i, k)] = store.query(emb[i], n_results=k)["ids"][0]
        except Exception as e:
            errors.append(e)

    jobs = [(i, k) for i in range(12) for k in (3, 7)]
    _run_threads([(one, j) for j in jobs])
    assert not errors, errors
    store.set_coalescing(False)
    for i, k in jobs:
        row = out[(i, k)]
        assert len(row) == k and row[0] == f"i{i}", (i, k, row)
        assert row == store.query(emb[i], n_results=k)["ids"][0]


def test_coalescer_close_races_submitters():
    for _ in range(10):
        store = _store(dim=8, engine="tilemax", coalesce=True)
        emb = np.eye(8, dtype=np.float32)
        store.add(ids=[f"r{i}" for i in range(8)], embeddings=emb)
        outcomes = []

        def hammer():
            try:
                outcomes.append(("ok", store.query(emb[:1], n_results=2)["ids"][0][0]))
            except Exception as e:  # noqa: BLE001
                outcomes.append(("err", type(e).__name__))

        ts = [threading.Thread(target=hammer) for _ in range(6)]
        for t in ts[:3]:
            t.start()
        store.set_coalescing(False)
        for t in ts[3:]:
            t.start()
        for t in ts:
            t.join(timeout=30)
            assert not t.is_alive(), "stranded submitter"
        # CoalescerClosed turns into a direct dispatch: every request succeeds
        assert all(o == ("ok", "r0") for o in outcomes), outcomes


def test_discarded_store_with_coalescer_is_collected():
    store = _store(dim=8, engine="tilemax", coalesce=True)
    store.add(ids=["a"], embeddings=np.eye(8, dtype=np.float32)[:1])
    store.query(np.eye(8, dtype=np.float32)[:1], n_results=1)  # starts the worker
    ref = weakref.ref(store)
    del store
    for _ in range(20):
        gc.collect()
        if ref() is None:
            break
        time.sleep(0.05)
    assert ref() is None, "the coalescer's worker pinned the discarded store"


def test_stack_keeps_tensors_and_numpy_apart():
    rows = [np.full((1, 4), i, np.float32) for i in range(3)]
    out = QueryCoalescer._stack(rows)
    assert isinstance(out, np.ndarray) and out.shape == (3, 4)
    mixed = QueryCoalescer._stack([torch.ones(1, 4), rows[2]])
    assert isinstance(mixed, torch.Tensor) and mixed.dtype == torch.float32
    assert mixed.tolist() == [[1.0] * 4, [2.0] * 4]
    assert QueryCoalescer._stack(rows[:1]) is rows[0]


def test_closed_coalescer_rejects_submit():
    c = QueryCoalescer(lambda q, k, inc: {"ids": [["x"]] * q.shape[0]})
    assert c.submit(np.zeros((1, 4), np.float32), 1, ("distances",)) == {"ids": [["x"]]}
    c.close()
    with pytest.raises(CoalescerClosed):
        c.submit(np.zeros((1, 4), np.float32), 1, ("distances",))
    with pytest.raises(ValueError):
        QueryCoalescer(lambda *a: None, max_batch=0)
