"""The store lock is free while the device state is built or queried.

Ports of tests/test_index.py:441 (the engine runs outside the lock),
:497 (the build reads copies of the host buffers, not the live ones) and
:547 (a mutation during the build: the query serves its own snapshot, the
next one sees the mutation), each on both packages, the port on the CPU.
The last test holds the build itself on an event: a writer in another
thread must return within 0.1 s, which is the fault the port had when
its build ran under the lock.
"""

import threading
import time

import numpy as np
import pytest

import imatch_tpu.index.store as jax_store_mod
import imatch_tpu_torch.index.store as store_mod
from imatch_tpu.index.store import VectorStore as JaxStore
from imatch_tpu_torch.index.store import VectorStore

PKGS = ("jax", "torch")


def _make(pkg, **kw):
    return JaxStore(**kw) if pkg == "jax" else VectorStore(device="cpu", **kw)


def make_store(pkg, n=100, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    store = _make(pkg)
    store.add(ids=[f"img_{i:04d}" for i in range(n)], embeddings=emb)
    return store, emb


@pytest.mark.parametrize("pkg", PKGS)
def test_query_runs_outside_store_lock(pkg):
    """A writer grabbing the lock mid-query neither deadlocks nor waits
    for the query's round trip."""
    store, emb = make_store(pkg, n=128)
    release = threading.Event()
    orig = store._run_engine

    def slow_engine(q, dc, k):
        release.set()
        time.sleep(0.2)  # keep the "device" busy
        return orig(q, dc, k)

    store._run_engine = slow_engine
    got = []
    t = threading.Thread(target=lambda: got.append(store.query(query_embeddings=[emb[0]], n_results=4)))
    t.start()
    assert release.wait(5)
    t0 = time.perf_counter()
    acquired = store._lock.acquire(timeout=5)
    dt = time.perf_counter() - t0
    assert acquired
    store._lock.release()
    t.join(10)
    assert not t.is_alive()
    assert dt < 0.1, f"writer blocked {dt:.3f}s behind an in-flight query"
    assert got[0]["ids"][0][0] == "img_0000"
    assert store._inflight == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_device_snapshot_not_aliased_to_live_buffers(pkg):
    """The build copies the host buffers: writers mutate _emb/_alive in
    place after the lock drops, and a CPU tensor can alias numpy memory."""
    store = _make(pkg, dim=4)
    store.add(ids=["a"], embeddings=[[1.0, 0, 0, 0]])
    store._device_state()
    # mutate the live buffer the way add()/update() do
    store._emb[0] = np.asarray([0, 1.0, 0, 0], np.float32)
    res = store.query([[1.0, 0, 0, 0]], n_results=1)
    # the cached device state still holds the ORIGINAL row
    assert res["ids"][0][0] == "a"
    assert abs(res["distances"][0][0]) < 1e-5  # exact match, not torn


@pytest.mark.parametrize("pkg", PKGS)
def test_mutation_during_device_build_stays_consistent(pkg, monkeypatch):
    """A mutation landing mid-build does not corrupt the serving query
    (the stale build matches its captured snapshot) and the next query
    sees a fresh build with the mutation (generation check)."""
    store = _make(pkg, dim=4)
    store.add(ids=["a"], embeddings=[[1.0, 0, 0, 0]])
    orig = store._build_device

    def racy(*args):
        dc = orig(*args)
        store.add(ids=["b"], embeddings=[[0, 1.0, 0, 0]])  # mid-build write
        return dc

    monkeypatch.setattr(store, "_build_device", racy)
    res = store.query([[0, 1.0, 0, 0]], n_results=2)
    # 'b' was added after the snapshot: this query serves the stale but
    # self-consistent state, which is not installed
    assert res["ids"][0] == ["a"]
    assert not store.stats()["device_ready"]
    monkeypatch.setattr(store, "_build_device", orig)
    res2 = store.query([[0, 1.0, 0, 0]], n_results=2)
    assert res2["ids"][0][0] == "b"  # fresh build sees the mutation
    assert store.stats()["device_ready"]


@pytest.mark.parametrize("pkg", PKGS)
def test_writer_returns_while_the_build_is_held(pkg, monkeypatch):
    """The build blocks on an event; an add from another thread returns
    at once (the copy under the lock is all it waits for), the held query
    then serves its own snapshot, and the next query sees the add."""
    mod = jax_store_mod if pkg == "jax" else store_mod
    orig = mod.prepare_device_corpus
    building, release = threading.Event(), threading.Event()

    def held_build(*args, **kw):
        building.set()
        release.wait(10)
        return orig(*args, **kw)

    monkeypatch.setattr(mod, "prepare_device_corpus", held_build)
    store, emb = make_store(pkg, n=64)
    got = []
    t = threading.Thread(target=lambda: got.append(store.query([emb[3]], n_results=3)))
    t.start()
    assert building.wait(10)
    # if the add cannot return, free the build after 2 s so the test
    # fails on the time instead of hanging
    safety = threading.Timer(2.0, release.set)
    safety.start()
    t0 = time.perf_counter()
    store.add(ids=["new"], embeddings=emb[3:4])
    dt = time.perf_counter() - t0
    release.set()
    safety.cancel()
    t.join(10)
    assert not t.is_alive()
    assert dt < 0.1, f"add waited {dt:.3f}s for the device build"
    assert got[0]["ids"][0][0] == "img_0003" and "new" not in got[0]["ids"][0]
    monkeypatch.setattr(mod, "prepare_device_corpus", orig)
    ids = store.query([emb[3]], n_results=2)["ids"][0]
    assert sorted(ids) == ["img_0003", "new"]
