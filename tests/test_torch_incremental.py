"""The port's incremental device-state patching (index/patch.py) against
the JAX package's.

Mutations on a store with a prepared device state are absorbed as
O(batch) patches, and the patched state answers exactly as a fresh
build of the same content does: ports of tests/test_incremental.py
(:63-89 on the exact engines the port has, :119, :130, :146, :197, :226
and :244), each run on both stores with the port on the CPU, ids equal
and distances within 1e-5. A patched state also equals a fresh build of
the same host buffers tensor for tensor.
"""

import threading

import numpy as np
import pytest
import torch

from imatch_tpu.index.store import VectorStore as JaxStore
from imatch_tpu_torch.index import patch
from imatch_tpu_torch.index.search import DeviceCorpus
from imatch_tpu_torch.index.store import VectorStore

D = 32
PKGS = ("jax", "torch")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for key in ("IMATCH_COALESCE", "IMATCH_INCREMENTAL", "IMATCH_SCORE_DTYPE", "IMATCH_STORE_CAPACITY"):
        monkeypatch.delenv(key, raising=False)


def _make(pkg, **kw):
    return JaxStore(**kw) if pkg == "jax" else VectorStore(device="cpu", **kw)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(n, D)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _ids(pre, n, base=0):
    return [f"{pre}{i}" for i in range(base, base + n)]


def _assert_same(r1, r2):
    assert r1["ids"] == r2["ids"]
    d1 = np.array(sum(r1["distances"], []))
    d2 = np.array(sum(r2["distances"], []))
    assert np.allclose(d1, d2, atol=1e-5)


def _fresh(pkg, s, **kw):
    f = _make(pkg, **kw)
    g = s.get(include=("metadatas", "embeddings"))
    f.add(g["ids"], g["embeddings"])
    return f


def _assert_states_equal(a, b):
    """Two prepared states, tensor for tensor (and the host arrays of the
    tilemax-host tier)."""
    assert type(a) is type(b)
    for name, x in a._asdict().items():
        y = getattr(b, name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name


EXACT_ENGINES = [
    ("tilemax", "bf16"),
    ("tilemax", "fp32"),
    ("tilemax", "int8"),
    ("pallas", "bf16"),
    ("tilemax-host", "bf16"),
]


@pytest.mark.parametrize("engine,dtype", EXACT_ENGINES)
def test_patched_matches_fresh_rebuild(engine, dtype, monkeypatch):
    """add/delete/update after a device build patch in place and answer
    exactly like a fresh store over the final content, and like JAX."""
    monkeypatch.setenv("IMATCH_SCORE_DTYPE", dtype)
    q = _rows(5, 99)
    got = {}
    for pkg in PKGS:
        s = _make(pkg, dim=D, engine=engine)
        s.add(_ids("a", 200), _rows(200, 0))
        s.query(q, n_results=10)  # force the device build
        s.add(_ids("b", 50), _rows(50, 1))
        s.delete(_ids("a", 7))
        s.update(_ids("a", 5, 10), embeddings=_rows(5, 2))
        r1 = s.query(q, n_results=25)
        st = s.stats()
        # appends + deletes always patch; embedding updates patch on the
        # device-only engines and fall back on tilemax-host
        expect_patched = 2 if engine == "tilemax-host" else 3
        assert st["patched_mutations"] == expect_patched, pkg
        assert st["rebuild_mutations"] == 3 - expect_patched, pkg
        assert st["device_ready"]
        _assert_same(r1, _fresh(pkg, s, dim=D, engine=engine).query(q, n_results=25))
        got[pkg] = (r1, s)
    _assert_same(got["jax"][0], got["torch"][0])
    s = got["torch"][1]
    if engine != "tilemax-host":  # its update rebuilt: nothing left to compare
        _assert_states_equal(s._device_corpus[1], s._build_device(s._emb.copy(), s._alive.copy())[0][1])


@pytest.mark.parametrize("engine,dtype", EXACT_ENGINES)
def test_patched_state_equals_a_fresh_build(engine, dtype, monkeypatch):
    """Appends and deletes (and updates, where the engine patches them)
    leave the prepared state equal to a fresh build of the same host
    buffers: every tensor, the int8 codes and scales included."""
    monkeypatch.setenv("IMATCH_SCORE_DTYPE", dtype)
    s = VectorStore(dim=D, engine=engine, device="cpu")
    s.add(_ids("a", 300), _rows(300, 0) * np.float32(3.0))
    s.add(["zero"], np.zeros((1, D), np.float32))  # scale 1 for a zero row
    s.query(_rows(1, 9), n_results=3)
    s.add(_ids("b", 17), _rows(17, 1) * np.float32(0.25))
    s.delete(_ids("a", 11, 40) + ["zero"])
    if engine != "tilemax-host":
        s.update(_ids("b", 3), embeddings=_rows(3, 2))
    assert s.stats()["rebuild_mutations"] == 0
    _assert_states_equal(s._device_corpus[1], s._build_device(s._emb.copy(), s._alive.copy())[0][1])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("engine,dtype", [("tilemax", "bf16"), ("tilemax", "int8"), ("tilemax-host", "bf16")])
def test_random_patched_sequence_matches_jax(engine, dtype, seed, monkeypatch):
    """One random sequence of adds, updates and deletes with queries in
    between (so every mutation lands on a built state) gives the same ids
    in both packages and the same patch counts."""
    monkeypatch.setenv("IMATCH_SCORE_DTYPE", dtype)
    rng = np.random.default_rng(seed)
    stores = {pkg: _make(pkg, dim=D, engine=engine) for pkg in PKGS}
    live, next_id = [], 0
    for step in range(24):
        op = rng.choice(["add", "add", "update", "delete"]) if live else "add"
        if op == "add":
            n = int(rng.integers(1, 40))
            ids = _ids("r", n, next_id)
            next_id += n
            emb = _rows(n, 1000 + step)
            for s in stores.values():
                s.add(ids, emb, metadatas=[{"step": step}] * n)
            live += ids
        elif op == "update":
            ids = list(rng.choice(live, size=min(len(live), 4), replace=False))
            emb = _rows(len(ids), 2000 + step)
            for s in stores.values():
                s.update(ids, embeddings=emb)
        else:
            ids = list(rng.choice(live, size=min(len(live), int(rng.integers(1, 9))), replace=False))
            for s in stores.values():
                s.delete(ids)
            live = [i for i in live if i not in set(ids)]
        q = _rows(3, 3000 + step)
        _assert_same(stores["jax"].query(q, n_results=8), stores["torch"].query(q, n_results=8))
    sj, st = stores["jax"].stats(), stores["torch"].stats()
    assert (sj["patched_mutations"], sj["rebuild_mutations"]) == (st["patched_mutations"], st["rebuild_mutations"])
    assert st["patched_mutations"] > 0


@pytest.mark.parametrize("pkg", PKGS)
def test_kill_switch(monkeypatch, pkg):
    monkeypatch.setenv("IMATCH_INCREMENTAL", "0")
    assert not patch.enabled()
    s = _make(pkg, dim=D, engine="tilemax")
    s.add(_ids("a", 10), _rows(10, 0))
    s.query(_rows(1, 9), n_results=3)
    s.add(_ids("b", 5), _rows(5, 1))
    st = s.stats()
    assert st["patched_mutations"] == 0 and st["rebuild_mutations"] == 1
    assert not st["device_ready"]


@pytest.mark.parametrize("pkg", PKGS)
def test_capacity_growth_falls_back(pkg):
    """An add that grows the capacity buffer cannot patch (the device
    tensors are the wrong shape); correctness survives the rebuild."""
    s = _make(pkg, dim=D, engine="tilemax")
    s.add(_ids("a", 1000), _rows(1000, 0))
    s.query(_rows(1, 9), n_results=3)
    s.add(_ids("b", 200), _rows(200, 1))  # 1200 > _MIN_CAP=1024
    assert s.stats()["patched_mutations"] == 0
    assert s.stats()["capacity"] == 2048
    q = _rows(3, 99)
    _assert_same(s.query(q, n_results=10), _fresh(pkg, s, dim=D, engine="tilemax").query(q, n_results=10))


def test_reserved_capacity_patches_past_the_first_doubling():
    """With capacity reserved, the same growth lands in the uploaded
    padding and patches."""
    s = VectorStore(dim=D, engine="tilemax", capacity=2048, device="cpu")
    s.add(_ids("a", 1000), _rows(1000, 0))
    s.query(_rows(1, 9), n_results=3)
    s.add(_ids("b", 200), _rows(200, 1))
    st = s.stats()
    assert (st["patched_mutations"], st["capacity"], st["last_build"]["rows"]) == (1, 2048, 2048)
    q = _rows(3, 99)
    _assert_same(s.query(q, n_results=10), _fresh("torch", s, dim=D, engine="tilemax").query(q, n_results=10))


@pytest.mark.parametrize("pkg", PKGS)
def test_compaction_falls_back(pkg):
    """Deleting past the tombstone threshold compacts (slots move): the
    patch is skipped, results stay right."""
    s = _make(pkg, dim=D, engine="tilemax")
    s.add(_ids("a", 1200), _rows(1200, 0))
    s.query(_rows(1, 9), n_results=3)
    s.delete(_ids("a", 700))  # > half dead -> compaction
    assert s.count() == 500
    assert s.stats()["patched_mutations"] == 0
    assert not s.stats()["device_ready"]
    q = _rows(3, 99)
    _assert_same(s.query(q, n_results=10), _fresh(pkg, s, dim=D, engine="tilemax").query(q, n_results=10))


@pytest.mark.parametrize("engine", ["tilemax", "tilemax-host"])
@pytest.mark.parametrize("pkg", PKGS)
def test_old_snapshot_survives_patched_append(pkg, engine):
    """A query snapshot captured BEFORE a mutation keeps answering from
    the pre-mutation state: the patch may not write into tensors an
    in-flight query holds, and the tilemax-host tier's shared host matrix
    must mask the new rows through its copied validity."""
    s = _make(pkg, dim=D, engine=engine)
    s.add(_ids("a", 50), _rows(50, 0))
    s.query(_rows(1, 9), n_results=3)
    live, dc, ids_l, _, _ = s._snapshot_for_query()
    try:
        assert s._inflight == 1
        new = _rows(8, 1)
        s.add(_ids("b", 8), new)
        assert s.stats()["patched_mutations"] == 1
        scores, idx = [np.asarray(x) for x in s._run_engine(new[:1], dc, 4)]
        found = [ids_l[i] for i in idx[0] if 0 <= i < len(ids_l)]
        assert not any(f.startswith("b") for f in found), (engine, found)
    finally:
        s._release_snapshot(dc)
    assert s._inflight == 0
    r = s.query(new[:1], n_results=1)
    assert r["ids"][0][0] == "b0"
    assert r["distances"][0][0] < 1e-5


@pytest.mark.parametrize("engine,dtype", EXACT_ENGINES)
def test_patch_writes_in_place_only_when_no_query_holds_the_state(engine, dtype, monkeypatch):
    """The counterpart of buffer donation: with no query in flight the
    patch writes into the state's own tensors; with one in flight it
    patches clones and the captured tensors keep their contents."""
    monkeypatch.setenv("IMATCH_SCORE_DTYPE", dtype)
    s = VectorStore(dim=D, engine=engine, device="cpu")
    s.add(_ids("a", 40), _rows(40, 0))
    s.query(_rows(1, 9), n_results=3)
    state = s._device_corpus[1]
    s.add(_ids("b", 4), _rows(4, 1))
    s.delete(["a0"])
    after = s._device_corpus[1]
    assert after.scoring is state.scoring and after.valid is state.valid
    assert bool(after.valid[40]) and not bool(after.valid[0])

    _, dc, _, _, _ = s._snapshot_for_query()
    try:
        held = dc[1]
        before = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in held._asdict().items()}
        host_valid = held.host_valid.copy() if hasattr(held, "host_valid") else None
        s.add(_ids("c", 3), _rows(3, 2))
        s.delete(["a1"])
        new = s._device_corpus[1]
        assert new.scoring is not held.scoring and new.valid is not held.valid
        for k, v in held._asdict().items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, before[k]), k
        if host_valid is not None:
            np.testing.assert_array_equal(held.host_valid, host_valid)
    finally:
        s._release_snapshot(dc)
    assert s.stats()["rebuild_mutations"] == 0


def test_patch_declines_what_it_cannot_patch():
    """update_rows returns None for the host tier, and a failing patch
    falls back to a rebuild that still answers right."""
    s = VectorStore(dim=D, engine="tilemax-host", device="cpu")
    s.add(_ids("a", 20), _rows(20, 0))
    s.query(_rows(1, 9), n_results=3)
    dc = s._device_corpus
    assert patch.update_rows(dc, np.array([0]), _rows(1, 1), in_place=True) is None

    t = VectorStore(dim=D, engine="tilemax", device="cpu")
    t.add(_ids("a", 20), _rows(20, 0))
    t.query(_rows(1, 9), n_results=3)
    eng, state = t._device_corpus
    t._device_corpus = (eng, DeviceCorpus(state.scoring, state.exact[:8], state.valid, state.tile_n, state.margin))
    t.add(["n"], _rows(1, 5))  # slot 20 is past the cut rows: the patch raises
    assert t.stats()["rebuild_mutations"] == 1 and not t.stats()["device_ready"]
    assert t.query(_rows(1, 5), n_results=1)["ids"] == [["n"]]


def test_patched_store_persists(tmp_path):
    """Journal replay and a snapshot round trip agree with a patched
    store, in both packages."""
    q = _rows(3, 99)
    for pkg in PKGS:
        p = str(tmp_path / pkg)
        s = _make(pkg, dim=D, engine="tilemax", persist_dir=p)
        s.add(_ids("a", 30), _rows(30, 0))
        s.query(_rows(1, 9), n_results=3)
        s.add(_ids("b", 10), _rows(10, 1))
        s.delete(_ids("a", 3))
        assert s.stats()["patched_mutations"] == 2
        want = s.query(q, n_results=10)
        load = JaxStore.load if pkg == "jax" else (lambda d: VectorStore.load(d, device="cpu"))
        r = load(p)
        _assert_same(want, r.query(q, n_results=10))
        s.save(p)
        r2 = load(p)
        _assert_same(want, r2.query(q, n_results=10))


def test_concurrent_writers_and_readers_with_patching():
    """Racing adds/deletes against queries with patching live: every
    result is internally consistent (ids resolve, distances sorted) and
    the final state matches a fresh rebuild."""
    s = VectorStore(dim=D, engine="tilemax", device="cpu")
    s.add(_ids("seed", 64), _rows(64, 0))
    s.query(_rows(1, 9), n_results=3)
    errs = []
    stop = threading.Event()

    def writer():
        try:
            for i in range(12):
                s.add(_ids(f"w{i}_", 8), _rows(8, 100 + i))
                if i % 3 == 2:
                    s.delete([f"w{i}_0"])
        except Exception as e:  # pragma: no cover
            errs.append(e)
        finally:
            stop.set()

    def reader():
        q = _rows(2, 999)
        try:
            while not stop.is_set():
                r = s.query(q, n_results=5)
                for row in r["distances"]:
                    assert row == sorted(row)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=writer)] + [threading.Thread(target=reader) for _ in range(2)]
    [t.start() for t in ts]
    [t.join(timeout=120) for t in ts]
    assert not any(t.is_alive() for t in ts)
    assert not errs
    assert s._inflight == 0
    assert s.stats()["patched_mutations"] == 16
    q = _rows(3, 99)
    ref = JaxStore(dim=D, engine="tilemax")
    g = s.get(include=("embeddings",))
    ref.add(g["ids"], g["embeddings"])
    _assert_same(s.query(q, n_results=10), _fresh("torch", s, dim=D, engine="tilemax").query(q, n_results=10))
    _assert_same(s.query(q, n_results=10), ref.query(q, n_results=10))
