"""The port's store persistence against the JAX package's.

Each case of tests/test_index.py's persistence tests (:161, :173, :256,
:277, :292, :305, :318, :337, :710) runs on both stores, the port on the
CPU, with the JAX test's assertions on each and the answers of the two
compared (ids equal, distances within 1e-5). Then the directories cross:
a snapshot or a journal written by either package loads in the other with
the same ids, metadata, documents and answers, and one op sequence writes
byte-identical journal lines and equal snapshot files in both.
"""

import json
import os

import numpy as np
import pytest

from imatch_tpu.index.store import VectorStore as JaxStore
from imatch_tpu_torch.index.store import VectorStore

PKGS = ("jax", "torch")


def _make(pkg, **kw):
    return JaxStore(**kw) if pkg == "jax" else VectorStore(device="cpu", **kw)


def _load(pkg, path, **kw):
    return JaxStore.load(path, **kw) if pkg == "jax" else VectorStore.load(path, device="cpu", **kw)


def norm_rows(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _rows(seed, n, dim=8):
    return norm_rows(np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32))


def make_store(pkg, n=100, dim=32, seed=0, persist_dir=None):
    emb = _rows(seed, n, dim)
    store = _make(pkg, persist_dir=persist_dir)
    store.add(
        ids=[f"img_{i:04d}" for i in range(n)],
        embeddings=emb,
        metadatas=[{"i": i} for i in range(n)],
        documents=[f"doc {i}" for i in range(n)],
    )
    return store, emb


def _same_answers(a, b, q, n_results=10):
    ra = a.query(q, n_results=n_results, include=["metadatas", "documents", "distances"])
    rb = b.query(q, n_results=n_results, include=["metadatas", "documents", "distances"])
    assert ra["ids"] == rb["ids"]
    assert ra["metadatas"] == rb["metadatas"] and ra["documents"] == rb["documents"]
    for da, db in zip(ra["distances"], rb["distances"]):
        np.testing.assert_allclose(db, da, rtol=0, atol=1e-5)
    return rb


def _same_contents(a, b):
    ga = a.get(include=["metadatas", "documents", "embeddings"])
    gb = b.get(include=["metadatas", "documents", "embeddings"])
    assert ga["ids"] == gb["ids"]
    assert ga["metadatas"] == gb["metadatas"] and ga["documents"] == gb["documents"]
    np.testing.assert_array_equal(ga["embeddings"], gb["embeddings"])


def _dirs(tmp_path):
    return {pkg: str(tmp_path / pkg) for pkg in PKGS}


# -- ports of tests/test_index.py ------------------------------------------------


def test_save_load_roundtrip(tmp_path):
    loaded = {}
    for pkg, d in _dirs(tmp_path).items():
        store, emb = make_store(pkg, n=64)
        store.delete(["img_0000"])
        store.save(d)
        loaded[pkg] = _load(pkg, d)
        assert loaded[pkg].count() == 63
        res = store.query(query_embeddings=[emb[5]], n_results=3)
        res2 = loaded[pkg].query(query_embeddings=[emb[5]], n_results=3)
        assert res["ids"] == res2["ids"]
        np.testing.assert_allclose(res["distances"], res2["distances"], atol=1e-6)
    _same_contents(loaded["jax"], loaded["torch"])
    _same_answers(loaded["jax"], loaded["torch"], emb[:4])


def test_load_missing_dir_is_empty(tmp_path):
    for pkg in PKGS:
        store = _load(pkg, str(tmp_path / pkg / "nope"))
        assert store.count() == 0
        assert store.query([[1.0, 0.0]], n_results=3)["ids"] == [[]]


def test_journal_replay_without_snapshot(tmp_path):
    loaded = {}
    emb = _rows(0, 5)
    for pkg, d in _dirs(tmp_path).items():
        store = _make(pkg, persist_dir=d)
        store.add(
            ids=[f"a{i}" for i in range(5)],
            embeddings=emb,
            metadatas=[{"i": i} for i in range(5)],
            documents=[None] * 5,
        )
        store.update(ids=["a1"], metadatas=[{"i": 1, "x": True}])
        store.delete(["a3"])
        # never called save(); a fresh load must replay the journal
        loaded[pkg] = _load(pkg, d)
        assert loaded[pkg].count() == 4
        assert loaded[pkg].get(ids=["a1"])["metadatas"][0] == {"i": 1, "x": True}
        assert loaded[pkg].get(ids=["a3"])["ids"] == []
        res = loaded[pkg].query(query_embeddings=[emb[0]], n_results=1)
        assert res["ids"][0] == ["a0"]
        assert loaded[pkg].stats()["journal_ops"] == 7
    _same_contents(loaded["jax"], loaded["torch"])
    _same_answers(loaded["jax"], loaded["torch"], emb)


def test_journal_compaction_resets(tmp_path):
    emb = _rows(1, 3)
    for pkg, d in _dirs(tmp_path).items():
        store = _make(pkg, persist_dir=d)
        store.add(ids=["x0", "x1", "x2"], embeddings=emb)
        jpath = os.path.join(d, "journal.jsonl")
        assert os.path.exists(jpath)
        store.checkpoint()  # 3 ops: below max(256, live // 4)
        assert os.path.exists(jpath) and store.stats()["journal_ops"] == 3
        store.checkpoint(force=True)
        assert not os.path.exists(jpath)  # compacted into the snapshot
        assert store.stats()["journal_ops"] == 0
        loaded = _load(pkg, d)
        assert loaded.count() == 3


@pytest.mark.parametrize("pkg", PKGS)
def test_checkpoint_threshold(tmp_path, pkg):
    """checkpoint() saves once the journal holds max(256, live // 4) ops."""
    d = str(tmp_path / pkg)
    store = _make(pkg, persist_dir=d)
    emb = _rows(4, 300)
    store.add(ids=[f"c{i}" for i in range(255)], embeddings=emb[:255])
    store.checkpoint()
    assert not os.path.exists(os.path.join(d, "manifest.json"))
    store.add(ids=["c255"], embeddings=emb[255:256])
    store.checkpoint()
    assert os.path.exists(os.path.join(d, "manifest.json"))
    assert not os.path.exists(os.path.join(d, "journal.jsonl"))


def test_journal_torn_tail_is_ignored(tmp_path):
    emb = _rows(2, 2)
    for pkg, d in _dirs(tmp_path).items():
        store = _make(pkg, persist_dir=d)
        store.add(ids=["t0", "t1"], embeddings=emb)
        with open(os.path.join(d, "journal.jsonl"), "a") as f:
            f.write('{"op": "add", "id": "torn')  # crash mid-write
        loaded = _load(pkg, d, persist=False)
        assert loaded.count() == 2  # torn tail dropped, prefix intact
        # without persist the file is left as it was
        with open(os.path.join(d, "journal.jsonl")) as f:
            assert f.read().endswith('"torn')


def test_snapshot_plus_journal_roundtrip(tmp_path):
    emb = _rows(3, 6)
    loaded = {}
    for pkg, d in _dirs(tmp_path).items():
        store = _make(pkg, persist_dir=d)
        store.add(ids=[f"s{i}" for i in range(4)], embeddings=emb[:4])
        store.save()  # snapshot of 4
        store.add(ids=["s4", "s5"], embeddings=emb[4:])  # journaled on top
        store.delete(["s0"])
        loaded[pkg] = _load(pkg, d)
        assert loaded[pkg].count() == 5
        assert sorted(loaded[pkg].get(include=[])["ids"]) == ["s1", "s2", "s3", "s4", "s5"]
    _same_contents(loaded["jax"], loaded["torch"])


def test_journal_torn_tail_truncated_and_appendable(tmp_path):
    """After recovering from a torn tail, new appends must not glue onto
    the fragment (which would silently lose every later op next load)."""
    emb = _rows(5, 3)
    for pkg, d in _dirs(tmp_path).items():
        store = _make(pkg, persist_dir=d)
        store.add(ids=["a", "b"], embeddings=emb[:2])
        with open(os.path.join(d, "journal.jsonl"), "a") as f:
            f.write('{"op": "add", "id": "torn')  # crash mid-append
        s2 = _load(pkg, d)  # torn tail dropped AND truncated
        assert s2.count() == 2
        s2.add(ids=["c"], embeddings=emb[2:])  # append post-recovery
        s3 = _load(pkg, d)
        assert sorted(s3.get(include=[])["ids"]) == ["a", "b", "c"]


def test_snapshot_generation_commit(tmp_path):
    """The manifest is the commit record; counts are validated on load."""
    emb = _rows(6, 4)
    for pkg, d in _dirs(tmp_path).items():
        store = _make(pkg, persist_dir=d)
        store.add(ids=[f"g{i}" for i in range(4)], embeddings=emb)
        store.save()
        with open(os.path.join(d, "manifest.json")) as f:
            m = json.load(f)
        assert m["count"] == 4 and m["embeddings"].startswith("embeddings-")
        assert m["records"] == f"records-{m['generation']}.json"
        store.add(ids=["g4"], embeddings=emb[:1] * -1)
        store.save()  # a second generation collects the first
        files = sorted(f for f in os.listdir(d) if not f.startswith("."))
        assert len(files) == 3 and "manifest.json" in files, files
        with open(os.path.join(d, "manifest.json")) as f:
            m = json.load(f)
        m["count"] = 3  # corrupt: manifest count disagrees with records
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump(m, f)
        with pytest.raises(ValueError):
            _load(pkg, d)


def test_store_capacity_env_applies_on_load(tmp_path, monkeypatch):
    """IMATCH_STORE_CAPACITY must apply to a store that load() builds with
    dim=None, at the first capacity check."""
    caps = {}
    for pkg, d in _dirs(tmp_path).items():
        monkeypatch.delenv("IMATCH_STORE_CAPACITY", raising=False)
        store = _make(pkg, persist_dir=d)
        store.add(ids=["a"], embeddings=[[1.0, 0.0]])
        store.save()
        monkeypatch.setenv("IMATCH_STORE_CAPACITY", "5000")
        loaded = _load(pkg, d)
        assert loaded.count() == 1
        assert loaded._emb.shape[0] >= 5000
        caps[pkg] = loaded.stats()["capacity"]
    assert caps["jax"] == caps["torch"] == 8192


def test_capacity_reserved_at_construction():
    for pkg in PKGS:
        s = _make(pkg, dim=4, capacity=3000)
        assert s.stats()["capacity"] == 4096
        s.add(ids=["a"], embeddings=[[1.0, 0, 0, 0]])
        assert s.stats()["capacity"] == 4096


# -- across the packages -----------------------------------------------------------


def _ops(store, emb):
    """One op sequence with every journaled kind: adds with metadata and
    documents, metadata and embedding updates, deletes of live and
    unknown ids."""
    n = emb.shape[0]
    store.add(
        ids=[f"r{i}" for i in range(n - 4)],
        embeddings=emb[: n - 4],
        metadatas=[{"i": i, "tag": f"t{i % 3}", "nested": {"x": [i, 0.5]}} for i in range(n - 4)],
        documents=[f"doc {i}" if i % 2 else None for i in range(n - 4)],
    )
    store.update(ids=["r1", "r2"], metadatas=[{"i": 1, "edited": True}, {"i": 2, "é": "ü"}])
    store.update(ids=["r3"], embeddings=emb[n - 1 : n])
    store.update(ids=["r4"], embeddings=emb[n - 2 : n - 1], metadatas=[{"both": 1}])
    store.delete(["r5", "nope", "r6"])
    store.add(ids=["late0", "late1"], embeddings=emb[n - 4 : n - 2], metadatas=[{"late": 0}, {"late": 1}])


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_snapshot_written_by_one_loads_in_the_other(tmp_path, writer, reader):
    emb = _rows(7, 40, dim=24)
    d = str(tmp_path / "store")
    src = _make(writer)
    _ops(src, emb)
    src.save(d)
    got = _load(reader, d)
    same = _load(writer, d)
    _same_contents(src, got)
    _same_contents(same, got)
    _same_answers(src, got, emb[:6])
    _same_answers(same, got, emb[:6], n_results=100)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_journal_written_by_one_replays_in_the_other(tmp_path, writer, reader):
    """A snapshot with a journal on top, both from ``writer``."""
    emb = _rows(8, 40, dim=24)
    d = str(tmp_path / "store")
    src = _make(writer, persist_dir=d)
    src.add(ids=["base0", "base1"], embeddings=emb[:2], metadatas=[{"b": 0}, {"b": 1}])
    src.save()
    _ops(src, emb[2:])
    got = _load(reader, d)
    assert got.stats()["journal_ops"] == src.stats()["journal_ops"]
    _same_contents(src, got)
    _same_answers(src, got, emb[:6], n_results=50)
    # the reader keeps journaling into the same file; the writer replays it
    got.delete(["base0"])
    back = _load(writer, d)
    assert back.get(ids=["base0"])["ids"] == []
    _same_contents(got, back)


def test_same_ops_write_the_same_bytes(tmp_path, monkeypatch):
    """Byte-identical journal lines, and snapshot files with equal bytes
    (apart from the generation in their names)."""
    monkeypatch.setenv("IMATCH_JOURNAL_FSYNC", "0")
    emb = _rows(9, 30, dim=16)
    dirs = _dirs(tmp_path)
    stores = {pkg: _make(pkg, persist_dir=d) for pkg, d in dirs.items()}
    for s in stores.values():
        _ops(s, emb)
    journals = {}
    for pkg, d in dirs.items():
        with open(os.path.join(d, "journal.jsonl"), "rb") as f:
            journals[pkg] = f.read().splitlines()
    assert len(journals["torch"]) == 26 + 2 + 1 + 1 + 2 + 2
    assert journals["jax"] == journals["torch"]
    files = {}
    for pkg, s in stores.items():
        s.checkpoint(force=True)
        with open(os.path.join(dirs[pkg], "manifest.json")) as f:
            m = json.load(f)
        with open(os.path.join(dirs[pkg], m["embeddings"]), "rb") as f:
            npy = f.read()
        with open(os.path.join(dirs[pkg], m["records"]), "rb") as f:
            records = f.read()
        files[pkg] = (m["dim"], m["count"], npy, records)
        assert not os.path.exists(os.path.join(dirs[pkg], "journal.jsonl"))
    assert files["jax"] == files["torch"]


def test_load_ignores_an_ivf_sidecar(tmp_path):
    """A JAX ivf store's snapshot carries an ``ivf`` sidecar. A tilemax
    store of either package serves exact answers beside it, keeps its IVF
    host state through the load and writes it again at its next save, so
    an ivf store started later on the directory need not retrain."""
    emb = _rows(10, 300, dim=16)
    d = str(tmp_path / "store")
    src = JaxStore(engine="ivf")
    src.add(ids=[f"v{i}" for i in range(300)], embeddings=emb)
    src.query(emb[:1], n_results=3)  # trains the clustering
    src.save(d)
    with open(os.path.join(d, "manifest.json")) as f:
        assert "ivf" in json.load(f)
    got = _load("torch", d)
    ref = _load("jax", d)
    exact = JaxStore(engine="tilemax")
    exact.add(ids=[f"v{i}" for i in range(300)], embeddings=emb)
    _same_contents(ref, got)
    _same_answers(exact, got, emb[:5])
    saved = {}
    for name, store in (("jax", ref), ("torch", got)):
        out = str(tmp_path / name)
        store.save(out)
        with open(os.path.join(out, "manifest.json")) as f:
            side = json.load(f)["ivf"]
        assert [f for f in os.listdir(out) if f.startswith("ivf")] == [side]
        with np.load(os.path.join(out, side)) as z:
            saved[name] = {k: z[k] for k in z.files}
    assert sorted(saved["jax"]) == sorted(saved["torch"])
    for key, value in saved["jax"].items():
        np.testing.assert_array_equal(saved["torch"][key], value)
