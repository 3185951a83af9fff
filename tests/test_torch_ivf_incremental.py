"""Incremental IVF on the PyTorch port, and the IVF sidecar across packages.

The cases of tests/test_ivf_incremental.py on the port's store: a build
after mutations REPAIRS the index (assigns new rows against the existing
centroids) instead of re-running k-means, until the live set outgrows
IMATCH_IVF_REBUILD_FRAC; compaction remaps the assignments; the sharded
kind retrains after a capacity growth; the trained state survives a
restart through the ``ivf-<gen>.npz`` sidecar, whose corrupt or
mismatched forms retrain and never block the load. A counter on the
port's ``train_centroids`` counts the k-means runs. The sharded cases run
8 shards on the CPU, as the JAX suite's 8-device mesh (conftest.py).

Then the sidecar across packages, for ``ivf`` and (8 shards)
``ivf-sharded``: a snapshot directory one package wrote loads in the
other without retraining, both answer with the same ids at every
``n_probe`` (distances within 1e-6), and the npz files hold the same
keys.
"""

import json
import os

import numpy as np
import pytest

import imatch_tpu.index.ivf as jax_ivf_mod
import imatch_tpu_torch.index.ivf as ivf_mod
from imatch_tpu.index.store import VectorStore as JaxStore
from imatch_tpu_torch.index.store import VectorStore

MESH8 = ("cpu",) * 8


def norm_rows(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _counter(monkeypatch, module):
    calls = {"n": 0}
    orig = module.train_centroids

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(module, "train_centroids", counting)
    return calls


@pytest.fixture
def train_counter(monkeypatch):
    """Counts the port's k-means runs; repair builds add none."""
    return _counter(monkeypatch, ivf_mod)


@pytest.fixture
def full_probe(monkeypatch):
    monkeypatch.setenv("IMATCH_IVF_NPROBE", "1000000")


def _store(engine, **kw):
    if engine == "ivf-sharded":
        kw.setdefault("mesh", MESH8)
    return VectorStore(engine=engine, device="cpu", **kw)


def _load(path, engine, monkeypatch):
    monkeypatch.setenv("IMATCH_INDEX_ENGINE", engine)
    return VectorStore.load(path, device="cpu", mesh=MESH8 if engine == "ivf-sharded" else None)


def _corpus(n, d=32, seed=0):
    return norm_rows(np.random.default_rng(seed).standard_normal((n, d))).astype(np.float32)


def _ids(n, base=0):
    return [f"r{base + i:06d}" for i in range(n)]


def assert_same_results(a, b):
    assert a["ids"] == b["ids"]
    for da, db in zip(a["distances"], b["distances"]):
        np.testing.assert_allclose(da, db, atol=1e-5)


def test_incremental_add_repairs_without_retraining(train_counter, full_probe):
    emb = _corpus(576, seed=1)
    ivf, ref = _store("ivf", dim=32), _store("tilemax", dim=32)
    for st in (ivf, ref):
        st.add(ids=_ids(512), embeddings=emb[:512])
    q = emb[:5]
    assert_same_results(ivf.query(q, n_results=10), ref.query(q, n_results=10))
    assert train_counter["n"] == 1
    for st in (ivf, ref):  # +12.5%: below the threshold, a repair
        st.add(ids=_ids(64, base=512), embeddings=emb[512:])
    assert_same_results(ivf.query(q, n_results=10), ref.query(q, n_results=10))
    assert ivf.query(emb[512:513], n_results=1)["ids"][0][0] == _ids(1, base=512)[0]
    assert train_counter["n"] == 1


def test_growth_past_threshold_retrains(train_counter, full_probe):
    emb = _corpus(1024, d=16, seed=2)
    ivf = _store("ivf", dim=16)
    ivf.add(ids=_ids(512), embeddings=emb[:512])
    ivf.query(emb[:1], n_results=5)
    assert train_counter["n"] == 1
    ivf.add(ids=_ids(512, base=512), embeddings=emb[512:])  # 2x: stale
    ivf.query(emb[:1], n_results=5)
    assert train_counter["n"] == 2


def test_update_reassigns_changed_vector(train_counter, full_probe):
    emb = _corpus(512, seed=3)
    ivf, ref = _store("ivf", dim=32), _store("tilemax", dim=32)
    for st in (ivf, ref):
        st.add(ids=_ids(512), embeddings=emb)
    ivf.query(emb[:1], n_results=5)
    new_vec = -emb[7]  # far from its old cluster
    for st in (ivf, ref):
        st.update(ids=[_ids(8)[7]], embeddings=[new_vec])
    q = np.stack([new_vec, emb[3]])
    assert_same_results(ivf.query(q, n_results=10), ref.query(q, n_results=10))
    assert ivf.query(new_vec[None], n_results=1)["ids"][0][0] == _ids(8)[7]
    assert train_counter["n"] == 1


def _clustered(n_centers, per, seed):
    rng = np.random.default_rng(seed)
    centers = norm_rows(rng.standard_normal((n_centers, 32)))
    return norm_rows(centers.repeat(per, axis=0) + 0.05 * rng.standard_normal((n_centers * per, 32))).astype(
        np.float32
    )


@pytest.mark.parametrize("engine", ["ivf", "ivf-sharded"])
def test_low_probe_self_match_after_repair(engine, train_counter, monkeypatch):
    """n_probe=1 finds each row through its OWN cluster: a misplaced
    member list (rows added into slots whose stale assignment the repair
    skipped) breaks it where full-probe exactness cannot see it."""
    monkeypatch.setenv("IMATCH_IVF_NPROBE", "1")
    if engine == "ivf":
        pts, first, trains = _clustered(16, 40, 4), 512, 1
    else:
        pts, first, trains = _clustered(12, 50, 5), 480, 8  # shards partly live
    ivf = _store(engine, dim=32)
    ivf.add(ids=_ids(first), embeddings=pts[:first])
    ivf.query(pts[:1], n_results=1)
    ivf.add(ids=_ids(len(pts) - first, base=first), embeddings=pts[first:])
    got = [r[0] for r in ivf.query(pts, n_results=1)["ids"]]  # every row
    assert got == _ids(len(pts))
    assert train_counter["n"] == trains  # still the repair path


def test_compaction_remaps_assignments(train_counter, full_probe):
    n = 2048
    emb = _corpus(n, d=16, seed=5)
    ivf, ref = _store("ivf", dim=16), _store("tilemax", dim=16)
    all_ids = _ids(n)
    for st in (ivf, ref):
        st.add(ids=all_ids, embeddings=emb)
    ivf.query(emb[:1], n_results=5)
    for st in (ivf, ref):  # more than half dead: compaction
        st.delete(all_ids[: n // 2 + 100])
    q = emb[n // 2 + 100 :][:5]
    assert_same_results(ivf.query(q, n_results=10), ref.query(q, n_results=10))
    assert train_counter["n"] == 1


@pytest.mark.parametrize("engine", ["ivf", "ivf-sharded"])
def test_sidecar_survives_restart(engine, tmp_path, train_counter, full_probe, monkeypatch):
    emb = _corpus(700, seed=6)
    path = str(tmp_path / "idx")
    st = _store(engine, dim=32, persist_dir=path)
    st.add(ids=_ids(600), embeddings=emb[:600])
    st.query(emb[:1], n_results=5)
    assert train_counter["n"] == (1 if engine == "ivf" else 8)
    st.save(path)
    st.add(ids=_ids(100, base=600), embeddings=emb[600:])  # journaled
    want = st.query(emb[:4], n_results=10)
    train_counter["n"] = 0
    loaded = _load(path, engine, monkeypatch)
    assert loaded.engine == engine
    assert loaded._ivf_host is not None and loaded._ivf_host["kind"] == engine
    assert loaded.query(emb[:4], n_results=10) == want
    assert train_counter["n"] == 0


def test_sharded_ivf_incremental_add(train_counter, full_probe):
    emb = _corpus(1000, seed=8)
    ivf, ref = _store("ivf-sharded", dim=32), _store("tilemax", dim=32)
    for st in (ivf, ref):
        st.add(ids=_ids(900), embeddings=emb[:900])
    q = emb[:5]
    assert_same_results(ivf.query(q, n_results=10), ref.query(q, n_results=10))
    assert train_counter["n"] == 8  # one k-means a shard
    for st in (ivf, ref):  # inside the 1024-slot capacity: a repair
        st.add(ids=_ids(100, base=900), embeddings=emb[900:])
    assert_same_results(ivf.query(q, n_results=10), ref.query(q, n_results=10))
    assert ivf.query(emb[950:951], n_results=1)["ids"][0][0] == _ids(1, base=950)[0]
    assert train_counter["n"] == 8


def test_sharded_ivf_capacity_growth_retrains(train_counter, full_probe):
    emb = _corpus(1300, d=16, seed=9)
    ivf, ref = _store("ivf-sharded", dim=16), _store("tilemax", dim=16)
    for st in (ivf, ref):
        st.add(ids=_ids(1000), embeddings=emb[:1000])
    ivf.query(emb[:1], n_results=5)
    assert train_counter["n"] == 8
    for st in (ivf, ref):  # capacity 1024 -> 2048 moves the shard boundaries
        st.add(ids=_ids(300, base=1000), embeddings=emb[1000:])
    assert_same_results(ivf.query(emb[:5], n_results=10), ref.query(emb[:5], n_results=10))
    assert train_counter["n"] == 16


def test_sharded_ivf_update_and_delete_repair(train_counter, full_probe):
    emb = _corpus(900, seed=10)
    ivf, ref = _store("ivf-sharded", dim=32), _store("tilemax", dim=32)
    for st in (ivf, ref):
        st.add(ids=_ids(900), embeddings=emb)
    ivf.query(emb[:1], n_results=5)
    new_vec = -emb[11]
    for st in (ivf, ref):
        st.update(ids=[_ids(12)[11]], embeddings=[new_vec])
        st.delete([_ids(3)[2]])  # small: no compaction
    q = np.stack([new_vec, emb[5]])
    assert_same_results(ivf.query(q, n_results=10), ref.query(q, n_results=10))
    assert train_counter["n"] == 8


def _sidecar(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return os.path.join(path, json.load(f)["ivf"])


@pytest.mark.parametrize("damage", ["not a zip", "out of range"])
def test_bad_sidecar_falls_back_to_full_build(damage, tmp_path, train_counter, full_probe, monkeypatch):
    """A sidecar that does not load, or loads with assignments out of
    range, is rejected at load: a full rebuild, served fine."""
    emb = _corpus(300, d=16, seed=7 if damage == "not a zip" else 14)
    path = str(tmp_path / "idx")
    st = _store("ivf", dim=16, persist_dir=path)
    st.add(ids=_ids(300), embeddings=emb)
    st.query(emb[:1], n_results=5)
    st.save(path)
    side = _sidecar(path)
    if damage == "not a zip":
        with open(side, "wb") as f:
            f.write(b"not a zipfile")
    else:
        with np.load(side) as z:
            payload = {k: z[k] for k in z.files}
        payload["assign"] = np.full_like(payload["assign"], 10_000_000)
        with open(side, "wb") as f:
            np.savez(f, **payload)
    train_counter["n"] = 0
    loaded = _load(path, "ivf", monkeypatch)
    assert loaded._ivf_host is None
    ref = _store("tilemax", dim=16)
    ref.add(ids=_ids(300), embeddings=emb)
    assert_same_results(loaded.query(emb[:3], n_results=10), ref.query(emb[:3], n_results=10))
    assert train_counter["n"] == 1


def test_sharded_sidecar_skipped_with_tombstones(tmp_path, train_counter, full_probe, monkeypatch):
    """Tombstones shift slot positions in the snapshot, which would break
    shard-local assignments: no sidecar, and the restart retrains."""
    emb = _corpus(400, d=16, seed=12)
    path = str(tmp_path / "idx")
    st = _store("ivf-sharded", dim=16, persist_dir=path)
    st.add(ids=_ids(400), embeddings=emb)
    st.query(emb[:1], n_results=5)
    st.delete([_ids(1)[0]])
    st.query(emb[:1], n_results=5)
    st.save(path)
    with open(os.path.join(path, "manifest.json")) as f:
        assert "ivf" not in json.load(f)
    train_counter["n"] = 0
    loaded = _load(path, "ivf-sharded", monkeypatch)
    ref = _store("tilemax", dim=16)
    ref.add(ids=_ids(400)[1:], embeddings=emb[1:])
    assert_same_results(loaded.query(emb[:3], n_results=10), ref.query(emb[:3], n_results=10))
    assert train_counter["n"] == 8


def test_stats_reports_ivf_state(train_counter, full_probe, monkeypatch):
    emb = _corpus(600, d=16, seed=13)
    st = _store("ivf", dim=16)
    st.add(ids=_ids(512), embeddings=emb[:512])
    st.query(emb[:1], n_results=5)
    s = st.stats()
    assert s["engine"] == "ivf" and s["live"] == 512
    assert s["ivf"]["kind"] == "ivf" and s["ivf"]["last_mode"] == "train"
    assert s["ivf"]["built_live"] == 512 and s["ivf"]["clusters"] >= 1
    assert s["last_build"]["seconds"] >= 0
    st.add(ids=_ids(88, base=512), embeddings=emb[512:])
    st.query(emb[:1], n_results=5)
    s = st.stats()
    assert s["patched_mutations"] == 1  # the append patched, no rebuild
    assert s["ivf"]["last_mode"] == "train"
    assert s["live"] == 600 and s["ivf"]["built_live"] == 512
    monkeypatch.setenv("IMATCH_INCREMENTAL", "0")  # the repair rebuild instead
    st.add(ids=_ids(30, base=600), embeddings=_corpus(30, d=16, seed=15))
    st.query(emb[:1], n_results=5)
    s = st.stats()
    assert s["ivf"]["last_mode"] == "repair"
    assert s["live"] == 630 and s["ivf"]["built_live"] == 512


def test_built_live_survives_restart_without_ratchet(tmp_path, train_counter, full_probe, monkeypatch):
    emb = _corpus(700, d=16, seed=15)
    path = str(tmp_path / "idx")
    st = _store("ivf", dim=16, persist_dir=path)
    st.add(ids=_ids(512), embeddings=emb[:512])
    st.query(emb[:1], n_results=5)  # train at 512
    st.add(ids=_ids(100, base=512), embeddings=emb[512:612])
    st.query(emb[:1], n_results=5)  # patched at 612
    assert train_counter["n"] == 1
    st.save(path)
    train_counter["n"] = 0
    loaded = _load(path, "ivf", monkeypatch)
    assert loaded._ivf_host["built_live"] == 512  # not the snapshot's 612
    loaded.add(ids=_ids(76, base=612), embeddings=emb[612:688])  # 688 > 512 * 1.3
    loaded.query(emb[:1], n_results=5)
    assert train_counter["n"] == 1


# -- the sidecar across packages ------------------------------------------------


def _write(pkg, engine, path, emb):
    if pkg == "jax":
        st = JaxStore(dim=emb.shape[1], engine=engine, persist_dir=path)
    else:
        st = _store(engine, dim=emb.shape[1], persist_dir=path)
    st.add(ids=_ids(len(emb)), embeddings=emb)
    st.query(emb[:1], n_results=5)  # trains
    st.save(path)


def _open(pkg, engine, path, monkeypatch):
    if pkg == "jax":
        monkeypatch.setenv("IMATCH_INDEX_ENGINE", engine)
        return JaxStore.load(path)
    return _load(path, engine, monkeypatch)


@pytest.mark.parametrize("engine", ["ivf", "ivf-sharded"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sidecar_loads_across_packages(engine, writer, tmp_path, monkeypatch):
    """One package's snapshot with its sidecar loads in both without a
    k-means run; both answer with the same ids at every n_probe."""
    emb = _clustered(24, 25, 16)
    path = str(tmp_path / "idx")
    _write(writer, engine, path, emb)
    counts = {"jax": _counter(monkeypatch, jax_ivf_mod), "torch": _counter(monkeypatch, ivf_mod)}
    stores = {pkg: _open(pkg, engine, path, monkeypatch) for pkg in ("jax", "torch")}
    q = np.concatenate([emb[[0, 300, 599]], _corpus(2, seed=17)])
    for n_probe in ("1", "4", "1000000"):
        monkeypatch.setenv("IMATCH_IVF_NPROBE", n_probe)
        ra, rb = (stores[pkg].query(q, n_results=10) for pkg in ("jax", "torch"))
        assert ra["ids"] == rb["ids"], n_probe
        for da, db in zip(ra["distances"], rb["distances"]):
            np.testing.assert_allclose(db, da, rtol=0, atol=1e-6)
    assert counts["jax"]["n"] == counts["torch"]["n"] == 0
    for pkg in ("jax", "torch"):
        assert stores[pkg].stats()["ivf"]["last_mode"] == "repair"


@pytest.mark.parametrize("engine", ["ivf", "ivf-sharded"])
def test_sidecar_keys_match_across_packages(engine, tmp_path):
    emb = _corpus(300, seed=18)
    keys = {}
    for pkg in ("jax", "torch"):
        path = str(tmp_path / pkg)
        _write(pkg, engine, path, emb)
        with np.load(_sidecar(path)) as z:
            keys[pkg] = {k: (z[k].dtype, z[k].shape) for k in z.files}
    assert keys["jax"] == keys["torch"]
