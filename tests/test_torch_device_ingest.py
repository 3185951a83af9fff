"""Device-resident ingest on the port, on CPU tensors: ports of
tests/test_device_ingest.py:69-262 and tests/test_pipeline.py:393.

``store.add`` with a tensor scatters the rows into the prepared state
(index/patch.py) and defers the host mirror and the journal to the next
drain point. The oracle on every engine and score dtype the port has is
the same operation sequence with numpy rows: identical answers. The drain
tests pin the deferred consistency: every reader of the host mirror sees
the drained rows, the journal holds the ops in call order, and a failed
drain drops nothing. A journal written by device adds and a flush loads in
the JAX package with the same ids and answers, and ``process_batch`` with
IMATCH_DEVICE_INGEST=1 equals the host path.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from imatch_tpu.index.store import VectorStore as JaxStore
from imatch_tpu.models.clip.configs import TINY as JAX_TINY
from imatch_tpu.models.clip.model import init_params
from imatch_tpu_torch.index.store import VectorStore
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.pipeline.captioner import NullCaptioner
from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
from imatch_tpu_torch.pipeline.ingest import process_batch
from imatch_tpu_torch.pipeline.search import search_by_text
from imatch_tpu_torch.pipeline.state import AppState

D = 32


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for key in ("IMATCH_COALESCE", "IMATCH_INCREMENTAL", "IMATCH_SCORE_DTYPE", "IMATCH_PENDING_MAX"):
        monkeypatch.delenv(key, raising=False)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(n, D)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _ids(pre, n, base=0):
    return [f"{pre}{i}" for i in range(base, base + n)]


def _store(**kw):
    return VectorStore(dim=D, device="cpu", **kw)


def _assert_same(r1, r2, atol=1e-5):
    assert r1["ids"] == r2["ids"]
    np.testing.assert_allclose(sum(r1["distances"], []), sum(r2["distances"], []), atol=atol)


ENGINES = [
    ("tilemax", "bf16"),
    ("tilemax", "fp32"),
    ("tilemax", "int8"),
    ("pallas", "bf16"),
    ("tilemax-host", "bf16"),
]


@pytest.mark.parametrize("engine,dtype", ENGINES)
def test_device_add_matches_host_add(engine, dtype, monkeypatch):
    monkeypatch.setenv("IMATCH_SCORE_DTYPE", dtype)
    q = _rows(5, 99)

    def run(as_tensor):
        conv = torch.from_numpy if as_tensor else (lambda a: a)
        s = _store(engine=engine)
        s.add(_ids("a", 200), conv(_rows(200, 0)))
        s.query(q, n_results=10)  # the device build
        s.add(_ids("b", 50), conv(_rows(50, 1)))  # a patched append
        return s, s.query(q, n_results=25)

    s_dev, r_dev = run(True)
    s_host, r_host = run(False)
    _assert_same(r_dev, r_host, atol=0)
    assert s_dev.count() == s_host.count() == 250
    assert s_dev.stats()["patched_mutations"] == s_host.stats()["patched_mutations"] == 1
    # the patched state equals the host path's, tensor for tensor
    dev_state, host_state = s_dev._device_corpus[1], s_host._device_corpus[1]
    for name in ("scoring", "valid", "scale"):
        a, b = getattr(dev_state, name), getattr(host_state, name)
        assert (a is None and b is None) or torch.equal(a, b), name


def test_device_add_before_any_build():
    s = _store()
    s.add(_ids("a", 64), torch.from_numpy(_rows(64, 0)))
    assert s.stats()["pending_host_syncs"] == 1
    q = _rows(2, 9)
    f = _store()
    f.add(_ids("a", 64), _rows(64, 0))
    _assert_same(s.query(q, n_results=10), f.query(q, n_results=10))
    assert s.stats()["pending_host_syncs"] == 0


def test_capacity_growth_with_pending_rows():
    s = _store()
    s.add(_ids("a", 1000), _rows(1000, 0))
    s.query(_rows(1, 9), n_results=3)
    s.add(_ids("b", 200), torch.from_numpy(_rows(200, 1)))  # 1200 > capacity 1024
    assert s.stats()["patched_mutations"] == 0
    q = _rows(3, 99)
    f = _store()
    f.add(_ids("a", 1000), _rows(1000, 0))
    f.add(_ids("b", 200), _rows(200, 1))
    _assert_same(s.query(q, n_results=10), f.query(q, n_results=10))


def test_get_embeddings_drains():
    s = _store()
    rows = _rows(16, 0)
    s.add(_ids("a", 16), torch.from_numpy(rows))
    g = s.get(include=("embeddings",))
    got = dict(zip(g["ids"], g["embeddings"]))
    np.testing.assert_array_equal(got["a3"], rows[3])
    assert s.stats()["pending_host_syncs"] == 0


def test_source_tensor_written_after_add_changes_nothing():
    s = _store()
    rows = torch.from_numpy(_rows(4, 0).copy())
    s.add(_ids("a", 4), rows)
    want = rows.clone()
    rows.zero_()  # the caller reuses its buffer
    np.testing.assert_array_equal(s.get(include=("embeddings",))["embeddings"], want.numpy())


def test_update_of_pending_slot_not_clobbered():
    s = _store()
    s.add(_ids("a", 8), torch.from_numpy(_rows(8, 0)))
    new = _rows(1, 7)
    s.update(["a2"], embeddings=new)
    np.testing.assert_array_equal(s.get(ids=["a2"], include=("embeddings",))["embeddings"][0], new[0])


def _journal_ops(path):
    with open(os.path.join(path, "journal.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def test_journal_order_preserved(tmp_path):
    p = str(tmp_path / "s")
    s = _store(persist_dir=p)
    s.add(_ids("a", 8), torch.from_numpy(_rows(8, 0)))
    s.add(_ids("b", 4), torch.from_numpy(_rows(4, 1)))
    assert s.stats()["pending_host_syncs"] == 2
    s.delete(["a1"])  # a journaled op drains the two pending adds first
    kinds = [(o["op"], o["id"]) for o in _journal_ops(p)]
    assert kinds[:8] == [("add", f"a{i}") for i in range(8)]
    assert kinds[8:12] == [("add", f"b{i}") for i in range(4)]
    assert kinds[12] == ("delete", "a1")
    r = VectorStore.load(p, device="cpu")
    assert r.count() == 11
    q = _rows(2, 9)
    _assert_same(s.query(q, n_results=5), r.query(q, n_results=5))


def test_host_add_after_device_add_drains_first(tmp_path):
    p = str(tmp_path / "s")
    s = _store(persist_dir=p)
    s.add(_ids("a", 3), torch.from_numpy(_rows(3, 0)))
    s.add(_ids("h", 2), _rows(2, 1))
    assert [o["id"] for o in _journal_ops(p)] == ["a0", "a1", "a2", "h0", "h1"]


def test_flush_writes_journal(tmp_path):
    p = str(tmp_path / "s")
    s = _store(persist_dir=p)
    s.add(_ids("a", 8), torch.from_numpy(_rows(8, 0)))
    assert not os.path.exists(os.path.join(p, "journal.jsonl"))
    s.flush()
    assert len(_journal_ops(p)) == 8
    assert s.stats()["pending_host_syncs"] == 0


@pytest.mark.parametrize("via", ["save", "checkpoint"])
def test_save_drains_and_restores(tmp_path, via):
    p = str(tmp_path / "s")
    s = _store(persist_dir=p)
    s.add(_ids("a", 32), torch.from_numpy(_rows(32, 0)))
    if via == "save":
        s.save(p)
    else:
        s.checkpoint(force=True)
    assert s.stats()["pending_host_syncs"] == 0
    r = VectorStore.load(p, device="cpu")
    assert r.count() == 32
    q = _rows(2, 9)
    _assert_same(s.query(q, n_results=5), r.query(q, n_results=5))


def test_pending_cap_bounds_backlog(monkeypatch):
    monkeypatch.setenv("IMATCH_PENDING_MAX", "3")
    s = _store()
    for i in range(7):
        s.add(_ids(f"g{i}_", 4), torch.from_numpy(_rows(4, i)))
    assert s.stats()["pending_host_syncs"] < 3
    assert s.count() == 28


class _FlakyRows:
    """Raises on the first copy to the host, then behaves."""

    def __init__(self, rows, fails=1):
        self.rows = rows
        self.fails = fails

    def __array__(self, dtype=None, copy=None):
        if self.fails:
            self.fails -= 1
            raise RuntimeError("simulated d2h failure")
        return np.asarray(self.rows, dtype or np.float32)


def test_drain_failure_keeps_batches_pending(tmp_path):
    p = str(tmp_path / "s")
    s = _store(persist_dir=p)
    r0, r1 = _rows(8, 0), _rows(4, 1)
    s.add(_ids("a", 8), torch.from_numpy(r0))
    s.add(_ids("b", 4), torch.from_numpy(r1))
    assert s.stats()["pending_host_syncs"] == 2
    base, k, rows, ids, mds, docs = s._pending[0]
    s._pending[0] = (base, k, _FlakyRows(rows), ids, mds, docs)
    with pytest.raises(RuntimeError, match="simulated"):
        s.flush()
    assert s.stats()["pending_host_syncs"] == 2  # nothing dropped
    s.flush()
    assert s.stats()["pending_host_syncs"] == 0
    assert len(_journal_ops(p)) == 12
    got = dict(zip(*(lambda g: (g["ids"], g["embeddings"]))(s.get(include=("embeddings",)))))
    np.testing.assert_array_equal(got["b2"], r1[2])


def test_device_add_validation():
    s = _store()
    s.add(_ids("a", 4), torch.from_numpy(_rows(4, 0)))
    with pytest.raises(ValueError, match="duplicate"):
        s.add(["a1"], torch.from_numpy(_rows(1, 1)))
    with pytest.raises(ValueError, match="dim"):
        s.add(["z0"], torch.zeros((1, D + 1)))
    with pytest.raises(ValueError):
        s.add(["z1", "z2"], torch.from_numpy(_rows(1, 1)))  # count mismatch
    assert s.count() == 4 and s.stats()["pending_host_syncs"] == 1


def test_device_add_then_flush_loads_in_jax(tmp_path):
    """The journal and snapshot a device add leaves are the JAX store's
    format: JAX loads them with the same ids and the same answers."""
    p = str(tmp_path / "s")
    s = _store(persist_dir=p)
    s.add(_ids("a", 40), _rows(40, 0))
    s.save(p)
    s.query(_rows(1, 5), n_results=3)  # a built state, so the next add patches
    s.add(_ids("b", 24), torch.from_numpy(_rows(24, 1)), metadatas=[{"n": i} for i in range(24)])
    s.flush()
    s.delete(["a3"])
    assert [o["op"] for o in _journal_ops(p)] == ["add"] * 24 + ["delete"]
    j = JaxStore.load(p)
    assert sorted(j.get(include=[])["ids"]) == sorted(s.get(include=[])["ids"])
    assert j.get(ids=["b7"])["metadatas"] == [{"n": 7}]
    q = _rows(4, 9)
    _assert_same(s.query(q, n_results=12), j.query(q, n_results=12))


@pytest.fixture(scope="module")
def embedder():
    tree = jax.tree.map(np.asarray, init_params(jax.random.key(0), JAX_TINY))
    return ClipEmbedder(config=TINY, params=tree, device="cpu")


@pytest.mark.parametrize("odd_tail", [False, True], ids=["fused-only", "mixed"])
def test_process_batch_device_ingest_matches_host(tmp_path, embedder, monkeypatch, odd_tail):
    """IMATCH_DEVICE_INGEST=1: ids, store and search answers equal the host
    path's; a mixed batch (an odd-geometry tail) materialises cleanly, and
    the flush before the response leaves nothing pending."""
    rng = np.random.default_rng(7)
    images = [Image.fromarray(rng.integers(0, 256, (64, 48, 3), np.uint8)) for _ in range(10)]
    if odd_tail:
        images.append(Image.fromarray(rng.integers(0, 256, (40, 32, 3), np.uint8)))
    names = [f"f{i}.png" for i in range(len(images))]

    def run(dev):
        monkeypatch.setenv("IMATCH_DEVICE_INGEST", "1" if dev else "0")
        st = AppState(
            root=str(tmp_path / ("dev" if dev else "host")),
            embedder=embedder,
            captioner=NullCaptioner(),
            device="cpu",
        )
        res = process_batch(st, images, names)
        assert all(r["status"] == "success" for r in res)
        return st, res, search_by_text(st, "anything", limit=len(images))

    st_d, res_d, hits_d = run(True)
    st_h, res_h, hits_h = run(False)
    assert [r["id"] for r in res_d] == [r["id"] for r in res_h]
    assert st_d.store.count() == st_h.store.count() == len(images)
    assert [h["id"] for h in hits_d] == [h["id"] for h in hits_h]
    np.testing.assert_allclose(
        [h["similarity_score"] for h in hits_d], [h["similarity_score"] for h in hits_h], atol=1e-5
    )
    assert st_d.store.stats()["pending_host_syncs"] == 0
    assert st_d.store.stats()["journal_ops"] == len(images)
    np.testing.assert_array_equal(
        st_d.store.get(include=["embeddings"])["embeddings"],
        st_h.store.get(include=["embeddings"])["embeddings"],
    )
    reloaded = VectorStore.load(st_d.store.persist_dir, device="cpu")
    assert reloaded.count() == len(images)


def test_process_batch_device_ingest_flush_off_defers(tmp_path, embedder, monkeypatch):
    monkeypatch.setenv("IMATCH_DEVICE_INGEST", "1")
    monkeypatch.setenv("IMATCH_DEVICE_INGEST_FLUSH", "0")
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (32, 32, 3), np.uint8) for _ in range(8)]
    st = AppState(root=str(tmp_path), embedder=embedder, captioner=NullCaptioner(), device="cpu")
    res = process_batch(st, images, [f"g{i}.png" for i in range(8)])
    assert all(r["status"] == "success" for r in res)
    assert st.store.stats()["pending_host_syncs"] == 1
    assert st.store.stats()["journal_ops"] == 0
    st.snapshot(force=True)  # the launcher's SIGTERM path drains first
    assert VectorStore.load(st.data_dir, device="cpu").count() == 8
