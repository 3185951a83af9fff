"""The PyTorch port's VectorStore against the JAX package's.

The same random sequence of add, update and delete goes to both stores
(the port on the CPU); then queries must give identical ids and
distances within 1e-5. ``include=`` and the validation errors match.
"""

import numpy as np
import pytest
import torch

from imatch_tpu.index.store import VectorStore as JaxStore
from imatch_tpu_torch.index.store import VectorStore

DIM = 24


def _unit(rng, n):
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _both(**kw):
    return JaxStore(engine="tilemax", **kw), VectorStore(engine="tilemax", device="cpu", **kw)


def _assert_same_query(a, b, q, n_results, include=("metadatas", "distances", "documents")):
    ra = a.query(q, n_results=n_results, include=list(include))
    rb = b.query(q, n_results=n_results, include=list(include))
    assert set(ra) == set(rb)
    assert ra["ids"] == rb["ids"]
    for key in ("metadatas", "documents"):
        if key in include:
            assert ra[key] == rb[key]
    if "distances" in include:
        for da, db in zip(ra["distances"], rb["distances"]):
            np.testing.assert_allclose(db, da, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_mutations_then_queries_match(seed):
    rng = np.random.default_rng(seed)
    a, b = _both()
    live, next_id = [], 0
    for step in range(40):
        op = rng.choice(["add", "add", "update", "delete"]) if live else "add"
        if op == "add":
            n = int(rng.integers(1, 60))
            ids = [f"img_{next_id + i}" for i in range(n)]
            next_id += n
            emb = _unit(rng, n)
            if rng.random() < 0.2:  # duplicate rows: ties go to the lower slot
                emb[-1] = emb[0]
            mds = [{"i": i, "step": step} for i in ids]
            docs = [f"doc {i}" for i in ids]
            for s in (a, b):
                s.add(ids=ids, embeddings=emb, metadatas=mds, documents=docs)
            live += ids
        elif op == "update":
            ids = list(rng.choice(live, size=min(len(live), 5), replace=False))
            emb = _unit(rng, len(ids))
            mds = [{"updated": step} for _ in ids]
            for s in (a, b):
                s.update(ids=ids, embeddings=emb, metadatas=mds)
        else:
            ids = list(rng.choice(live, size=min(len(live), int(rng.integers(1, 30))), replace=False))
            for s in (a, b):
                s.delete(ids + ["img_never"])
            live = [i for i in live if i not in set(ids)]
        assert a.count() == b.count() == len(live)
        if step % 8 == 7:
            _assert_same_query(a, b, _unit(rng, 3), n_results=10)
    q = np.concatenate([_unit(rng, 4), a.get(ids=live[:2], include=["embeddings"])["embeddings"]])
    for n_results in (1, 10, 1000):
        _assert_same_query(a, b, q, n_results=n_results)
    assert a.get()["ids"] == b.get()["ids"]


def test_compaction_keeps_results_equal():
    rng = np.random.default_rng(5)
    a, b = _both()
    ids = [f"x{i}" for i in range(1500)]
    emb = _unit(rng, 1500)
    for s in (a, b):
        s.add(ids=ids, embeddings=emb)
        s.delete(ids[:900])  # more than half dead: compaction
    assert b.stats()["slots"] == a.count() == b.count() == 600
    _assert_same_query(a, b, _unit(rng, 3), n_results=25)


@pytest.mark.parametrize(
    "include", [("metadatas",), ("documents", "distances"), (), ("metadatas", "documents", "distances")]
)
def test_include_matches(include):
    rng = np.random.default_rng(3)
    a, b = _both()
    emb = _unit(rng, 5)
    for s in (a, b):
        s.add(ids=list("abcde"), embeddings=emb, metadatas=[{"k": 1}] * 5, documents=list("vwxyz"))
    _assert_same_query(a, b, emb[:2], n_results=3, include=include)
    ga = a.get(ids=["c", "a", "zz"], include=list(include) + ["embeddings"])
    gb = b.get(ids=["c", "a", "zz"], include=list(include) + ["embeddings"])
    assert ga.keys() == gb.keys() and ga["ids"] == gb["ids"] == ["c", "a"]
    np.testing.assert_array_equal(ga["embeddings"], gb["embeddings"])
    empty_a, empty_b = _both()
    assert empty_a.query(emb[:2], include=list(include)) == empty_b.query(emb[:2], include=list(include))


def _errors(store_fn):
    """The exception type of each bad call against a fresh 2-row store."""
    out = []
    calls = [
        lambda s: s.add(ids=[], embeddings=np.zeros((0, DIM))),
        lambda s: s.add(ids=["a"], embeddings=np.zeros((1, DIM))),  # duplicate id
        lambda s: s.add(ids=["n1", "n1"], embeddings=np.zeros((2, DIM))),
        lambda s: s.add(ids=["n2", "n3"], embeddings=np.zeros((1, DIM))),
        lambda s: s.add(ids=["n4"], embeddings=np.zeros((1, 1))),
        lambda s: s.add(ids=["n5"], embeddings=np.zeros((1, DIM)), metadatas=[{}, {}]),
        lambda s: s.update(ids=["nope"], metadatas=[{}]),
        lambda s: s.update(ids=["a", "b"], metadatas=[{}]),
        lambda s: s.update(ids=["a"], embeddings=np.zeros((1, DIM + 1))),
    ]
    for call in calls:
        s = store_fn()
        s.add(ids=["a", "b"], embeddings=np.ones((2, DIM), np.float32))
        try:
            call(s)
            out.append(None)
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            out.append(type(e))
        assert s.count() == 2  # nothing half-applied
    return out


def test_validation_errors_match():
    ours = _errors(lambda: VectorStore(device="cpu"))
    theirs = _errors(lambda: JaxStore())
    assert ours == theirs
    assert None not in ours


def test_engines_and_dtypes_not_ported_raise(monkeypatch):
    # every engine JAX accepts is ported; unknown names raise as in JAX
    for engine in ("sharded", "ivf", "ivf-sharded"):
        assert VectorStore(engine=engine, device="cpu").engine == engine
        JaxStore(engine=engine)
    with pytest.raises(ValueError):
        VectorStore(engine="hnsw", device="cpu")
    with pytest.raises(ValueError):
        VectorStore(score_dtype="int4", device="cpu")
    # ported: the int8 score dtype and the tilemax-host tier
    assert VectorStore(score_dtype="int8", device="cpu").score_dtype == torch.int8
    assert VectorStore(engine="tilemax-host", device="cpu").tile_n == 512
    monkeypatch.setenv("IMATCH_INDEX_ENGINE", "auto")
    monkeypatch.setenv("IMATCH_SCORE_DTYPE", "fp32")
    s = VectorStore(device="cpu")
    assert (s.engine, s.tile_n, s.score_dtype) == ("tilemax", 512, torch.float32)
    assert VectorStore(engine="pallas", device="cpu").tile_n == 2048


def test_pallas_engine_matches_jax_pallas_engine():
    rng = np.random.default_rng(9)
    a = JaxStore(engine="pallas")
    b = VectorStore(engine="pallas", device="cpu")
    emb = _unit(rng, 300)
    for s in (a, b):
        s.add(ids=[f"p{i}" for i in range(300)], embeddings=emb)
        s.delete([f"p{i}" for i in range(0, 300, 7)])
    _assert_same_query(a, b, emb[:4], n_results=12)
