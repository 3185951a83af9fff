"""``cosine_topk`` on the port (plain PyTorch; XLA in JAX, no Pallas
kernel): ports of tests/test_index.py:19-50 against a float64 numpy
brute force and JAX's ``cosine_topk`` on the same inputs (ids equal,
scores within 1e-5), and tests/test_store_property.py with the port's
``cosine_topk`` as the oracle of random add/update/delete/query
interleavings on the port's store.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import imatch_tpu_torch.index.store as store_mod
from imatch_tpu.index.search import cosine_topk as jax_cosine_topk
from imatch_tpu_torch.index.search import cosine_topk
from imatch_tpu_torch.index.store import VectorStore


def _norm_rows(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize(
    "n,q,k,chunk", [(1000, 4, 10, 256), (100, 1, 200, 64), (5000, 8, 50, 4096), (3, 2, 10, 256)]
)
def test_cosine_topk_matches_numpy_and_jax(n, q, k, chunk):
    rng = np.random.default_rng(0)
    corpus = _norm_rows(rng.standard_normal((n, 64)).astype(np.float32))
    queries = _norm_rows(rng.standard_normal((q, 64)).astype(np.float32))
    valid = np.ones(n, dtype=bool)
    scores, idx = cosine_topk(
        torch.from_numpy(queries), torch.from_numpy(corpus), torch.from_numpy(valid), k=k, chunk=chunk
    )
    scores, idx = scores.numpy(), idx.numpy()
    assert scores.shape == idx.shape == (q, k)
    ref = queries.astype(np.float64) @ corpus.astype(np.float64).T
    kk = min(k, n)
    for i in range(q):
        order = np.argsort(-ref[i], kind="stable")[:kk]
        assert idx[i, :kk].tolist() == order.tolist()
        np.testing.assert_allclose(scores[i, :kk], ref[i][order], atol=1e-5)
        assert (idx[i, kk:] == -1).all()
    js, ji = jax_cosine_topk(
        jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(valid), k=k, chunk=chunk
    )
    assert idx.tolist() == np.asarray(ji).tolist()
    np.testing.assert_allclose(scores[:, :kk], np.asarray(js)[:, :kk], rtol=0, atol=1e-5)


def test_cosine_topk_respects_mask():
    rng = np.random.default_rng(1)
    corpus = _norm_rows(rng.standard_normal((50, 16)).astype(np.float32))
    valid = np.ones(50, dtype=bool)
    valid[0] = False  # query 0's exact match is masked out
    _, idx = cosine_topk(
        torch.from_numpy(corpus[:2]), torch.from_numpy(corpus), torch.from_numpy(valid), k=5
    )
    assert 0 not in idx[0].tolist()
    assert int(idx[1, 0]) == 1


def test_cosine_topk_ties_to_the_lower_index():
    corpus = np.zeros((6, 8), np.float32)
    corpus[:, 0] = 1.0  # six identical rows
    _, idx = cosine_topk(
        torch.from_numpy(corpus[:1]), torch.from_numpy(corpus), torch.ones(6, dtype=torch.bool), k=4
    )
    assert idx.tolist() == [[0, 1, 2, 3]]


D = 8


def _vec(seed):
    v = np.random.default_rng(seed).standard_normal(D).astype(np.float32)
    return v / np.linalg.norm(v)


ops_strategy = st.lists(
    st.one_of(
        st.tuples(st.just("add"), st.integers(0, 39), st.integers(0, 10_000)),
        st.tuples(st.just("update"), st.integers(0, 39), st.integers(0, 10_000)),
        st.tuples(st.just("delete"), st.integers(0, 39), st.just(0)),
        st.tuples(st.just("query"), st.integers(0, 10_000), st.integers(1, 12)),
    ),
    min_size=5,
    max_size=40,
)


def _oracle(store, q, k):
    """``cosine_topk`` over the store's live rows, in slot order (the
    store's tie order)."""
    got = store.get(include=["embeddings"])
    if not got["ids"]:
        return [], []
    s, i = cosine_topk(
        torch.from_numpy(q[None]),
        torch.from_numpy(np.asarray(got["embeddings"], np.float32)),
        torch.ones(len(got["ids"]), dtype=torch.bool),
        k=k,
        score_dtype=torch.float32,
    )
    kk = min(k, len(got["ids"]))
    return [got["ids"][j] for j in i[0, :kk].tolist()], (1.0 - s[0, :kk].double()).tolist()


@pytest.mark.parametrize("engine", ["tilemax", "tilemax-host"])
@settings(max_examples=15, deadline=None, suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(ops=ops_strategy)
def test_store_matches_cosine_topk_oracle(engine, ops, monkeypatch):
    # a small capacity floor makes compaction and growth reachable
    monkeypatch.setattr(store_mod, "_MIN_CAP", 8)
    store = VectorStore(dim=D, engine=engine, device="cpu")
    live = set()
    for op, a, b in ops:
        vid = f"id{a}"
        if op == "add":
            if vid in live:
                with pytest.raises(ValueError):
                    store.add(ids=[vid], embeddings=[_vec(b)])
            else:
                store.add(ids=[vid], embeddings=[_vec(b)])
                live.add(vid)
        elif op == "update":
            if vid in live:
                store.update(ids=[vid], embeddings=[_vec(b + 50_000)])
            else:
                with pytest.raises(KeyError):
                    store.update(ids=[vid], embeddings=[_vec(b + 50_000)])
        elif op == "delete":
            store.delete([vid])
            live.discard(vid)
        else:
            q = _vec(a + 100_000)
            want_ids, want_d = _oracle(store, q, b)
            res = store.query([q], n_results=b)
            assert res["ids"][0] == want_ids
            np.testing.assert_allclose(res["distances"][0], want_d, atol=1e-5)
    assert store.count() == len(live)
