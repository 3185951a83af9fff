"""The PyTorch port's IVF tier (imatch_tpu_torch/index/ivf.py) against the
JAX package's.

The cases of tests/test_ivf.py on the port (recall on clustered data,
exactness at full probe, sampled training and bf16 storage, padding, the
capacity-padded store buffer, the store's ivf engine, training on a
deletion-heavy buffer), then parity on the same numpy inputs. Torch
cannot reproduce JAX's random draws, so parity is held where the inputs
are the same: with JAX's trained centroids fed to both packages the
assignments, member lists, counts, prune map and slack are bit-identical,
and the probe's ids identical with scores within 1e-6; and the port's
Lloyd loop started from JAX's own initial centroids (drawn here from the
key split of imatch_tpu/index/ivf.py's ``train_centroids``) ends within
1e-5 of JAX's centroids on separated clusters (fp32 sums in another
order; a flip at a cluster boundary would break it, and the clusters
keep a margin).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imatch_tpu.index.ivf as jivf
from imatch_tpu.index.store import VectorStore as JaxStore
from imatch_tpu_torch.index.ivf import (
    assign_rows,
    build_ivf,
    ivf_topk,
    lloyd,
    member_slack,
    pack_ivf_stats,
    train_centroids,
)
from imatch_tpu_torch.index.store import VectorStore


def norm_rows(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def clustered_corpus(n_clusters=64, per=50, d=32, seed=0):
    rng = np.random.default_rng(seed)
    centers = norm_rows(rng.standard_normal((n_clusters, d)))
    pts = centers.repeat(per, axis=0) + 0.15 * rng.standard_normal((n_clusters * per, d))
    return norm_rows(pts).astype(np.float32)


def _recall(i, q_ids, corpus):
    ref = corpus @ corpus.T
    out = []
    for row, qi in enumerate(q_ids):
        true = set(np.argsort(-ref[qi], kind="stable")[:10].tolist())
        out.append(len(true & set(x for x in i[row].tolist() if x >= 0)) / 10)
    return float(np.mean(out))


def test_ivf_recall_on_clustered_data():
    corpus = clustered_corpus()
    n = len(corpus)
    idx = build_ivf(corpus, np.ones(n, bool), n_clusters=64, seed=1)
    q_ids = np.random.default_rng(2).integers(0, n, 20)
    _, i = ivf_topk(torch.from_numpy(corpus[q_ids]), idx, k=10, n_probe=8)
    i = i.numpy()
    assert _recall(i, q_ids, corpus) >= 0.95
    assert (i[:, 0] == q_ids).all()  # its own cluster is probed first


def test_ivf_full_probe_is_exact():
    rng = np.random.default_rng(3)
    corpus = norm_rows(rng.standard_normal((500, 16)).astype(np.float32))
    valid = np.ones(500, bool)
    valid[77] = False
    idx = build_ivf(corpus, valid, n_clusters=16, seed=0)
    s, i = ivf_topk(torch.from_numpy(corpus[:6]), idx, k=12, n_probe=16)
    ref = corpus.astype(np.float64) @ corpus.astype(np.float64).T
    ref[:, 77] = -np.inf
    for qi in range(6):
        order = np.argsort(-ref[qi], kind="stable")[:12]
        assert i[qi].tolist() == order.tolist()
        np.testing.assert_allclose(s[qi].numpy(), ref[qi][order], atol=1e-5)
    assert 77 not in i


def test_ivf_sampled_training_and_bf16_storage():
    corpus = clustered_corpus(n_clusters=32, per=40, d=32, seed=5)
    n = len(corpus)
    idx = build_ivf(
        torch.from_numpy(corpus).to(torch.bfloat16),
        np.ones(n, bool),
        n_clusters=32,
        seed=1,
        sample=256,  # < n: the sampled-training path
        chunk=128,
    )
    assert idx.corpus.dtype == torch.bfloat16
    m = idx.members.numpy()
    flat = m[m >= 0]
    assert len(flat) == n and len(set(flat.tolist())) == n  # every row once
    q_ids = np.random.default_rng(6).integers(0, n, 16)
    _, i = ivf_topk(torch.from_numpy(corpus[q_ids]), idx, k=10, n_probe=8)
    i = i.numpy()
    assert _recall(i, q_ids, corpus) >= 0.9
    assert (i[:, 0] == q_ids).all()


def test_ivf_small_corpus_padding():
    corpus = norm_rows(np.random.default_rng(4).standard_normal((5, 8)).astype(np.float32))
    idx = build_ivf(corpus, np.ones(5, bool), n_clusters=2)
    _, i = ivf_topk(torch.from_numpy(corpus[:1]), idx, k=10, n_probe=2)
    i = i.numpy()[0]
    assert i[0] == 0
    assert (i[5:] == -1).all()


def test_ivf_capacity_padded_store_corpus():
    rng = np.random.default_rng(11)
    live = norm_rows(rng.standard_normal((6, 16)).astype(np.float32))
    emb = np.zeros((1024, 16), np.float32)
    emb[:6] = live
    alive = np.zeros(1024, bool)
    alive[:6] = True
    idx = build_ivf(emb, alive)
    assert idx.members.shape[0] <= 6  # sized by live rows, empty ones pruned
    assert (idx.members.numpy() >= 0).any(axis=1).all()
    q = norm_rows(rng.standard_normal((1, 16)).astype(np.float32))
    _, i = ivf_topk(torch.from_numpy(q), idx, k=6, n_probe=8)
    assert set(i.numpy()[0].tolist()) - {-1} == set(range(6))
    assert i.numpy()[0].tolist() == np.argsort(-(q @ live.T)[0], kind="stable").tolist()


def test_ivf_engine_through_store():
    rng = np.random.default_rng(12)
    e = norm_rows(rng.standard_normal((6, 8)).astype(np.float32))
    ids = [f"i{j}" for j in range(6)]
    exact = VectorStore(dim=8, engine="tilemax", device="cpu")
    approx = VectorStore(dim=8, engine="ivf", device="cpu")
    for st in (exact, approx):
        st.add(ids=ids, embeddings=e)
    q = norm_rows(rng.standard_normal((2, 8)).astype(np.float32))
    r_e = exact.query(query_embeddings=q, n_results=4)
    r_a = approx.query(query_embeddings=q, n_results=4)
    assert r_a["ids"] == r_e["ids"]
    np.testing.assert_allclose(r_a["distances"], r_e["distances"], atol=1e-5)


def test_train_centroids_on_deletion_heavy_capacity_buffer():
    rng = np.random.default_rng(5)
    n, d, live_n = 4096, 32, 128
    corpus = np.zeros((n, d), np.float32)
    valid = np.zeros((n,), bool)
    centers = rng.standard_normal((4, d)).astype(np.float32) * 3
    slots = rng.choice(n, live_n, replace=False)
    for j, s in enumerate(slots):
        corpus[s] = centers[j % 4] + rng.standard_normal(d) * 0.05
        valid[s] = True
    cents = train_centroids(corpus, valid, n_clusters=4, sample=256).numpy()
    assert np.linalg.norm(cents, axis=1).min() > 0.5  # trained on live rows
    assert len(set(assign_rows(corpus[slots], cents).tolist())) >= 3


# -- parity with the JAX package on the same inputs ---------------------------


@pytest.fixture(scope="module")
def jax_trained():
    """JAX's centroids of clustered rows in a capacity-padded buffer with
    tombstones, then one latent cluster (rows 40-79) deleted whole: its
    centroid has no live member, so the prune has work."""
    corpus = clustered_corpus(n_clusters=48, per=40, d=32, seed=7)
    emb = np.zeros((2048, 32), np.float32)
    emb[: len(corpus)] = corpus
    alive = np.zeros(2048, bool)
    alive[: len(corpus)] = True
    alive[np.random.default_rng(7).choice(len(corpus), 200, replace=False)] = False
    cents = np.asarray(jivf.train_centroids(emb, alive, n_clusters=48, seed=3), np.float32)
    alive[40:80] = False
    return emb, alive, cents


def test_pack_matches_jax_with_jax_centroids(jax_trained):
    emb, alive, cents = jax_trained
    a_jax = jivf.assign_rows(emb, cents)
    a_port = assign_rows(emb, cents)
    np.testing.assert_array_equal(a_port, a_jax)
    assert a_port.dtype == a_jax.dtype == np.int32
    a_jax[~alive] = -1
    j_index, j_stats = jivf.pack_ivf_stats(emb, alive, cents, a_jax)
    t_index, t_stats = pack_ivf_stats(emb, alive, cents, a_jax.copy())
    np.testing.assert_array_equal(t_index.members.numpy(), np.asarray(j_index.members))
    np.testing.assert_array_equal(t_index.centroids.numpy(), np.asarray(j_index.centroids))
    for key in ("counts", "pruned_map"):
        np.testing.assert_array_equal(t_stats[key], j_stats[key])
    assert (t_stats["pruned_map"] < 0).any()  # the prune had work
    for count in (0, 1, 15, 63, 64, 65, 1000, 12345):
        assert member_slack(count) == jivf.member_slack(count)


@pytest.mark.parametrize("n_probe", [1, 4, "all"])
def test_ivf_topk_matches_jax(jax_trained, n_probe):
    emb, alive, cents = jax_trained
    assign = jivf.assign_rows(emb, cents)
    assign[~alive] = -1
    j_index = jivf.pack_ivf(emb, alive, cents, assign)
    t_index = pack_ivf_stats(emb, alive, cents, assign)[0]
    n_probe = int(t_index.centroids.shape[0]) if n_probe == "all" else n_probe
    rng = np.random.default_rng(8)
    q = norm_rows(emb[rng.choice(np.flatnonzero(alive), 6)] + 0.05 * rng.standard_normal((6, 32))).astype(np.float32)
    q[5] = emb[np.flatnonzero(alive)[0]]  # a self-match
    js, ji = jivf.ivf_topk(jnp.asarray(q), j_index, k=16, n_probe=n_probe)
    ts, ti = ivf_topk(torch.from_numpy(q), t_index, k=16, n_probe=n_probe)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


def test_lloyd_from_jax_init_matches_jax():
    corpus = clustered_corpus(n_clusters=16, per=30, d=32, seed=9)
    valid = np.ones(len(corpus), bool)
    valid[::11] = False
    seed, n_clusters = 4, 16
    want = np.asarray(jivf.train_centroids(corpus, valid, n_clusters=n_clusters, seed=seed, chunk=128))
    # JAX's init (imatch_tpu/index/ivf.py: split, then choice on key_k)
    _, key_k = jax.random.split(jax.random.key(seed))
    probs = jnp.asarray(valid, jnp.float32)
    idx = np.asarray(jax.random.choice(key_k, len(corpus), (n_clusters,), p=probs / probs.sum()))
    init = corpus[idx] / np.maximum(np.linalg.norm(corpus[idx], axis=1, keepdims=True), 1e-9)
    got = lloyd(torch.from_numpy(corpus), torch.from_numpy(valid), torch.from_numpy(init), iters=10, chunk=128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_store_ivf_engine_matches_jax_at_full_probe(monkeypatch):
    """Each package's store trains its own clustering; at a full probe
    both answer exactly, with the same ids and distances within 1e-5."""
    monkeypatch.setenv("IMATCH_IVF_NPROBE", "100000")
    corpus = clustered_corpus(n_clusters=20, per=30, d=32, seed=10)
    ids = [f"c{i}" for i in range(len(corpus))]
    stores = (JaxStore(engine="ivf"), VectorStore(engine="ivf", device="cpu"))
    for st in stores:
        st.add(ids=ids, embeddings=corpus)
        st.delete(ids[5:9])
    q = corpus[[0, 100, 599]]
    ra, rb = (st.query(q, n_results=10) for st in stores)
    assert ra["ids"] == rb["ids"]
    for da, db in zip(ra["distances"], rb["distances"]):
        np.testing.assert_allclose(db, da, rtol=0, atol=1e-5)
