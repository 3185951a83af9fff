"""The PyTorch port's sharded engines (``sharded``, ``ivf-sharded``) as
serving engines, at P = 1, 2, 4 and 8 shards on the CPU.

The cases of tests/test_sharded_store.py on the port, where the P shards
of the store's mesh (parallel/mesh.py) are P entries ``cpu`` (the JAX
suite runs 8 virtual host devices): ``sharded`` answers as the port's
``tilemax`` does bit for bit (ids and distances), ties go to the lower
global index across shards, mutations patch the sharded state into what
a fresh build makes, ``ivf-sharded`` at a full probe answers as
``sharded`` bit for bit and recalls at the default probe; ``auto`` picks
``sharded`` when more than one CUDA device is visible (the count
patched); the HTTP text search runs through the sharded engine. Against
the JAX package: the port's ``sharded`` store and its
``sharded_cosine_topk`` at 8 shards give the JAX 8-device mesh's ids,
with scores within 1e-6.
"""

import asyncio
import io

import httpx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from imatch_tpu.index.store import VectorStore as JaxStore
from imatch_tpu.parallel.dist_search import sharded_cosine_topk as jax_sharded_cosine_topk
from imatch_tpu.parallel.mesh import make_mesh as jax_make_mesh
from imatch_tpu_torch.index.store import VectorStore
from imatch_tpu_torch.parallel.dist_search import pad_corpus_for_mesh, sharded_cosine_topk
from imatch_tpu_torch.parallel.mesh import make_mesh

SHARDS = [1, 2, 4, 8]


def _mk_corpus(n, d, seed=0):
    emb = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _store(engine, p, **kw):
    return VectorStore(engine=engine, device="cpu", mesh=("cpu",) * p, **kw)


def _pair(p, n=900, d=64, seed=0):
    emb = _mk_corpus(n, d, seed)
    ids = [f"r{i:05d}" for i in range(n)]
    mds = [{"id": i} for i in ids]
    a, b = VectorStore(engine="tilemax", device="cpu"), _store("sharded", p)
    for s in (a, b):
        s.add(ids=ids, embeddings=emb, metadatas=mds)
    return a, b, emb, ids


def _bit_equal(ra, rb):
    assert ra["ids"] == rb["ids"]
    assert ra["distances"] == rb["distances"]


@pytest.mark.parametrize("p", SHARDS)
def test_sharded_engine_matches_tilemax(p):
    a, b, emb, _ = _pair(p)
    q = emb[[3, 500, 777]] * 0.9 + _mk_corpus(3, 64, seed=9) * 0.1
    for n_results in (1, 17, 1000):
        _bit_equal(a.query(q, n_results=n_results), b.query(q, n_results=n_results))
    _bit_equal(a.query(q[:1], n_results=5), b.query(q[:1], n_results=5))
    assert b.stats()["last_build"]["engine"] == "sharded"
    assert len(b._device_corpus[1].shards) == p


@pytest.mark.parametrize("p", SHARDS)
def test_sharded_engine_self_match_and_duplicate_ties(p):
    """Ties go to the lower index across shards: a duplicate in a later
    shard loses to its copy in an earlier one."""
    n, d = 640, 32
    emb = _mk_corpus(n, d)
    emb[600] = emb[5]
    ids = [f"x{i:04d}" for i in range(n)]
    s = _store("sharded", p)
    s.add(ids=ids, embeddings=emb)
    r = s.query(emb[[5]], n_results=2)
    assert r["ids"][0] == ["x0005", "x0600"]
    assert r["distances"][0][0] == r["distances"][0][1]


def _states_equal(got, want):
    assert got.rows == want.rows and len(got.shards) == len(want.shards)
    for g, w in zip(got.shards, want.shards):
        for field in ("scoring", "exact", "valid"):
            assert torch.equal(getattr(g, field), getattr(w, field)), field


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_sharded_engine_tracks_mutations(p, dtype):
    """Adds, deletes and updates patch the sharded state (no rebuild) into
    what a fresh build of the same rows makes; answers stay tilemax's."""
    a, b, emb, ids = _pair(p, n=300, d=32)
    for s in (a, b):
        s.score_dtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    q = emb[[7]]
    top = a.query(q, n_results=1)["ids"][0][0]
    b.query(q, n_results=1)  # the build the mutations patch
    for s in (a, b):
        s.delete([top])
    _bit_equal(a.query(q, n_results=5), b.query(q, n_results=5))
    for s in (a, b):
        s.add(ids=["new"], embeddings=q)
        s.update(ids=ids[10:14], embeddings=_mk_corpus(4, 32, seed=3))
    ra, rb = a.query(q, n_results=3), b.query(q, n_results=3)
    assert rb["ids"][0][0] == "new"
    _bit_equal(ra, rb)
    st = b.stats()
    assert (st["patched_mutations"], st["rebuild_mutations"]) == (3, 0)
    _states_equal(b._device_corpus[1], b._build_device(b._emb.copy(), b._alive.copy())[0][1])


@pytest.mark.parametrize("p", SHARDS)
def test_sharded_engine_k_exceeds_corpus(p):
    emb = _mk_corpus(5, 16)
    s = _store("sharded", p)
    s.add(ids=[f"t{i}" for i in range(5)], embeddings=emb)
    r = s.query(emb[[0]], n_results=50)
    assert r["ids"][0][0] == "t0"
    assert len(r["ids"][0]) == 5  # no phantom rows


def test_auto_engine_resolves_to_sharded_on_mesh(monkeypatch):
    assert VectorStore(engine="auto", device="cpu").engine == "tilemax"
    assert VectorStore(engine="auto", device="cpu", mesh=["cpu", "cpu"]).engine == "sharded"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count, want in ((1, "tilemax"), (2, "sharded"), (8, "sharded")):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        s = VectorStore(engine="auto")
        assert s.engine == want
        assert s._mesh == make_mesh() == tuple(torch.device("cuda", i) for i in range(count))
    jax_want = "sharded" if len(jax.devices()) > 1 else "tilemax"
    assert JaxStore(engine="auto").engine == jax_want


@pytest.mark.parametrize("p", SHARDS)
def test_ivf_sharded_full_probe_equals_exact(p, monkeypatch):
    """With n_probe at least every shard's cluster count each shard scans
    all its rows: the answers are the exact sharded engine's, bit for bit."""
    n, d = 960, 48
    emb = _mk_corpus(n, d, seed=3)
    ids = [f"v{i:05d}" for i in range(n)]
    exact, ann = _store("sharded", p), _store("ivf-sharded", p)
    for s in (exact, ann):
        s.add(ids=ids, embeddings=emb)
    q = emb[[7, 430, 901]] * 0.95 + _mk_corpus(3, d, seed=11) * 0.05
    monkeypatch.setenv("IMATCH_IVF_NPROBE", "4096")
    for rows in (q, q[:1]):
        _bit_equal(ann.query(rows, n_results=12), exact.query(rows, n_results=12))
    assert ann.stats()["ivf"]["kind"] == "ivf-sharded"


def test_ivf_sharded_default_probe_recall_and_mutations():
    rng = np.random.default_rng(21)
    centers = _mk_corpus(24, 32, seed=5)
    rows = centers[rng.integers(0, 24, 1200)] + 0.05 * rng.standard_normal((1200, 32)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    ids = [f"c{i:05d}" for i in range(1200)]
    exact, ann = VectorStore(engine="tilemax", device="cpu"), _store("ivf-sharded", 8)
    for s in (exact, ann):
        s.add(ids=ids, embeddings=rows)
    q = rows[[10, 600, 1100]]
    re, ra = exact.query(q, n_results=10), ann.query(q, n_results=10)
    for row, qi in zip(ra["ids"], (10, 600, 1100)):
        assert row[0] == ids[qi]  # its own cluster is the first probe
    recall = np.mean([len(set(a) & set(e)) / len(e) for a, e in zip(ra["ids"], re["ids"])])
    assert recall >= 0.9, recall
    ann.delete(ids=[ids[10]])
    assert ids[10] not in ann.query(q[:1], n_results=3)["ids"][0]
    ann.add(ids=["fresh"], embeddings=rows[[10]])
    assert ann.query(q[:1], n_results=3)["ids"][0][0] == "fresh"
    assert ann.stats()["patched_mutations"] == 2


def test_sharded_store_matches_jax_mesh():
    """The port at 8 shards against the JAX store on its 8-device mesh:
    the same ids, distances within 1e-6, with tombstones and ties."""
    emb = _mk_corpus(700, 32, seed=4)
    emb[650] = emb[12]
    ids = [f"m{i}" for i in range(700)]
    stores = (JaxStore(engine="sharded"), _store("sharded", 8))
    for s in stores:
        s.add(ids=ids, embeddings=emb)
        s.delete(ids[100:140])
    q = np.concatenate([emb[[12, 300]], _mk_corpus(2, 32, seed=8)])
    for n_results in (1, 10, 1000):
        ra, rb = (s.query(q, n_results=n_results) for s in stores)
        assert ra["ids"] == rb["ids"]
        for da, db in zip(ra["distances"], rb["distances"]):
            np.testing.assert_allclose(db, da, rtol=0, atol=1e-6)


def test_sharded_cosine_topk_matches_jax():
    mesh = jax_make_mesh()
    dp = mesh.shape["data"]
    corpus = _mk_corpus(1003, 24, seed=6)
    valid = np.ones(1003, bool)
    valid[::9] = False
    q = _mk_corpus(3, 24, seed=7)
    jc, jv = jnp.pad(jnp.asarray(corpus), ((0, 5), (0, 0))), jnp.pad(jnp.asarray(valid), (0, 5))
    js, ji = jax_sharded_cosine_topk(jnp.asarray(q), jc, jv, mesh=mesh, k=10, chunk=64)
    tc, tv = pad_corpus_for_mesh(torch.from_numpy(corpus), torch.from_numpy(valid), dp)
    assert tc.shape == jc.shape and torch.equal(tv, torch.from_numpy(np.array(jv)))
    ts, ti = sharded_cosine_topk(torch.from_numpy(q), tc, tv, mesh=make_mesh(["cpu"] * dp), k=10, chunk=64)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        sharded_cosine_topk(torch.from_numpy(q), torch.from_numpy(corpus), torch.from_numpy(valid), mesh=("cpu",) * 2, k=3)


def _png(seed):
    im = Image.fromarray(np.random.default_rng(seed).integers(0, 256, (48, 48, 3), dtype=np.uint8), "RGB")
    buf = io.BytesIO()
    im.save(buf, "PNG")
    return buf.getvalue()


def test_http_text_search_through_sharded_engine(tmp_path, monkeypatch):
    """/api/search/text through the port's sharded engine (4 shards)
    against the JAX app's sharded engine (its 8-device mesh), the same
    TINY weights: the same ids, scores within the towers' 1e-5."""
    from imatch_tpu.models.clip.configs import TINY as JAX_TINY
    from imatch_tpu.models.clip.model import init_params
    from imatch_tpu.pipeline.captioner import NullCaptioner as JaxNullCaptioner
    from imatch_tpu.pipeline.embedder import ClipEmbedder as JaxEmbedder
    from imatch_tpu.pipeline.state import AppState as JaxState
    from imatch_tpu.serving.app import create_app as jax_create_app
    from imatch_tpu_torch.models.clip.configs import TINY
    from imatch_tpu_torch.pipeline.captioner import NullCaptioner
    from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
    from imatch_tpu_torch.pipeline.state import AppState
    from imatch_tpu_torch.serving.app import create_app

    monkeypatch.setenv("IMATCH_INDEX_ENGINE", "sharded")
    tree = jax.tree.map(np.asarray, init_params(jax.random.key(0), JAX_TINY))
    jax_state = JaxState(root=str(tmp_path / "j"), embedder=JaxEmbedder(config=JAX_TINY), captioner=JaxNullCaptioner())
    port_state = AppState(
        root=str(tmp_path / "t"),
        embedder=ClipEmbedder(config=TINY, params=tree, device="cpu"),
        captioner=NullCaptioner(),
        device="cpu",
    )
    port_state.store = _store("sharded", 4)
    assert jax_state.store.engine == port_state.store.engine == "sharded"

    async def drive(app):
        async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app), base_url="http://t") as c:
            for i in range(6):
                r = await c.post("/api/upload", files={"file": (f"img{i}.png", _png(i), "image/png")})
                assert r.status_code == 200, r.text
            r = await c.get("/api/search/text?query=red%20drill&limit=5")
            assert r.status_code == 200
            return r.json()["results"]

    res_j = asyncio.run(drive(jax_create_app(jax_state)))
    res_t = asyncio.run(drive(create_app(port_state)))
    assert [r["id"] for r in res_t] == [r["id"] for r in res_j]
    assert len(res_t) == 5
    for a, b in zip(res_t, res_j):
        # the towers of the two packages agree to 1e-5 (tests/test_torch_slice.py)
        assert a["similarity_score"] == pytest.approx(b["similarity_score"], abs=1e-5)
    assert port_state.store.stats()["last_build"]["engine"] == "sharded"


def test_final_scores_do_not_depend_on_the_batch():
    """``search.final_topk`` gives a row the same score bit for bit
    whatever rows and queries are scored beside it (a batched matmul's
    last bit changes with the shape): the sharded engines and the IVF
    probe score rows in batches of other shapes than ``tilemax``."""
    from imatch_tpu_torch.index.search import final_topk

    rows = torch.from_numpy(_mk_corpus(3000, 64, seed=12))
    q = torch.from_numpy(_mk_corpus(5, 64, seed=13))
    cand = torch.arange(3000).expand(5, -1)
    want_s, want_i = final_topk(cand, q, rows, 3000)
    for nq, r in ((1, 7), (1, 48), (2, 100), (5, 1000)):
        got_s, got_i = final_topk(cand[:nq, :r], q[:nq], rows, r)
        for qi in range(nq):
            order = got_i[qi]
            full = dict(zip(want_i[qi].tolist(), want_s[qi].tolist()))
            assert [full[i] for i in order.tolist()] == got_s[qi].tolist()
