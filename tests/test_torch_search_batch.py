"""Batched text and image search on the port against the JAX app, on the
CPU: ports of tests/test_api.py:460-590 and tests/test_index.py:405, 433.

Both ``create_app``s run with the same TINY weights (JAX's
``init_params(jax.random.key(0))`` carried across) and the same fake
captioner, in-process through httpx. ``/api/search/batch`` and
``/api/search/image-batch`` give the JAX app's rows (equal ids,
similarities within 1e-5) and its 422 bodies, and each row equals the
single route's. ``IMATCH_QUERY_PIXEL_BUDGET`` small enough to split a
mixed-size batch into three or more chunks gives the unchunked
embeddings within 1e-6. A (Q, d) store query equals Q single queries on
every engine, also with the Q padding, and ``warm`` leaves the store as
it was.
"""

import asyncio
import io
import time

import httpx
import jax
import numpy as np
import pytest
from PIL import Image

from imatch_tpu.models.clip.configs import TINY as JAX_TINY
from imatch_tpu.models.clip.model import init_params
from imatch_tpu.pipeline.embedder import ClipEmbedder as JaxEmbedder
from imatch_tpu.pipeline.state import AppState as JaxState
from imatch_tpu.serving.app import create_app as jax_create_app
from imatch_tpu_torch.index.store import VectorStore
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
from imatch_tpu_torch.pipeline.state import AppState
from imatch_tpu_torch.serving.app import create_app

N_IMAGES = 6


class FakeCaptioner:
    """Deterministic VLM stand-in (tests/test_api.py's)."""

    available = True

    def encode_image(self, image_np):
        return {"feat": np.asarray(image_np, dtype=np.float32).mean(axis=(0, 1))}

    def caption(self, encoded):
        return {"caption": "a power drill on a table"}

    def query(self, encoded, question):
        return {"answer": "Yes" if "drill" in question.lower() else "No"}


class _Client:
    def __init__(self, app):
        self._c = httpx.AsyncClient(transport=httpx.ASGITransport(app=app), base_url="http://t")

    def request(self, method, url, **kw):
        return asyncio.run(self._c.request(method, url, **kw))

    def post(self, url, **kw):
        return self.request("POST", url, **kw)

    def get(self, url, **kw):
        return self.request("GET", url, **kw)


@pytest.fixture(scope="module")
def embedders():
    tree = jax.tree.map(np.asarray, init_params(jax.random.key(0), JAX_TINY))
    return JaxEmbedder(config=JAX_TINY), ClipEmbedder(config=TINY, params=tree, device="cpu")


@pytest.fixture
def apps(tmp_path, embedders):
    jax_emb, port_emb = embedders
    ja = jax_create_app(
        JaxState(root=str(tmp_path / "jax"), embedder=jax_emb, captioner=FakeCaptioner())
    )
    pa = create_app(
        AppState(
            root=str(tmp_path / "port"), embedder=port_emb, captioner=FakeCaptioner(), device="cpu"
        )
    )
    return _Client(ja), _Client(pa)


def _frame(seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * (seed + 1) % 256, yy * (7 - seed % 5) % 256, (xx ^ yy) * seed % 256], -1)
    return np.clip(base + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)


def _png(seed, h=48, w=64):
    buf = io.BytesIO()
    Image.fromarray(_frame(seed, h, w)).save(buf, "PNG")
    return buf.getvalue()


def _fill(apps):
    for seed in range(N_IMAGES):
        for c in apps:
            r = c.post(
                "/api/upload",
                files={"file": (f"img{seed}.png", _png(seed), "image/png")},
                data={"description": f"image {seed}"},
            )
            assert r.status_code == 200, r.text


def _rows_equal(ra, rb):
    assert ra.status_code == rb.status_code == 200, (ra.text, rb.text)
    rows_a, rows_b = ra.json()["results"], rb.json()["results"]
    assert len(rows_a) == len(rows_b)
    for a, b in zip(rows_a, rows_b):
        assert [x["id"] for x in a] == [x["id"] for x in b]
        np.testing.assert_allclose(
            [x["similarity_score"] for x in b], [x["similarity_score"] for x in a], rtol=0, atol=1e-5
        )
    return rows_b


QUERIES = ["red drill", "a yellow banana", "power tool on a table"]


@pytest.mark.parametrize("limit", [4, 0])
def test_search_batch_equals_jax_and_single(apps, limit):
    _fill(apps)
    ja, pa = apps
    body = {"queries": QUERIES, "limit": limit}
    rows = _rows_equal(ja.post("/api/search/batch", json=body), pa.post("/api/search/batch", json=body))
    assert len(rows) == len(QUERIES)
    for q, row in zip(QUERIES, rows):
        assert len(row) == (limit or N_IMAGES)
        single = pa.post("/api/search/text", data={"query": q, "limit": limit}).json()["results"]
        assert [x["id"] for x in row] == [x["id"] for x in single]
        np.testing.assert_allclose(
            [x["similarity_score"] for x in row], [x["similarity_score"] for x in single], atol=1e-6
        )


def _wait_filter(client, fq):
    for _ in range(200):
        p = client.get("/api/filter-progress", params={"filter_query": fq}).json()
        if p.get("status") == "completed":
            return p
        time.sleep(0.05)
    raise AssertionError(f"filter {fq!r} did not complete")


def test_search_batch_filters_and_limits(apps):
    _fill(apps)
    ja, pa = apps
    for c in apps:
        c.post("/api/filters", data={"filter_query": "is it a drill"})
        _wait_filter(c, "is it a drill")
    body = {"queries": ["drill"], "limit": 0, "filters": ["is it a drill"]}
    (row,) = _rows_equal(ja.post("/api/search/batch", json=body), pa.post("/api/search/batch", json=body))
    assert len(row) == N_IMAGES  # limit 0 -> all; the fake answers Yes
    for c in apps:
        r = c.post("/api/search/batch", json={"queries": []})
        assert r.status_code == 200 and r.json() == {"results": []}
    # an empty query with filters is the newest-first listing, beside
    # embedded queries in the same batch
    body = {"queries": ["", "drill", ""], "limit": 0, "filters": ["is it a drill"]}
    ra, rb = ja.post("/api/search/batch", json=body), pa.post("/api/search/batch", json=body)
    single = pa.post(
        "/api/search/text", data={"query": "", "limit": 0, "filters": "is it a drill"}
    ).json()["results"]
    listing, embedded, listing2 = rb.json()["results"]
    assert [x["id"] for x in listing] == [x["id"] for x in single] == [x["id"] for x in listing2]
    assert [x["id"] for x in listing] == [x["id"] for x in ra.json()["results"][0]]
    assert len(embedded) == N_IMAGES and "similarity_score" in embedded[0]
    assert [x["id"] for x in embedded] == [x["id"] for x in ra.json()["results"][1]]


@pytest.mark.parametrize(
    "body",
    [
        {},
        {"queries": "not a list"},
        {"queries": ["ok", 3]},
        {"queries": ["q"] * 257},
        {"queries": ["q"], "filters": "is it red"},
        {"queries": ["q"], "filters": 5},
        {"queries": ["q"], "filters": [3]},
        ["not", "a", "dict"],
    ],
    ids=["empty", "str", "non-str", "257", "filters-str", "filters-int", "filters-non-str", "list-body"],
)
def test_search_batch_validation_same_422(apps, body):
    ja, pa = apps
    ra, rb = ja.post("/api/search/batch", json=body), pa.post("/api/search/batch", json=body)
    assert ra.status_code == rb.status_code == 422
    assert ra.json() == rb.json()


def test_search_batch_non_json_body_same_422(apps):
    ja, pa = apps
    ra = ja.post("/api/search/batch", content=b"{nope", headers={"content-type": "application/json"})
    rb = pa.post("/api/search/batch", content=b"{nope", headers={"content-type": "application/json"})
    assert ra.status_code == rb.status_code == 422 and ra.json() == rb.json()


def test_search_image_batch_equals_jax_and_single(apps):
    _fill(apps)
    ja, pa = apps
    seeds = [0, 3, 5]
    files = [("files", (f"q{s}.png", _png(s), "image/png")) for s in seeds]
    rows = _rows_equal(
        ja.post("/api/search/image-batch", files=files, data={"limit": 4}),
        pa.post("/api/search/image-batch", files=files, data={"limit": 4}),
    )
    assert len(rows) == len(seeds)
    for s, row in zip(seeds, rows):
        single = pa.post(
            "/api/search/image", files={"file": ("q.png", _png(s), "image/png")}, data={"limit": 4}
        ).json()["results"]
        assert [x["id"] for x in row] == [x["id"] for x in single]
        np.testing.assert_allclose(
            [x["similarity_score"] for x in row], [x["similarity_score"] for x in single], atol=1e-6
        )
        assert row[0]["filename"] == f"img{s}.png" and row[0]["similarity_score"] > 0.999


def test_search_image_batch_validation(apps):
    ja, pa = apps
    for c in apps:
        assert c.post("/api/search/image-batch").status_code == 422
        r = c.post(
            "/api/search/image-batch", files=[("files", ("bad.jpg", b"not an image", "image/jpeg"))]
        )
        assert r.status_code == 422 and "bad.jpg" in r.json()["error"]
    assert ja.post("/api/search/image-batch").json() == pa.post("/api/search/image-batch").json()
    many = [("files", (f"f{i}.png", _png(0, 8, 8), "image/png")) for i in range(257)]
    ra, rb = ja.post("/api/search/image-batch", files=many), pa.post("/api/search/image-batch", files=many)
    assert ra.status_code == rb.status_code == 422 and ra.json() == rb.json()


def test_pixel_budget_chunks_equal_unchunked(embedders, monkeypatch):
    _, emb = embedders
    sizes = [(48, 64), (20, 30), (64, 64), (33, 17), (48, 64), (64, 40), (16, 16)]
    frames = [_frame(i, h, w) for i, (h, w) in enumerate(sizes)]
    whole = emb.embed_images_device(frames)
    calls = []
    orig = emb._embed_frames

    def counting(images):
        calls.append(len(images))
        return orig(images)

    monkeypatch.setattr(emb, "_embed_frames", counting)
    monkeypatch.setenv("IMATCH_QUERY_PIXEL_BUDGET", str(64 * 64 + 1))
    chunked = emb.embed_images_device(frames)
    assert len(calls) >= 3 and sum(calls) == len(frames), calls
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0, atol=1e-6)
    # the JAX embedder under the same budget
    jax_emb = embedders[0]
    want = np.asarray(jax_emb.embed_images_device(frames))
    np.testing.assert_allclose(chunked.numpy(), want, rtol=0, atol=1e-5)


def _norm_rows(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _engine_store(engine, dtype, monkeypatch, n=257, dim=32):
    monkeypatch.setenv("IMATCH_SCORE_DTYPE", dtype)
    rng = np.random.default_rng(0)
    emb = _norm_rows(rng.standard_normal((n, dim)).astype(np.float32))
    store = VectorStore(engine=engine, device="cpu")
    store.add(ids=[f"img_{i:04d}" for i in range(n)], embeddings=emb, metadatas=[{"i": i} for i in range(n)])
    return store, emb


ENGINES = [("tilemax", "bf16"), ("tilemax", "fp32"), ("tilemax", "int8"), ("pallas", "bf16"), ("tilemax-host", "bf16")]


@pytest.mark.parametrize("engine,dtype", ENGINES)
@pytest.mark.parametrize("nq", [3, 5])
def test_store_batch_query_matches_per_query(engine, dtype, nq, monkeypatch):
    store, emb = _engine_store(engine, dtype, monkeypatch)
    rng = np.random.default_rng(3)
    rows = [5, 99, 200, 17, 256][:nq]
    q = _norm_rows(emb[rows] * 0.8 + rng.standard_normal((nq, 32)).astype(np.float32) * 0.2)
    seen = []
    orig = store._run_engine
    store._run_engine = lambda qq, dc, k: seen.append(qq.shape[0]) or orig(qq, dc, k)
    batched = store.query(query_embeddings=q, n_results=7)
    assert seen == [nq]  # the real query count: the port pads no rows
    assert len(batched["ids"]) == nq
    for qi in range(nq):
        single = store.query(query_embeddings=q[qi], n_results=7)
        assert batched["ids"][qi] == single["ids"][0]
        np.testing.assert_allclose(batched["distances"][qi], single["distances"][0], atol=1e-6)


def test_store_warm_then_query(monkeypatch):
    store, emb = _engine_store("tilemax", "bf16", monkeypatch, n=64)
    seen = []
    orig = store._run_engine
    store._run_engine = lambda qq, dc, k: seen.append((qq.shape[0], k)) or orig(qq, dc, k)
    store.warm(q_counts=(1, 3, 16))
    # every (Q bucket, k bucket) pair once: k in 1, 16, 32, 64 (limit 1000 -> 64 live)
    assert sorted(seen) == sorted((q, k) for q in (1, 4, 16) for k in (1, 16, 32, 64))
    before = store.stats()
    res = store.query(query_embeddings=[emb[5]], n_results=10)
    assert res["ids"][0][0] == "img_0005"
    assert store.count() == 64 and before["journal_ops"] == store.stats()["journal_ops"]
    VectorStore(dim=8, device="cpu").warm()  # an empty store: nothing to run
