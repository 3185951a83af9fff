"""The PyTorch port's slice end to end against the JAX app.

Both ``create_app``s run with the ``NullCaptioner`` and the same TINY
weights (the JAX ``init_params(jax.random.key(0))`` tree, carried across
to the port), driven in-process through httpx's ASGITransport as in
tests/test_api.py; the port runs on ``device="cpu"``. The same uploads
must give the same ids, 409 on a duplicate, identical text, image and
multimodal top-k with similarity ``1 - d/2``, ``limit=0`` -> up to 1000,
and 422 for string fields sent as file parts. The search tiers that the
environment selects (``IMATCH_SCORE_DTYPE=int8``,
``IMATCH_INDEX_ENGINE=tilemax-host``) answer as the JAX app does under
the same environment.
"""

import asyncio
import io

import httpx
import jax
import numpy as np
import pytest
from PIL import Image

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

N_IMAGES = 6


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


def _make_apps(tmp_path, embedders):
    jax_emb, port_emb = embedders
    jax_app = jax_create_app(
        JaxState(root=str(tmp_path / "jax"), embedder=jax_emb, captioner=JaxNullCaptioner())
    )
    port_state = AppState(
        root=str(tmp_path / "port"), embedder=port_emb, captioner=NullCaptioner(), device="cpu"
    )
    return _Client(jax_app), _Client(create_app(port_state)), port_state


@pytest.fixture
def apps(tmp_path, embedders):
    return _make_apps(tmp_path, embedders)[:2]


def _png(seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * (seed + 1) % 256, yy * (7 - seed % 5) % 256, (xx ^ yy) * seed % 256], -1)
    img = np.clip(base + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


def _upload(client, seed, **data):
    return client.post(
        "/api/upload", files={"file": (f"img{seed}.png", _png(seed), "image/png")}, data=data
    )


def _ranked(resp):
    assert resp.status_code == 200, resp.text
    return [(r["id"], r["similarity_score"]) for r in resp.json()["results"]]


def _same_ranking(a, b):
    ra, rb = _ranked(a), _ranked(b)
    assert [i for i, _ in ra] == [i for i, _ in rb]
    np.testing.assert_allclose([s for _, s in rb], [s for _, s in ra], rtol=0, atol=1e-5)
    return rb


def _fill(apps):
    ids = []
    for seed in range(N_IMAGES):
        ra, rb = (_upload(c, seed, description=f"image {seed}") for c in apps)
        assert ra.status_code == rb.status_code == 200
        ma, mb = ra.json()["metadata"], rb.json()["metadata"]
        assert ma["id"] == mb["id"]
        for key in ("filename", "description", "custom_metadata", "url", "thumbnail_url"):
            assert ma[key] == mb[key]
        ids.append(mb["id"])
    return ids


def test_uploads_give_same_ids_and_409(apps):
    ids = _fill(apps)
    assert len(set(ids)) == N_IMAGES
    for c in apps:
        r = _upload(c, 2, description="again")
        assert r.status_code == 409
        body = r.json()
        assert body["error"] == "Duplicate image" and body["metadata"]["id"] == ids[2]
    listed = [sorted(m["id"] for m in c.get("/api/images").json()["images"]) for c in apps]
    assert listed[0] == listed[1] == sorted(ids)
    for c in apps:
        assert c.get(f"/api/image/{ids[0]}").json()["image"]["id"] == ids[0]
        assert c.get("/api/image/img_nope").status_code == 404


@pytest.mark.parametrize("limit", [3, 0])
def test_text_search_matches(apps, limit):
    _fill(apps)
    ja, pa = apps
    ra = ja.post("/api/search/text", data={"query": "a red drill", "limit": limit})
    rb = pa.post("/api/search/text", data={"query": "a red drill", "limit": limit})
    got = _same_ranking(ra, rb)
    assert len(got) == (limit or N_IMAGES)
    scores = [s for _, s in got]
    assert scores == sorted(scores, reverse=True)
    g = pa.get("/api/search/text", params={"query": "a red drill", "limit": limit})
    assert _ranked(g) == got


def test_image_search_matches_and_self_match_first(apps):
    ids = _fill(apps)
    ja, pa = apps
    files = {"file": ("q.png", _png(4), "image/png")}
    got = _same_ranking(
        ja.post("/api/search/image", files=files, data={"limit": 4}),
        pa.post("/api/search/image", files=files, data={"limit": 4}),
    )
    assert got[0][0] == ids[4] and got[0][1] > 0.999


def test_multimodal_search_matches(apps):
    _fill(apps)
    ja, pa = apps
    files = {"file": ("q.png", _png(1), "image/png")}
    data = {"query": "a blue sky", "weight_image": 0.3, "limit": 5}
    _same_ranking(
        ja.post("/api/search/multimodal", files=files, data=data),
        pa.post("/api/search/multimodal", files=files, data=data),
    )


def test_string_fields_as_file_parts_are_422(apps):
    for c in apps:
        r = c.post(
            "/api/upload",
            files={
                "file": ("a.png", _png(9), "image/png"),
                "description": ("d.txt", b"desc", "text/plain"),
            },
        )
        assert r.status_code == 422
        r = c.post("/api/search/text", files={"query": ("q.txt", b"hi", "text/plain")})
        assert r.status_code == 422
        r = c.post(
            "/api/search/multimodal",
            files={"file": ("a.png", _png(9), "image/png"), "query": ("q.txt", b"x", "text/plain")},
        )
        assert r.status_code == 422
        assert c.post("/api/upload", data={"description": "no file"}).status_code == 422


def test_empty_query_with_filters_lists_newest_first(apps):
    _fill(apps)
    ja, pa = apps
    data = {"query": "", "filters": ["is it red"], "limit": 0}
    ra, rb = ja.post("/api/search/text", data=data), pa.post("/api/search/text", data=data)
    # NullCaptioner: no image carries filter answers, so the AND pass drops all
    assert ra.json() == rb.json() == {"results": []}


def test_health_and_routes_still_to_port(apps):
    _, pa = apps
    h = pa.get("/api/health").json()
    assert h["status"] == "ok" and h["model"] == "tiny" and h["captioner"] is False
    # every route of the JAX app is ported now: the batch route answers
    r = pa.post("/api/search/batch", json={"queries": []})
    assert r.status_code == 200 and r.json() == {"results": []}
    assert pa.get("/api/nope").status_code == 404


@pytest.mark.parametrize(
    "env,engine",
    [({"IMATCH_INDEX_ENGINE": "tilemax-host"}, "tilemax-host"), ({"IMATCH_SCORE_DTYPE": "int8"}, "tilemax")],
    ids=["tilemax-host", "int8"],
)
def test_search_tiers_from_the_environment_match(tmp_path, embedders, monkeypatch, env, engine):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    ja, pa, port_state = _make_apps(tmp_path, embedders)
    _fill((ja, pa))
    for limit in (4, 0):
        ra = ja.post("/api/search/text", data={"query": "a red drill", "limit": limit})
        rb = pa.post("/api/search/text", data={"query": "a red drill", "limit": limit})
        _same_ranking(ra, rb)
        # the same JSON, apart from the float score (checked above), the
        # app's root directory and the upload time
        own = ("similarity_score", "processed_url", "created_at")
        for a, b in zip(ra.json()["results"], rb.json()["results"]):
            assert a.keys() == b.keys()
            assert {k: v for k, v in a.items() if k not in own} == {
                k: v for k, v in b.items() if k not in own
            }
    stats = port_state.store.stats()
    assert stats["last_build"]["engine"] == engine
    assert stats["score_dtype"] == ("int8" if engine == "tilemax" else "bfloat16")
