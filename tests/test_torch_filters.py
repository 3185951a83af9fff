"""The captioner and filter slice end to end: the port's app against the
JAX app over the same REST sequence, on the CPU.

Both ``create_app``s hold the same tiny-md weights (JAX's
``init_md_params(jax.random.key(0))``, what ``MoondreamJax`` loads,
carried across to ``MoondreamTorch``) and the same tiny CLIP weights,
driven in-process through httpx's ASGITransport as tests/test_torch_slice.py
does. The sequence: uploads (captions in ``custom_metadata``, encodings in
``static/encoded/``), a filter added and back-filled to progress 100, a
batch filter add, an upload and a folder after filters exist (their
answers at ingest), searches with ``filters=``, DELETE, duplicates and
unknowns, and reset. Status codes, captions, ``filter_results_json``
answers, progress records and filter lists must equal the JAX app's; the
``filters.json`` and ``.npz`` files either app writes load in the other.
"""

import asyncio
import io
import json
import time

import httpx
import jax
import numpy as np
import pytest
from PIL import Image

from imatch_tpu.models.clip.configs import TINY as JAX_TINY
from imatch_tpu.models.clip.model import init_params
from imatch_tpu.models.moondream.configs import TINY_MD
from imatch_tpu.models.moondream.model import init_md_params
from imatch_tpu.models.moondream.runtime import MoondreamJax
from imatch_tpu.pipeline import captioner as jax_captioner
from imatch_tpu.pipeline import filters as jax_filters
from imatch_tpu.pipeline.embedder import ClipEmbedder as JaxEmbedder
from imatch_tpu.pipeline.state import AppState as JaxState
from imatch_tpu.serving.app import create_app as jax_create_app
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.models.moondream.runtime import MoondreamTorch
from imatch_tpu_torch.pipeline import captioner, filters
from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
from imatch_tpu_torch.pipeline.state import AppState
from imatch_tpu_torch.serving.app import create_app


class _Client:
    def __init__(self, app):
        self._c = httpx.AsyncClient(transport=httpx.ASGITransport(app=app), base_url="http://t")

    def request(self, method, url, **kw):
        return asyncio.run(self._c.request(method, url, **kw))

    def post(self, url, **kw):
        return self.request("POST", url, **kw)

    def get(self, url, **kw):
        return self.request("GET", url, **kw)

    def delete(self, url, **kw):
        return self.request("DELETE", url, **kw)


@pytest.fixture(scope="module")
def models():
    clip_tree = jax.tree.map(np.asarray, init_params(jax.random.key(0), JAX_TINY))
    md_tree = jax.tree.map(np.array, init_md_params(jax.random.key(0), TINY_MD))
    return (
        (JaxEmbedder(config=JAX_TINY), MoondreamJax(config="tiny-md")),
        (
            ClipEmbedder(config=TINY, params=clip_tree, device="cpu"),
            MoondreamTorch(config="tiny-md", params=md_tree, device="cpu"),
        ),
    )


@pytest.fixture
def apps(tmp_path, models):
    (jemb, jcap), (pemb, pcap) = models
    jstate = JaxState(root=str(tmp_path / "jax"), embedder=jemb, captioner=jcap)
    pstate = AppState(root=str(tmp_path / "port"), embedder=pemb, captioner=pcap, device="cpu")
    return _Client(jax_create_app(jstate)), _Client(create_app(pstate)), jstate, pstate


def _frame(seed, h=40, w=56):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([np.sin((seed + 1) * 3 * xx), np.cos((seed + 2) * 2 * yy), xx * yy], -1)
    return np.clip(base * 90 + 128 + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)


def _png(frame):
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "PNG")
    return buf.getvalue()


def _both(clients, method, url, **kw):
    """The same request to each app: (jax response, port response), with
    equal status codes."""
    ja, pa = clients
    ra, rb = ja.request(method, url, **kw), pa.request(method, url, **kw)
    assert ra.status_code == rb.status_code, (url, ra.text, rb.text)
    return ra, rb


def _wait_done(client, q, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rec = client.get("/api/filter-progress", params={"filter_query": q}).json()
        if rec.get("status") in ("completed", "error"):
            return rec
        time.sleep(0.05)
    raise AssertionError(f"back-fill of {q!r} did not finish: {rec}")


def _view(md):
    """A record's fields both apps must agree on (not its timestamp). The
    filter answers are compared as a dict: the back-fills that one batch
    add starts run concurrently in either app, so the order in which they
    merge their keys is a race."""
    keys = ("id", "filename", "description", "custom_metadata", "url")
    view = {k: md.get(k) for k in keys}
    raw = md.get("filter_results_json")
    view["filter_results"] = None if raw is None else json.loads(raw)
    return view


def _images(client):
    return sorted((_view(m) for m in client.get("/api/images").json()["images"]), key=lambda m: m["id"])


def test_filter_slice_same_rest_responses(apps):
    ja, pa, jstate, pstate = apps
    clients = (ja, pa)
    uploads = [_frame(s) for s in range(3)]
    for i, frame in enumerate(uploads):
        files = {"file": (f"u{i}.png", _png(frame), "image/png")}
        ra, rb = _both(clients, "POST", "/api/upload", files=files, data={"custom_metadata": "tag"} if i else {})
        assert rb.status_code == 200
        a, b = ra.json()["metadata"], rb.json()["metadata"]
        assert _view(b) == _view(a)
        assert b["custom_metadata"].startswith("tag\n\n" if i else "")
        assert "filter_results_json" not in b
        for s in (jstate, pstate):
            assert set(np.load(f"{s.encoded_dir}/{b['id']}.npz").files) == {"features"}
    ra, rb = _both(clients, "GET", "/api/filters")
    assert ra.json() == rb.json() == {"filters": []}
    ra, rb = _both(clients, "GET", "/api/filter-progress", params={"filter_query": "nothing"})
    assert ra.json() == rb.json() == {"status": "not_found"}

    # one filter, back-filled over the three uploads
    ra, rb = _both(clients, "POST", "/api/filters", data={"filter_query": "is it red"})
    assert ra.json() == rb.json() == {"success": True, "filters": ["is it red"]}
    recs = [_wait_done(c, "is it red") for c in clients]
    assert recs[0] == recs[1] == {"status": "completed", "progress": 100, "processed": 3, "total": 3}
    images = _images(pa)
    assert images == _images(ja)
    assert all(m["filter_results"]["is it red"] in ("Yes", "No") for m in images)
    ra, rb = _both(clients, "POST", "/api/filters", data={"filter_query": "is it red"})
    assert ra.json() == rb.json()
    assert rb.json()["message"] == "Filter already exists"
    ra, rb = _both(clients, "POST", "/api/filters", data={"filter_query": ""})
    assert rb.status_code == 422
    ra, rb = _both(clients, "POST", "/api/filters", files={"filter_query": ("f", b"x", "text/plain")})
    assert rb.status_code == 422 and ra.json() == rb.json()

    # a batch add: one already there, two new
    ra, rb = _both(clients, "POST", "/api/filters/batch", data={"filter_queries": "is it red, Yes or No: is it blue ,has a cat,"})
    assert ra.json() == rb.json()
    assert rb.json()["added"] == ["Yes or No: is it blue", "has a cat"]
    for q in rb.json()["added"]:
        recs = [_wait_done(c, q) for c in clients]
        assert recs[0] == recs[1] and recs[1]["progress"] == 100
    assert _images(pa) == _images(ja)

    # an upload and a folder after the filters exist: answered at ingest
    files = {"file": ("late.png", _png(_frame(10)), "image/png")}
    ra, rb = _both(clients, "POST", "/api/upload", files=files)
    late = rb.json()["metadata"]
    assert _view(late) == _view(ra.json()["metadata"])
    assert sorted(json.loads(late["filter_results_json"])) == sorted(["is it red", "Yes or No: is it blue", "has a cat"])
    folder = [("files", (f"f{s}.png", _png(_frame(20 + s, 32 + 4 * s, 48)), "image/png")) for s in range(5)]
    folder.append(("files", ("again.png", _png(uploads[1]), "image/png")))  # a duplicate
    ra, rb = _both(clients, "POST", "/api/upload-folder", files=folder)
    assert ra.json() == rb.json() and rb.json()["successful"] == 5
    images = _images(pa)
    assert images == _images(ja) and len(images) == 9
    assert all(m["custom_metadata"] or m["filename"].startswith("u0") for m in images)

    # searches with filters=: the images that answered Yes to each
    for selected in (["is it red"], ["is it red", "has a cat"], ["Yes or No: is it blue"]):
        want = sorted(m["id"] for m in images if all(m["filter_results"][f] == "Yes" for f in selected))
        data = {"query": "", "filters": selected, "limit": 100}
        ra, rb = _both(clients, "POST", "/api/search/text", data=data)
        got = sorted(r["id"] for r in rb.json()["results"])
        assert got == sorted(r["id"] for r in ra.json()["results"]) == want
        ra, rb = _both(clients, "POST", "/api/search/text", data={**data, "query": "a red drill"})
        assert [r["id"] for r in rb.json()["results"]] == [r["id"] for r in ra.json()["results"]]

    # DELETE, of a filter there and of one not
    ra, rb = _both(clients, "DELETE", "/api/filters/is%20it%20red")
    assert ra.json() == rb.json() == {"success": True, "filters": ["Yes or No: is it blue", "has a cat"]}
    ra, rb = _both(clients, "DELETE", "/api/filters/is%20it%20red")
    assert rb.status_code == 404 and ra.json() == rb.json()
    ra, rb = _both(clients, "GET", "/api/health")
    assert rb.json()["captioner"] is True and ra.json()["captioner"] is True

    # each app's filters.json loads in the other package
    assert filters.load_filters(jstate.filters_file) == jax_filters.load_filters(pstate.filters_file)
    # reset: store, progress and saved filters emptied
    ra, rb = _both(clients, "POST", "/api/reset")
    assert ra.json() == rb.json() == {"success": True}
    ra, rb = _both(clients, "GET", "/api/filters")
    assert ra.json() == rb.json() == {"filters": []}
    ra, rb = _both(clients, "GET", "/api/filter-progress", params={"filter_query": "has a cat"})
    assert ra.json() == rb.json() == {"status": "not_found"}
    assert _images(pa) == _images(ja) == []
    with open(pstate.filters_file) as f:
        assert json.load(f) == []


def test_backfill_progress_on_an_empty_store_and_without_a_captioner(tmp_path, models):
    (jemb, _), (pemb, _) = models
    jstate = JaxState(root=str(tmp_path / "jax"), embedder=jemb, captioner=jax_captioner.NullCaptioner())
    pstate = AppState(root=str(tmp_path / "port"), embedder=pemb, captioner=captioner.NullCaptioner(), device="cpu")
    clients = (_Client(jax_create_app(jstate)), _Client(create_app(pstate)))
    ra, rb = _both(clients, "POST", "/api/filters", data={"filter_query": "is it red"})
    assert ra.json() == rb.json()
    recs = [_wait_done(c, "is it red") for c in clients]
    assert recs[0] == recs[1] == {"status": "error", "message": "Model not available", "progress": 0}


def test_backfill_skips_a_missing_encoding_and_isolates_a_bad_one(apps):
    """The JAX back-fill's accounting on both: an image without a cached
    encoding is skipped, a torn encoding costs one image (the per-image
    retry), the rest are answered."""
    ja, pa, jstate, pstate = apps
    ids = []
    for i in range(3):
        files = {"file": (f"u{i}.png", _png(_frame(40 + i)), "image/png")}
        ra, rb = _both((ja, pa), "POST", "/api/upload", files=files)
        ids.append(rb.json()["metadata"]["id"])
    for s in (jstate, pstate):
        import os

        os.unlink(f"{s.encoded_dir}/{ids[0]}.npz")
        np.savez(f"{s.encoded_dir}/{ids[1]}.npz", features=np.zeros((3, 5), np.float32))
    ra, rb = _both((ja, pa), "POST", "/api/filters", data={"filter_query": "is it red"})
    recs = [_wait_done(c, "is it red") for c in (ja, pa)]
    assert recs[0] == recs[1] == {
        "status": "completed", "progress": 100, "processed": 1, "total": 3, "errors": 1, "skipped": 1,
    }
    assert _images(pa) == _images(ja)
