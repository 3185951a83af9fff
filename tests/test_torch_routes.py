"""The rest of the serving surface on the port against the JAX app, on the
CPU (ports of tests/test_api.py:312-416):

- ``/search`` picks text, image or multimodal as JAX does, and
  ``enhance_with_caption`` extends the multimodal query with the query
  image's caption: the same results as JAX's, and as the port's
  ``/api/search/multimodal`` with the extended text;
- ``/upload-samples`` over a directory the test writes gives JAX's
  per-file results and counts, an undecodable file reported on its own;
- ``/api/metrics`` has JAX's keys after the same requests, and beside
  them exactly the port's own search-path spans;
- ``/api/profile/start`` twice and a stop without a start are 409s, and a
  trace is written, the program's spans in it;
- ``GET /`` and ``GET /manage`` are byte-identical to JAX's;
- the two apps have the same route table, and no route answers 501;
- the warmup (IMATCH_WARMUP, on by default) runs in the background and
  leaves the store as it was.
"""

import asyncio
import io
import json
import os
import threading

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
from imatch_tpu.utils.metrics import METRICS as JAX_METRICS
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
from imatch_tpu_torch.pipeline.state import AppState
from imatch_tpu_torch.serving import app as app_mod
from imatch_tpu_torch.serving.app import create_app
from imatch_tpu_torch.utils.metrics import METRICS


class FakeCaptioner:
    available = True

    def encode_image(self, image_np):
        return {"feat": np.asarray(image_np, dtype=np.float32).mean(axis=(0, 1))}

    def caption(self, encoded):
        return {"caption": "a power drill on a table"}

    def query(self, encoded, question):
        return {"answer": "Yes" if "drill" in question.lower() else "No"}


class _Client:
    def __init__(self, app):
        self.app = app
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


def _apps(tmp_path, embedders, captioner=FakeCaptioner):
    jax_emb, port_emb = embedders
    ja = jax_create_app(JaxState(root=str(tmp_path / "jax"), embedder=jax_emb, captioner=captioner()))
    pstate = AppState(root=str(tmp_path / "port"), embedder=port_emb, captioner=captioner(), device="cpu")
    return _Client(ja), _Client(create_app(pstate)), pstate


@pytest.fixture
def apps(tmp_path, embedders):
    return _apps(tmp_path, embedders)[:2]


def _frame(seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * (seed + 1) % 256, yy * (7 - seed % 5) % 256, (xx ^ yy) * seed % 256], -1)
    return np.clip(base + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)


def _png(seed, h=48, w=64):
    buf = io.BytesIO()
    Image.fromarray(_frame(seed, h, w)).save(buf, "PNG")
    return buf.getvalue()


def _fill(apps, n=5):
    for seed in range(n):
        for c in apps:
            r = c.post("/api/upload", files={"file": (f"img{seed}.png", _png(seed), "image/png")})
            assert r.status_code == 200, r.text


def _same_results(ra, rb):
    assert ra.status_code == rb.status_code == 200, (ra.text, rb.text)
    a, b = ra.json(), rb.json()
    assert [x["id"] for x in a["results"]] == [x["id"] for x in b["results"]]
    np.testing.assert_allclose(
        [x["similarity_score"] for x in b["results"]],
        [x["similarity_score"] for x in a["results"]],
        rtol=0,
        atol=1e-5,
    )
    return a, b


@pytest.mark.parametrize(
    "mode,data,with_file",
    [
        ("text", {"query": "drill", "limit": "3"}, False),
        ("image", {"limit": "3"}, True),
        ("multimodal", {"query": "drill", "weight_image": "0.3", "limit": "4"}, True),
        ("multimodal", {"query": "drill", "enhance_with_caption": "true", "limit": "4"}, True),
    ],
    ids=["text", "image", "multimodal", "multimodal-enhanced"],
)
def test_unified_search_dispatch_equals_jax(apps, mode, data, with_file):
    _fill(apps)
    ja, pa = apps
    files = {"file": ("q.png", _png(2), "image/png")} if with_file else None
    a, b = _same_results(ja.post("/search", data=data, files=files), pa.post("/search", data=data, files=files))
    assert a["mode"] == b["mode"] == mode


def test_enhanced_query_is_the_captioned_text(apps):
    _fill(apps)
    _, pa = apps
    files = {"file": ("q.png", _png(2), "image/png")}
    got = pa.post("/search", data={"query": "drill", "enhance_with_caption": "1", "limit": "4"}, files=files)
    want = pa.post(
        "/api/search/multimodal",
        data={"query": "drill. a power drill on a table", "limit": "4"},
        files=files,
    )
    assert [x["id"] for x in got.json()["results"]] == [x["id"] for x in want.json()["results"]]
    plain = pa.post("/search", data={"query": "drill", "limit": "4"}, files=files)
    assert plain.json()["results"] != got.json()["results"]


def test_unified_search_needs_an_input(apps):
    ja, pa = apps
    for data in ({}, {"query": "   "}):
        ra, rb = ja.post("/search", data=data), pa.post("/search", data=data)
        assert ra.status_code == rb.status_code == 422 and ra.json() == rb.json()
    files = {"query": ("q.txt", b"x", "text/plain")}
    assert pa.post("/search", files=files).status_code == ja.post("/search", files=files).status_code == 422


def _normalised_samples(body):
    body = dict(body)
    rows = []
    for r in body.pop("results"):
        r = dict(r)
        if r["status"] == "error":
            r["error"] = "<decode error>"  # the decoders word it differently
        md = r.pop("metadata", None)
        if md is not None:
            r["metadata"] = {k: v for k, v in md.items() if k not in ("created_at", "processed_url")}
        rows.append(r)
    body["results"] = sorted(rows, key=lambda r: r["filename"])
    return body


def test_upload_samples_equals_jax(apps, tmp_path, monkeypatch):
    ja, pa = apps
    samples = tmp_path / "samples"
    samples.mkdir()
    for i in range(6):
        (samples / f"s{i}.png").write_bytes(_png(10 + i))
    (samples / "s6_dup.png").write_bytes(_png(10))  # a duplicate of s0
    (samples / "zz_broken.png").write_bytes(b"not an image")
    monkeypatch.setenv("IMATCH_SAMPLES_DIR", str(samples))
    first = [c.post("/upload-samples") for c in apps]
    assert first[0].status_code == first[1].status_code == 200
    a, b = (_normalised_samples(r.json()) for r in first)
    assert a == b
    assert (b["total"], b["successful"], b["skipped"], b["failed"]) == (8, 6, 1, 1)
    again = [_normalised_samples(c.post("/upload-samples").json()) for c in apps]
    assert again[0] == again[1] and again[1]["skipped"] == 7
    monkeypatch.setenv("IMATCH_SAMPLES_DIR", str(tmp_path / "nope"))
    ra, rb = ja.post("/upload-samples"), pa.post("/upload-samples")
    assert ra.status_code == rb.status_code == 404 and ra.json() == rb.json()


def _drive(client, folder):
    """The same requests on either app."""
    _fill([client], n=3)
    client.post("/api/upload-folder", files=folder)
    client.post("/api/search/text", data={"query": "anything", "limit": "3"})
    client.post("/api/search/text", data={"query": "anything", "limit": "3"})  # a cache hit
    client.post("/api/search/batch", json={"queries": ["a", "b"], "limit": 2})
    client.post("/api/search/image", files={"file": ("q.png", _png(1), "image/png")})
    return client.get("/api/metrics").json()


# timers the port adds on its search path (utils/metrics.py: spans)
PORT_SPANS = {"embed.wait", "embed.tokenize", "index.fetch", "index.rows", "search.rows"}


def test_metrics_have_jax_keys(apps):
    ja, pa = apps
    folder = [("files", (f"f{i}.png", _png(20 + i, 32, 32), "image/png")) for i in range(9)]
    JAX_METRICS.reset()
    want = _drive(ja, folder)
    METRICS.reset()
    got = _drive(pa, folder)
    assert set(got) == set(want) == {"uptime_s", "counters", "timings", "index_count", "index"}
    assert set(got["counters"]) == set(want["counters"])
    # every JAX timer, and beside them exactly the port's own spans
    assert set(want["timings"]) <= set(got["timings"])
    assert set(got["timings"]) - set(want["timings"]) == PORT_SPANS
    for name in ("index.query", "index.dispatch", "embed.text", "embed.image", "ingest.fused", "ingest.add"):
        assert got["timings"][name]["count"] == want["timings"][name]["count"], name
    assert got["counters"] == want["counters"]
    assert got["index_count"] == want["index_count"] == 12
    assert got["index"]["live"] == got["index_count"]
    assert got["index"]["engine"] == "tilemax" and "score_dtype" in got["index"]
    common = {"coalescing", "pending_host_syncs", "patched_mutations", "journal_ops", "device_ready"}
    assert common <= set(got["index"]) & set(want["index"])


def test_profile_start_stop_409(apps, tmp_path):
    _, pa = apps
    d = str(tmp_path / "trace")
    r = pa.post("/api/profile/start", data={"log_dir": d})
    assert r.status_code == 200 and r.json() == {"success": True, "trace_dir": d}
    r2 = pa.post("/api/profile/start", data={"log_dir": d})
    assert r2.status_code == 409 and "already active" in r2.json()["error"]
    pa.post("/api/search/text", data={"query": "traced"})
    r3 = pa.post("/api/profile/stop")
    assert r3.status_code == 200 and r3.json()["trace_dir"] == d
    r4 = pa.post("/api/profile/stop")
    assert r4.status_code == 409 and r4.json() == {"success": False, "error": "no active trace"}
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"embed.wait", "embed.tokenize", "embed.text", "index.query"} <= spans


def test_ui_pages_byte_identical(apps):
    ja, pa = apps
    for path in ("/", "/manage"):
        ra, rb = ja.get(path), pa.get(path)
        assert ra.status_code == rb.status_code == 200
        assert rb.headers["content-type"] == ra.headers["content-type"]
        assert rb.content == ra.content


def _route_table(app):
    return sorted((m, pattern.pattern) for m, pattern, _, _ in app._routes)


def test_route_tables_equal_and_nothing_answers_501(apps):
    ja, pa = apps
    table = _route_table(pa.app)
    assert table == _route_table(ja.app)
    assert len(table) == 25
    assert not hasattr(app_mod, "_LATER_ROUTES")
    for method, pattern in table:
        if pattern == "^/api/profile/start$":
            continue  # would leave a trace running; test_profile_start_stop_409
        path = pattern.strip("^$").replace("(?P<image_id>[^/]+)", "x").replace("(?P<filter_query>[^/]+)", "x")
        r = pa.request(method, path)
        assert r.status_code != 501, (method, path, r.text)


def test_warmup_runs_in_background_and_changes_nothing(tmp_path, embedders, monkeypatch):
    monkeypatch.setenv("IMATCH_WARMUP", "1")
    _, port_emb = embedders
    state = AppState(root=str(tmp_path), embedder=port_emb, captioner=FakeCaptioner(), device="cpu")
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((40, port_emb.dim)).astype(np.float32)
    state.store.add([f"r{i}" for i in range(40)], rows / np.linalg.norm(rows, axis=1, keepdims=True))
    state.store.set_coalescing(True)
    journal_ops = state.store.stats()["journal_ops"]
    seen = []
    orig = state.store._run_engine
    state.store._run_engine = lambda q, dc, k: seen.append((q.shape[0], k)) or orig(q, dc, k)
    done = threading.Event()
    warm = app_mod._warmup
    monkeypatch.setattr(app_mod, "_warmup", lambda st: (warm(st), done.set()))
    create_app(state)
    assert done.wait(120), "the warmup did not finish"
    # every k bucket at Q = 1, one search, the Q = 16 batch, the coalescer's buckets
    assert {(1, k) for k in (1, 16, 64)} <= set(seen)
    assert {(q, 16) for q in (2, 4, 8, 16)} <= set(seen)
    assert state.store.count() == 40 and state.store.stats()["journal_ops"] == journal_ops == 40
    state.store.set_coalescing(False)
