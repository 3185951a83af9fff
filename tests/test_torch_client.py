"""The port's typed client (imatch_tpu_torch/client.py) over a real socket,
against the port's app served by its own HTTP server in a thread, on the
CPU; every frame is made here.

- ``test_client_full_flow``: tests/test_client.py's flow on the port
  (health, an upload and its 409 as ``duplicate``, the batched and the
  sequential folder uploads, every search route, metadata, a filter
  back-filled and deleted, metrics, a 404 as ``ApiError``, reset).
- tests/test_client.py:165-200: a chunked body is a 501, a filter whose
  text holds a ``/`` round-trips, UTF-8 and quote filenames survive.
- tests/test_concurrency.py:81: uploads, searches, metadata edits and a
  filter back-fill interleaved on one live server.
- Parity: one sequence of client calls against the JAX app and the
  port's app, with the same weights, gives the same ids, status codes and
  JSON keys.
"""

import asyncio
import contextlib
import socket
import threading
import time

import jax
import numpy as np
import pytest
from PIL import Image

from imatch_tpu.models.clip.configs import TINY as JAX_TINY
from imatch_tpu.models.clip.model import init_params
from imatch_tpu.pipeline.embedder import ClipEmbedder as JaxEmbedder
from imatch_tpu.pipeline.state import AppState as JaxState
from imatch_tpu.serving.app import create_app as jax_create_app
from imatch_tpu.serving.server import serve_async as jax_serve_async
from imatch_tpu_torch.client import ApiError, ImageMatchClient
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
from imatch_tpu_torch.pipeline.state import AppState
from imatch_tpu_torch.serving.app import create_app
from imatch_tpu_torch.serving.server import serve_async


class FakeCaptioner:
    available = True

    def encode_image(self, image_np):
        return {"feat": np.asarray(image_np, np.float32).mean(axis=(0, 1))}

    def caption(self, encoded):
        return {"caption": "a drill"}

    def query(self, encoded, question):
        return {"answer": "Yes"}


class SlowFakeCaptioner(FakeCaptioner):
    """Sleeps a little to widen race windows."""

    def encode_image(self, image_np):
        time.sleep(0.002)
        return super().encode_image(image_np)

    def query(self, encoded, question):
        time.sleep(0.002)
        return super().query(encoded, question)


@contextlib.contextmanager
def served(app, serve=serve_async):
    """``app`` on a free localhost port, in a thread with its own loop."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        task = loop.create_task(serve(app, "127.0.0.1", port))
        try:
            loop.run_forever()
        finally:
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                loop.run_until_complete(task)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    for _ in range(200):
        try:
            with socket.create_connection(("127.0.0.1", port), 0.2):
                break
        except OSError:
            time.sleep(0.05)
    try:
        yield ImageMatchClient(f"http://127.0.0.1:{port}", timeout=120)
    finally:
        loop.call_soon_threadsafe(loop.stop)
        t.join(timeout=10)


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, init_params(jax.random.key(0), JAX_TINY))


def _port_state(root, tree, captioner=FakeCaptioner):
    return AppState(
        root=str(root),
        embedder=ClipEmbedder(config=TINY, params=tree, device="cpu"),
        captioner=captioner(),
        device="cpu",
    )


@pytest.fixture(scope="module")
def server(tmp_path_factory, tree):
    with served(create_app(_port_state(tmp_path_factory.mktemp("client_srv"), tree))) as client:
        yield client


def _frame(seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * (seed + 1) % 256, yy * (7 - seed % 5) % 256, (xx ^ yy) * seed % 256], -1)
    return np.clip(base + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)


def _file(tmp_path, seed, name=None, fmt="PNG", ext=".png"):
    p = tmp_path / (name or f"frame{seed}{ext}")
    Image.fromarray(_frame(seed)).save(p, fmt)
    return str(p)


def test_client_full_flow(server, tmp_path):
    c = server
    assert c.health()["status"] == "ok"
    red = _file(tmp_path, 1, "red drill.png")
    r = c.upload(red, description="a red drill")
    assert r["success"] and not r.get("duplicate")
    img_id = r["metadata"]["id"]
    assert c.upload(red).get("duplicate")  # a 409, classified, not raised

    res = c.upload_folder_batched([_file(tmp_path, 2, "match.jpg", "JPEG", ".jpg"), red])
    assert res["successful"] == 1 and res["skipped"] == 1

    seen = []
    out = c.upload_folder(
        [_file(tmp_path, 3, "not match.webp", "WEBP", ".webp")],
        on_progress=lambda i, n, e: seen.append((i, n, e["status"])),
    )
    assert out[0]["status"] == "success" and seen == [(1, 1, "success")]

    hits = c.search_text("red drill", limit=5)
    assert len(hits) >= 1 and "similarity_score" in hits[0]
    rows = c.search_text_batch(["red drill", "banana"], limit=5)
    assert len(rows) == 2 and [x["id"] for x in rows[0]] == [x["id"] for x in hits]
    hits = c.search_image(red, limit=3)
    assert hits[0]["id"] == img_id  # self-match first
    rows = c.search_image_batch([red, _file(tmp_path, 4, "orange.webp", "WEBP", ".webp")], limit=3)
    assert len(rows) == 2 and [x["id"] for x in rows[0]] == [x["id"] for x in hits]
    assert c.search_multimodal(red, "drill", weight_image=0.7, limit=3)

    assert any(i["id"] == img_id for i in c.images())
    assert c.image(img_id)["id"] == img_id
    c.update_metadata(img_id, "edited")
    assert c.image(img_id)["description"] == "edited"

    c.add_filter("is it red")
    assert "is it red" in c.filters()
    assert c.wait_for_filter("is it red", poll_s=0.05, timeout_s=30)["status"] == "completed"
    assert c.search_text("red drill", filters=["is it red"], limit=5)  # every answer is Yes
    c.delete_filter("is it red")
    assert "is it red" not in c.filters()

    assert "timings" in c.metrics()
    with pytest.raises(ApiError) as ei:
        c.image("img_nope")
    assert ei.value.status == 404
    c.reset()
    assert c.images() == []


def test_chunked_transfer_rejected(server):
    """A chunked body is refused (501) rather than desyncing keep-alive."""
    host, port = server.base_url.split("//")[1].split(":")
    with socket.create_connection((host, int(port)), timeout=10) as s:
        s.sendall(
            b"POST /api/filters HTTP/1.1\r\n"
            b"Host: x\r\nTransfer-Encoding: chunked\r\n\r\n"
            b"5\r\nhello\r\n0\r\n\r\n"
        )
        resp = s.recv(4096)
    assert b"501" in resp.split(b"\r\n")[0]


def test_client_filter_with_slash_roundtrip(server):
    """``delete_filter`` percent-encodes ``/`` (encodeURIComponent);
    a raw slash would be a path separator and 404."""
    server.add_filter("indoor/outdoor scene")
    assert "indoor/outdoor scene" in server.filters()
    server.delete_filter("indoor/outdoor scene")
    assert "indoor/outdoor scene" not in server.filters()


def test_client_unicode_and_quote_filenames_roundtrip(server, tmp_path):
    """UTF-8 filenames arrive exactly, quotes as %22 (browser-style), with
    no truncation and no backslash."""
    p = tmp_path / 'café "q".png'
    Image.fromarray(np.random.default_rng(77).integers(0, 256, (24, 24, 3), np.uint8)).save(p)
    out = server.upload(str(p))
    assert out["success"] is True
    got = out["metadata"]["filename"]
    assert "café" in got and "%22q%22" in got and "\\" not in got


def test_interleaved_operations(tmp_path, tree):
    state = _port_state(tmp_path / "live", tree, SlowFakeCaptioner)
    n = 12
    paths = []
    for i in range(n):
        p = tmp_path / f"img_{i}.png"
        Image.fromarray(np.random.default_rng(i).integers(0, 256, (24 + i % 5, 32, 3), np.uint8)).save(p)
        paths.append(str(p))
    errors, uploaded_ids = [], []
    id_lock = threading.Lock()
    with served(create_app(state)) as client:

        def uploader(lo, hi):
            try:
                for i in range(lo, hi):
                    r = client.upload(paths[i])
                    with id_lock:
                        uploaded_ids.append(r["metadata"]["id"])
            except Exception as e:
                errors.append(("upload", e))

        def searcher():
            try:
                for _ in range(10):
                    client.search_text("anything", limit=5)
            except Exception as e:
                errors.append(("search", e))

        def filterer():
            try:
                client.add_filter("is it a thing")
                client.wait_for_filter("is it a thing", poll_s=0.05, timeout_s=60)
            except Exception as e:
                errors.append(("filter", e))

        def editor():
            try:
                for _ in range(10):
                    with id_lock:
                        ids = list(uploaded_ids)
                    if ids:
                        client.update_metadata(ids[0], "concurrent edit")
                    time.sleep(0.01)
            except Exception as e:
                errors.append(("edit", e))

        threads = [
            threading.Thread(target=uploader, args=(0, n // 2)),
            threading.Thread(target=uploader, args=(n // 2, n)),
            threading.Thread(target=searcher),
            threading.Thread(target=filterer),
            threading.Thread(target=editor),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "worker hung"
        assert not errors, errors
        assert len(client.images()) == len(set(uploaded_ids)) == n
        assert state.store.count() == n


# -- parity: one client sequence against both apps -----------------------------


def _shape(x):
    """The JSON keys of a response, recursively (list entries by their
    first element's keys)."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in sorted(x.items())}
    if isinstance(x, list):
        return [_shape(x[0])] if x else []
    return type(x).__name__


def _sequence(c, files):
    """Run the client calls; each step's record holds what must agree:
    ids, statuses and the responses' keys."""
    out = []

    def step(name, fn, ids=lambda r: None):
        try:
            r = fn()
            out.append((name, 200, ids(r), _shape(r)))
        except ApiError as e:
            out.append((name, e.status, None, _shape(e.body)))
        return out[-1]

    step("health", c.health)
    first = step("upload", lambda: c.upload(files[0], description="one"), lambda r: r["metadata"]["id"])[2]
    step("upload again", lambda: c.upload(files[0]), lambda r: (r.get("duplicate"), r["metadata"]["id"]))
    step(
        "folder",
        lambda: c.upload_folder_batched(files[1:] + files[:1]),
        lambda r: [(e["filename"], e["status"], e.get("id")) for e in r["results"]],
    )
    hit_ids = lambda rows: sorted(h["id"] for h in rows)  # noqa: E731
    step("text", lambda: c.search_text("a red drill", limit=3), hit_ids)
    step("image", lambda: c.search_image(files[2], limit=1), lambda r: [h["id"] for h in r])
    step("multimodal", lambda: c.search_multimodal(files[2], "drill", limit=4), hit_ids)
    step("text batch", lambda: c.search_text_batch(["a", "b"], limit=4), lambda r: [hit_ids(x) for x in r])
    step("image batch", lambda: c.search_image_batch(files[:2], limit=1), lambda r: [[h["id"] for h in x] for x in r])
    step("image", lambda: c.image(first), lambda r: r["id"])
    step("edit", lambda: c.update_metadata(first, "edited"))
    step("add filter", lambda: c.add_filter("indoor/outdoor"))
    step("filters", c.filters, sorted)
    step("delete filter", lambda: c.delete_filter("indoor/outdoor"))
    step("missing", lambda: c.image("img_nope"))
    step("reset", c.reset)
    step("images", c.images, lambda r: r)
    return out


def test_same_client_sequence_gives_the_same_answers(tmp_path, tree):
    files = [_file(tmp_path, s) for s in range(4)]
    jax_state = JaxState(
        root=str(tmp_path / "jax"), embedder=JaxEmbedder(config=JAX_TINY), captioner=FakeCaptioner()
    )
    with served(jax_create_app(jax_state), jax_serve_async) as c:
        want = _sequence(c, files)
    with served(create_app(_port_state(tmp_path / "port", tree))) as c:
        got = _sequence(c, files)
    assert [s[0] for s in got] == [s[0] for s in want]
    for g, w in zip(got, want):
        assert g == w, (g, w)
