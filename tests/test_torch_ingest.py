"""Bulk ingest (``/api/upload-folder``) of the port against the JAX app.

Both ``create_app``s run with the ``NullCaptioner`` and the same TINY
weights (the JAX ``init_params(jax.random.key(0))`` tree, carried across
to the port), once with the full-precision image tower and once with
``IMATCH_EMBED_QUANT=int8`` on both. The folder mixes two geometries (a
bucket of 11, which takes the fused device path, and a host tail of 3),
an in-batch duplicate, a duplicate of an earlier single upload, an empty
file and undecodable bytes. The same files must give the same JSON
(counts, statuses, ids, reasons), every id must be the host ``image_id``
of its frame, and the image and text searches after it the same ids
with scores within 1e-5, in both tiers (the JAX int8 tier quantizes with a
division, the port with the Pallas kernels' reciprocal multiply: codes
differ by one LSB at a few rounding boundaries).
"""

import asyncio
import io
import re

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
from imatch_tpu_torch.models.clip.quant import EncoderW8A8
from imatch_tpu_torch.ops.phash import image_id
from imatch_tpu_torch.pipeline.captioner import NullCaptioner
from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
from imatch_tpu_torch.pipeline.ingest import process_batch
from imatch_tpu_torch.pipeline.state import AppState
from imatch_tpu_torch.serving.app import create_app

TIERS = ["none", "int8"]
SCORE_TOL = 1e-5


class _Client:
    def __init__(self, app):
        self._c = httpx.AsyncClient(transport=httpx.ASGITransport(app=app), base_url="http://t")

    def post(self, url, **kw):
        return asyncio.run(self._c.request("POST", url, **kw))


@pytest.fixture(scope="module", params=TIERS)
def embedders(request):
    tree = jax.tree.map(np.asarray, init_params(jax.random.key(0), JAX_TINY))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMATCH_EMBED_QUANT", request.param)
        pair = JaxEmbedder(config=JAX_TINY), ClipEmbedder(config=TINY, params=tree, device="cpu")
    return request.param, pair


@pytest.fixture
def apps(tmp_path, embedders):
    tier, (jax_emb, port_emb) = embedders
    jax_app = jax_create_app(
        JaxState(root=str(tmp_path / "jax"), embedder=jax_emb, captioner=JaxNullCaptioner())
    )
    port_app = create_app(
        AppState(root=str(tmp_path / "port"), embedder=port_emb, captioner=NullCaptioner(), device="cpu")
    )
    return tier, _Client(jax_app), _Client(port_app)


def _frame(seed, h, w):
    """Smooth colour fields with a little noise: photo-like, so the device
    hashes clear their margin."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    f = rng.uniform(1.0, 5.0, (3, 2))
    ph = rng.uniform(0, 6.3, 3)
    img = np.stack(
        [np.sin(f[c, 0] * np.pi * xx + ph[c]) * np.cos(f[c, 1] * np.pi * yy) for c in range(3)], -1
    )
    return np.clip(img * 100 + 128 + rng.normal(0, 5, (h, w, 3)), 0, 255).astype(np.uint8)


def _png(frame):
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "PNG")
    return buf.getvalue()


def _folder():
    """(multipart files, frame of each decodable file or None)."""
    big = [_frame(s, 60, 80) for s in range(10)]
    tail = [_frame(100 + s, 50, 50) for s in range(3)]
    entries = [(f"a{s}.png", _png(f), f) for s, f in enumerate(big)]
    entries.insert(4, ("a2_again.png", _png(big[2]), big[2]))  # in-batch duplicate
    entries.insert(7, ("empty.png", b"", None))
    entries += [(f"b{s}.png", _png(f), f) for s, f in enumerate(tail)]
    entries.insert(9, ("broken.png", b"not an image at all", None))
    files = [("files", (name, data, "image/png")) for name, data, _ in entries]
    return files, {name: f for name, _, f in entries}, big


def _normalised(body):
    """The reasons of undecodable files name a BytesIO object's address."""
    return re.sub(r"0x[0-9a-f]+", "0x", str(body))


def test_upload_folder_same_json_and_searches(apps):
    _, ja, pa = apps
    files, frames, big = _folder()
    for c in (ja, pa):  # a0 is then a duplicate of an earlier upload
        r = c.post("/api/upload", files={"file": ("first.png", _png(big[0]), "image/png")})
        assert r.status_code == 200, r.text
    failures = process_batch.stream_failures
    ra, rb = (c.post("/api/upload-folder", files=files) for c in (ja, pa))
    assert ra.status_code == rb.status_code == 200
    a, b = ra.json(), rb.json()
    assert _normalised(a) == _normalised(b)
    assert (b["total"], b["successful"], b["skipped"], b["failed"]) == (16, 12, 3, 1)
    assert process_batch.stream_failures == failures  # the fused path was taken
    by_name = {r["filename"]: r for r in b["results"]}
    assert by_name["empty.png"] == {"filename": "empty.png", "status": "skipped", "reason": "Empty file"}
    assert by_name["broken.png"]["status"] == "error"
    assert by_name["broken.png"]["reason"].startswith("Cannot open image:")
    assert by_name["a0.png"]["status"] == "skipped" and by_name["a2_again.png"]["status"] == "skipped"
    for name, frame in frames.items():
        if frame is not None:
            assert by_name[name]["id"] == image_id(Image.fromarray(frame)), name

    tol = SCORE_TOL
    query = {"file": ("q.png", _png(big[4]), "image/png")}
    ref, got = (c.post("/api/search/image", files=query, data={"limit": 0}).json()["results"] for c in (ja, pa))
    _same_ranking(ref, got, tol)
    assert got[0]["id"] == by_name["a4.png"]["id"] and got[0]["similarity_score"] > 0.999
    ref, got = (
        c.post("/api/search/text", data={"query": "a red drill", "limit": 0}).json()["results"]
        for c in (ja, pa)
    )
    _same_ranking(ref, got, tol)


def _same_ranking(ref, got, tol):
    """The same ids in the same order, up to ties within ``tol``: random
    towers map every image close to one direction, so two stored images
    can score within float rounding of each other. Each rank's score, and
    the JAX score of the id the port puts there, equal JAX's at that rank."""
    assert len(got) == len(ref) == 13
    ref_score = {r["id"]: r["similarity_score"] for r in ref}
    assert set(ref_score) == {r["id"] for r in got}
    for r_ref, r_got in zip(ref, got):
        assert abs(r_got["similarity_score"] - r_ref["similarity_score"]) <= tol
        assert abs(ref_score[r_got["id"]] - r_ref["similarity_score"]) <= tol


def test_tier_selects_the_image_tower(embedders):
    tier, (_, port_emb) = embedders
    assert isinstance(port_emb.model.vision.encoder, EncoderW8A8) == (tier == "int8")
    assert not isinstance(port_emb.model.text.encoder, EncoderW8A8)


def test_stream_matches_plain_embeddings_and_host_ids(embedders):
    """The fused stream against the embedder's plain path and the host
    ids, with a None entry and a geometry bucket split into chunks."""
    _, (_, emb) = embedders
    frames = [_frame(200 + s, 40, 56) for s in range(9)] + [None] + [_frame(300, 30, 30)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMATCH_EMBED_CHUNK", "4")  # 9 frames -> chunks of 4, 4 and 1
        chunks = list(emb.ids_and_embed_images_stream(frames, max_in_flight=2))
        ids, vecs = emb.ids_and_embed_images(frames)
    assert [list(c[0]) for c in chunks] == [[0, 1, 2, 3], [4, 5, 6, 7], [8], [10]]
    assert ids[9] is None and not vecs[9].any()
    live = [i for i, f in enumerate(frames) if f is not None]
    assert [ids[i] for i in live] == [image_id(Image.fromarray(frames[i])) for i in live]
    want = emb.embed_images([frames[i] for i in live])
    np.testing.assert_allclose(vecs[live], want, atol=1e-5, rtol=0)


def test_quant_setting_is_validated(monkeypatch):
    monkeypatch.setenv("IMATCH_EMBED_QUANT", "int4")
    with pytest.raises(ValueError, match="IMATCH_EMBED_QUANT"):
        ClipEmbedder(config=TINY, device="cpu")
    monkeypatch.delenv("IMATCH_EMBED_QUANT")
    emb = ClipEmbedder(config=TINY, device="cpu", quant=" INT8 ")
    assert emb.quant == "int8" and isinstance(emb.model.vision.encoder, EncoderW8A8)
