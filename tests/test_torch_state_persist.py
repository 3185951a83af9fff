"""The port's app state survives a restart, as the JAX app's does.

Both ``AppState``s run with the ``NullCaptioner`` and the same TINY
weights (as tests/test_torch_slice.py), the port on ``device="cpu"``, on
images made here. The shape of tests/test_pipeline.py:123-146 on both
packages: ingest, snapshot, a new state on the same root serves the same
images and answers; reset empties the store, the mirror and the image
directory. Then both apps over httpx: ``PUT /api/metadata/{id}`` (200,
404, 422) and ``POST /api/reset`` answer the same JSON, the edit and the
reset persist across a restart, and the restarted apps serve the same
search results as before.
"""

import asyncio
import io
import os

import httpx
import jax
import numpy as np
import pytest
from PIL import Image

from imatch_tpu.models.clip.configs import TINY as JAX_TINY
from imatch_tpu.models.clip.model import init_params
from imatch_tpu.pipeline.captioner import NullCaptioner as JaxNullCaptioner
from imatch_tpu.pipeline.embedder import ClipEmbedder as JaxEmbedder
from imatch_tpu.pipeline.ingest import process_batch as jax_process_batch
from imatch_tpu.pipeline.search import search_by_image as jax_search_by_image
from imatch_tpu.pipeline.state import AppState as JaxState
from imatch_tpu.serving.app import create_app as jax_create_app
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.pipeline.captioner import NullCaptioner
from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
from imatch_tpu_torch.pipeline.ingest import process_batch
from imatch_tpu_torch.pipeline.search import search_by_image
from imatch_tpu_torch.pipeline.state import AppState
from imatch_tpu_torch.serving.app import create_app

N_IMAGES = 3
PKGS = ("jax", "torch")


@pytest.fixture(scope="module")
def embedders():
    tree = jax.tree.map(np.asarray, init_params(jax.random.key(0), JAX_TINY))
    return {
        "jax": JaxEmbedder(config=JAX_TINY),
        "torch": ClipEmbedder(config=TINY, params=tree, device="cpu"),
    }


def _state(pkg, root, embedders, **kw):
    if pkg == "jax":
        return JaxState(root=root, embedder=embedders["jax"], captioner=JaxNullCaptioner(), **kw)
    return AppState(root=root, embedder=embedders["torch"], captioner=NullCaptioner(), device="cpu", **kw)


def _frame(seed, h=40, w=56):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * (seed + 3) % 256, yy * (5 + seed) % 256, (xx + yy) * seed % 256], -1)
    return np.clip(base + rng.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)


def _png(seed):
    buf = io.BytesIO()
    Image.fromarray(_frame(seed)).save(buf, "PNG")
    return buf.getvalue()


@pytest.mark.parametrize("pkg", PKGS)
def test_autoload_off_starts_empty(tmp_path, embedders, pkg):
    root = str(tmp_path / pkg)
    state = _state(pkg, root, embedders)
    frames = [_frame(i) for i in range(2)]
    (jax_process_batch if pkg == "jax" else process_batch)(state, frames, ["a.png", "b.png"])
    state.snapshot(force=True)
    assert _state(pkg, root, embedders).store.count() == 2
    assert _state(pkg, root, embedders, autoload=False).store.count() == 0
    assert os.path.isdir(os.path.join(root, "index_data"))


def test_persistence_roundtrip(tmp_path, embedders):
    hits = {}
    frames = [_frame(i) for i in range(N_IMAGES)]
    names = [f"f{i}.png" for i in range(N_IMAGES)]
    for pkg in PKGS:
        root = str(tmp_path / pkg)
        state = _state(pkg, root, embedders)
        (jax_process_batch if pkg == "jax" else process_batch)(state, frames[:2], names[:2])
        state.snapshot()

        state2 = _state(pkg, root, embedders)
        assert state2.store.count() == 2
        assert len(state2.image_metadata) == 2
        assert state2.image_metadata == state.image_metadata
        search = jax_search_by_image if pkg == "jax" else search_by_image
        found = search(state2, Image.fromarray(frames[0]), limit=2)
        assert found[0]["filename"] == names[0]
        hits[pkg] = [(h["id"], h["similarity_score"]) for h in found]
    assert [i for i, _ in hits["jax"]] == [i for i, _ in hits["torch"]]
    np.testing.assert_allclose([s for _, s in hits["torch"]], [s for _, s in hits["jax"]], atol=1e-5)


@pytest.mark.parametrize("pkg", PKGS)
def test_reset(tmp_path, embedders, pkg):
    root = str(tmp_path / pkg)
    state = _state(pkg, root, embedders)
    (jax_process_batch if pkg == "jax" else process_batch)(state, [_frame(i) for i in range(2)], ["a.png", "b.png"])
    assert os.listdir(state.processed_dir)
    state.reset()
    assert state.store.count() == 0
    assert state.image_metadata == {}
    assert os.listdir(state.processed_dir) == []
    # the reset is durable: a snapshot of nothing, no journal left
    assert not os.path.exists(os.path.join(state.data_dir, "journal.jsonl"))
    again = _state(pkg, root, embedders)
    assert again.store.count() == 0 and again.image_metadata == {}


class _Client:
    def __init__(self, app):
        self._c = httpx.AsyncClient(transport=httpx.ASGITransport(app=app), base_url="http://t")

    def request(self, method, url, **kw):
        return asyncio.run(self._c.request(method, url, **kw))


def _apps(tmp_path, embedders):
    return {pkg: _Client((jax_create_app if pkg == "jax" else create_app)(_state(pkg, str(tmp_path / pkg), embedders))) for pkg in PKGS}


# the app's root directory and the upload time differ between the two apps
_OWN = ("processed_url", "created_at", "similarity_score")


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in _OWN}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _same(responses):
    a, b = responses["jax"], responses["torch"]
    assert a.status_code == b.status_code, (a.text, b.text)
    assert _strip(a.json()) == _strip(b.json())
    return b


def _both(apps, method, url, **kw):
    return _same({pkg: c.request(method, url, **kw) for pkg, c in apps.items()})


def _search(apps, seed):
    files = {"file": ("q.png", _png(seed), "image/png")}
    r = _both(apps, "POST", "/api/search/image", files=files, data={"limit": 3})
    return [(x["id"], x["similarity_score"]) for x in r.json()["results"]]


def test_metadata_and_reset_routes_persist(tmp_path, embedders):
    apps = _apps(tmp_path, embedders)
    ids = []
    for seed in range(N_IMAGES):
        r = _both(apps, "POST", "/api/upload", files={"file": (f"i{seed}.png", _png(seed), "image/png")},
                  data={"description": f"image {seed}", "custom_metadata": "cm"})
        ids.append(r.json()["metadata"]["id"])
    before = _search(apps, 1)

    r = _both(apps, "PUT", f"/api/metadata/{ids[1]}", data={"description": "edited"})
    md = r.json()["metadata"]
    assert r.status_code == 200 and md["description"] == "edited" and md["custom_metadata"] is None
    assert md["filename"] == "i1.png"  # the full record, not 3 fields
    r = _both(apps, "PUT", f"/api/metadata/{ids[2]}", data={"description": "two", "custom_metadata": "x"})
    assert r.json()["metadata"]["custom_metadata"] == "x"
    assert _both(apps, "PUT", "/api/metadata/img_nope", data={"description": "d"}).status_code == 404
    assert _both(apps, "PUT", f"/api/metadata/{ids[0]}", data={"custom_metadata": "c"}).status_code == 422
    assert _both(apps, "PUT", f"/api/metadata/{ids[0]}",
                 files={"description": ("d.txt", b"desc", "text/plain")}).status_code == 422
    assert _both(apps, "PUT", f"/api/metadata/{ids[0]}", data={"description": "d"},
                 files={"custom_metadata": ("c.txt", b"c", "text/plain")}).status_code == 422

    # restart: the edit and every upload come back, the answers are the same
    apps = _apps(tmp_path, embedders)
    r = _both(apps, "GET", f"/api/image/{ids[1]}")
    assert r.json()["image"]["description"] == "edited"
    assert _both(apps, "GET", f"/api/image/{ids[0]}").json()["image"]["description"] == "image 0"
    listed = _both(apps, "GET", "/api/images").json()["images"]
    assert sorted(m["id"] for m in listed) == sorted(ids)
    after = _search(apps, 1)
    assert [i for i, _ in after] == [i for i, _ in before]
    np.testing.assert_allclose([s for _, s in after], [s for _, s in before], atol=1e-6)

    r = _both(apps, "POST", "/api/reset")
    assert r.json() == {"success": True}
    assert _both(apps, "GET", "/api/images").json() == {"images": []}
    assert _both(apps, "GET", f"/api/image/{ids[0]}").status_code == 404
    apps = _apps(tmp_path, embedders)
    assert _both(apps, "GET", "/api/images").json() == {"images": []}
    assert _both(apps, "POST", "/api/search/text", data={"query": "x"}).json() == {"results": []}
    r = _both(apps, "POST", "/api/upload", files={"file": ("i0.png", _png(0), "image/png")})
    assert r.json()["metadata"]["id"] == ids[0]  # a reset store takes the image again
