"""U²-Net background removal (imatch_tpu_torch/models/u2net) against the JAX
package, on the CPU.

Weights: JAX's ``init_u2_params(jax.random.key(0), cfg)`` as numpy, loaded
by ``u2_params_from_numpy``; both packages compute in fp32. Bounds:

- saliency (the net's sigmoid output): max abs diff <= 1e-5;
- masks: alpha within 1 LSB of JAX's, and the fp32 mask within
  ``MASK_TOL / range`` of it, where ``range`` is the saliency's max - min
  on the frame (the min-max normalisation divides by it, so a small range
  would amplify the rounding); the tests assert range >= 1e-2;
- the batch path against the single path: 1 LSB (tests/test_u2net.py:144);
- ingest and the routes against the JAX app on the same frames and
  weights: the same ids, RGBA files whose alpha is within 1 LSB, the same
  search ids with scores within 1e-5.
"""

import asyncio
import dataclasses
import io

import httpx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from imatch_tpu.models.clip.configs import TINY as JAX_TINY
from imatch_tpu.models.clip.model import init_params
from imatch_tpu.models.u2net import configs as jax_configs
from imatch_tpu.models.u2net.convert import convert_u2_state_dict as jax_convert
from imatch_tpu.models.u2net.model import init_u2_params, u2net_forward
from imatch_tpu.models.u2net.runtime import U2NetSegmenter as JaxSegmenter
from imatch_tpu.pipeline.captioner import NullCaptioner as JaxNullCaptioner
from imatch_tpu.pipeline.embedder import ClipEmbedder as JaxEmbedder
from imatch_tpu.pipeline.ingest import process_batch as jax_process_batch
from imatch_tpu.pipeline.ingest import process_image as jax_process_image
from imatch_tpu.pipeline.state import AppState as JaxState
from imatch_tpu.serving.app import create_app as jax_create_app
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.models.u2net import configs
from imatch_tpu_torch.models.u2net.bridge import init_random, u2_params_from_numpy
from imatch_tpu_torch.models.u2net.convert import convert_u2_state_dict, load_u2_checkpoint
from imatch_tpu_torch.models.u2net.model import U2Net
from imatch_tpu_torch.models.u2net.runtime import U2NetSegmenter, get_segmenter
from imatch_tpu_torch.ops.phash import image_id
from imatch_tpu_torch.pipeline.captioner import NullCaptioner
from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
from imatch_tpu_torch.pipeline.ingest import process_batch, process_image
from imatch_tpu_torch.pipeline.state import AppState
from imatch_tpu_torch.serving.app import create_app

SALIENCY_TOL = 1e-5
MASK_TOL = 4e-5  # over the saliency's range on the frame
MIN_RANGE = 1e-2
SCORE_TOL = 1e-5


def _tree(name):
    return jax.tree.map(np.array, init_u2_params(jax.random.key(0), jax_configs.get_u2_config(name)))


@pytest.fixture(scope="module")
def tiny_tree():
    return _tree("tiny-u2")


@pytest.fixture(scope="module")
def segmenters(tiny_tree):
    """(JAX's tiny-u2 segmenter, the port's on the same weights)."""
    return JaxSegmenter(config="tiny-u2"), U2NetSegmenter(config="tiny-u2", params=tiny_tree, device="cpu")


def _frame(seed, h, w):
    """Soft colour blobs on a flat ground: a frame with a salient region."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3)) + rng.uniform(40, 200, 3)
    for _ in range(4):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(0.1, 0.4) * min(h, w)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        img += blob[..., None] * rng.uniform(-120, 120, 3)
    return np.clip(img + rng.normal(0, 4, (h, w, 3)), 0, 255).astype(np.uint8)


def _saliency_range(seg, frame) -> float:
    s = seg.model(seg._model_inputs_batch([frame]))
    return float(s.max() - s.min())


def test_configs_equal_field_by_field():
    assert sorted(configs.U2_CONFIGS) == sorted(jax_configs.U2_CONFIGS)
    for name, cfg in configs.U2_CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_configs.get_u2_config(name))
        assert configs.get_u2_config(name) is cfg


@pytest.mark.parametrize(
    "name,shape",
    [("tiny-u2", (2, 64, 64)), ("tiny-u2", (1, 52, 76)), ("u2netp", (1, 64, 64))],
    ids=["tiny-64", "tiny-52x76-ceil-pool", "u2netp-64"],
)
def test_forward_matches_jax(name, shape):
    """fp32 saliency; 52x76 pools to 26x38, 13x19, 7x10, 4x5, 2x3 and
    upsamples back through the non-integer 7 -> 13 and 4 -> 7."""
    tree = _tree(name)
    cfg = configs.get_u2_config(name)
    model = u2_params_from_numpy(tree, cfg)
    x = np.random.default_rng(0).standard_normal(shape + (3,)).astype(np.float32)
    got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    want = np.asarray(u2net_forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jax_configs.get_u2_config(name)))
    assert got.shape == want.shape == shape and got.dtype == np.float32
    assert float(want.max() - want.min()) > 0.5  # a saliency that varies
    np.testing.assert_allclose(got, want, rtol=0, atol=SALIENCY_TOL)


def test_modules_carry_the_released_names():
    model = U2Net(configs.TINY_U2)
    keys = set(model.state_dict())
    for k in ("stage1.rebnconvin.conv_s1.weight", "stage1.rebnconv3.bn_s1.running_var",
              "stage1.rebnconv2d.conv_s1.bias", "stage5d.rebnconv1d.bn_s1.weight",
              "stage6.rebnconv3.conv_s1.weight", "side6.weight", "outconv.bias"):
        assert k in keys, k
    assert model.stage5.rebnconv3.dilation == 4 and model.stage5.rebnconv2d.dilation == 2  # RSU-4F
    assert model.stage1.rebnconv3.dilation == 2 and model.stage1.rebnconv1d.dilation == 1  # RSU-L


@pytest.mark.parametrize("hw", [(50, 70), (400, 300)], ids=["downsample-mask", "upsample-mask"])
def test_segmenter_matches_jax(segmenters, hw):
    """The 64x64 mask goes back to a smaller (antialiased) and a larger
    frame."""
    jseg, pseg = segmenters
    frame = _frame(sum(hw), *hw)
    rng = _saliency_range(pseg, frame)
    assert rng >= MIN_RANGE, rng
    got, want = pseg.predict_mask(frame), jseg.predict_mask(frame)
    assert got.shape == hw and got.dtype == np.float32
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=MASK_TOL / rng)
    cut, jcut = pseg.remove_background(frame), jseg.remove_background(frame)
    assert cut.shape == hw + (4,) and cut.dtype == np.uint8
    np.testing.assert_array_equal(cut[..., :3], frame)  # RGB preserved
    assert np.abs(cut[..., 3].astype(int) - jcut[..., 3].astype(int)).max() <= 1
    gray = pseg.remove_background(frame[..., 0])  # a grayscale frame stacks to RGB
    assert gray.shape == hw + (4,)


def test_remove_background_batch_bucketed_dispatch(segmenters, monkeypatch):
    """tests/test_u2net.py:144 on the port: one forward per geometry
    bucket, padded to a power of two, each frame within 1 LSB of the
    single path and of JAX's batch."""
    jseg, pseg = segmenters
    imgs = [_frame(30 + i, 40, 48) for i in range(3)] + [_frame(40 + i, 32, 32) for i in range(2)]
    calls = []
    orig = pseg.model.forward

    def counting(x):
        calls.append(tuple(x.shape))
        return orig(x)

    monkeypatch.setattr(pseg.model, "forward", counting)
    batch = pseg.remove_background_batch(imgs)
    monkeypatch.undo()
    assert [c[0] for c in calls] == [4, 2]  # two buckets, padded to pow2
    want = jseg.remove_background_batch(imgs)
    for im, rgba, jrgba in zip(imgs, batch, want):
        single = pseg.remove_background(im)
        assert rgba.shape == single.shape == im.shape[:2] + (4,)
        np.testing.assert_array_equal(rgba[..., :3], im)
        assert np.abs(rgba[..., 3].astype(int) - single[..., 3].astype(int)).max() <= 1
        assert np.abs(rgba[..., 3].astype(int) - jrgba[..., 3].astype(int)).max() <= 1


def test_batch_chunks(segmenters, monkeypatch):
    """IMATCH_U2_CHUNK=2 over five frames of one geometry: forwards of 2,
    2 and 1 (a chunk of one is not padded)."""
    _, pseg = segmenters
    monkeypatch.setenv("IMATCH_U2_CHUNK", "2")
    imgs = [_frame(50 + i, 36, 44) for i in range(5)]
    calls = []
    orig = pseg.model.forward
    monkeypatch.setattr(pseg.model, "forward", lambda x: calls.append(x.shape[0]) or orig(x))
    out = pseg.remove_background_batch(imgs)
    assert calls == [2, 2, 1] and len(out) == 5


def test_factory_modes(monkeypatch):
    monkeypatch.setenv("IMATCH_SEGMENTER", "null")
    assert get_segmenter("cpu") is None
    monkeypatch.setenv("IMATCH_SEGMENTER", "auto")
    monkeypatch.delenv("IMATCH_U2_CHECKPOINT", raising=False)
    assert get_segmenter("cpu") is None  # no checkpoint -> no segmenter
    monkeypatch.setenv("IMATCH_SEGMENTER", "u2net")
    monkeypatch.setenv("IMATCH_U2_CONFIG", "tiny-u2")
    seg = get_segmenter("cpu")
    assert isinstance(seg, U2NetSegmenter) and seg.cfg.name == "tiny-u2"
    assert seg.device.type == "cpu" and seg.dtype == torch.float32
    # seeded: the same weights at every start
    again = get_segmenter("cpu")
    for a, b in zip(seg.model.state_dict().values(), again.model.state_dict().values()):
        assert torch.equal(a, b)


def test_init_random_distribution():
    model = init_random(configs.U2NETP, seed=0)
    w = model.stage1.rebnconvin.conv_s1.weight  # fan_in 27
    std = (2 / 27) ** 0.5
    assert abs(float(w.std()) - std) < 0.15 * std and float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6
    assert not model.side1.bias.any() and bool((model.stage2.rebnconv1.bn_s1.running_var == 1).all())


def _synthetic_state_dict(cfg):
    """The released naming with random values (tests/test_u2net.py:61)."""
    rng = np.random.default_rng(1)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32)

    def cbr(sd, prefix, cin, cout):
        sd[f"{prefix}.conv_s1.weight"] = r(cout, cin, 3, 3) * np.float32((2 / (9 * cin)) ** 0.5)
        sd[f"{prefix}.conv_s1.bias"] = r(cout) * np.float32(0.1)
        sd[f"{prefix}.bn_s1.weight"] = 1 + r(cout) * np.float32(0.1)
        sd[f"{prefix}.bn_s1.bias"] = r(cout) * np.float32(0.1)
        sd[f"{prefix}.bn_s1.running_mean"] = r(cout) * np.float32(0.1)
        sd[f"{prefix}.bn_s1.running_var"] = np.abs(r(cout)) + np.float32(0.5)

    def rsu(sd, stage, L, cin, mid, cout):
        cbr(sd, f"{stage}.rebnconvin", cin, cout)
        cbr(sd, f"{stage}.rebnconv1", cout, mid)
        for i in range(2, L + 1):
            cbr(sd, f"{stage}.rebnconv{i}", mid, mid)
        for i in range(L - 1, 1, -1):
            cbr(sd, f"{stage}.rebnconv{i}d", 2 * mid, mid)
        cbr(sd, f"{stage}.rebnconv1d", 2 * mid, cout)

    sd = {}
    for i, (L, cin, mid, cout, _) in enumerate(cfg.encoder):
        rsu(sd, f"stage{i + 1}", L, cin, mid, cout)
    n = len(cfg.encoder)
    for i, (L, cin, mid, cout, _) in enumerate(cfg.decoder):
        rsu(sd, f"stage{n - 1 - i}d", L, cin, mid, cout)
    side_srcs = [cfg.decoder[-1][3]] + [d[3] for d in reversed(cfg.decoder[:-1])] + [cfg.encoder[-1][3]]
    for i, cs in enumerate(side_srcs):
        sd[f"side{i + 1}.weight"] = r(1, cs, 3, 3) * np.float32((2 / (9 * cs)) ** 0.5)
        sd[f"side{i + 1}.bias"] = r(1)
    sd["outconv.weight"] = r(1, n, 1, 1)
    sd["outconv.bias"] = r(1)
    return sd


def test_converter_synthetic_state_dict(tmp_path):
    """A state dict in the released naming: the port's converter gives
    JAX's tree exactly; it loads into the port through the bridge, through
    load_state_dict and from a saved file, and each forward equals JAX's
    on ``convert_u2_state_dict`` of the same dict."""
    cfg, jcfg = configs.TINY_U2, jax_configs.TINY_U2
    sd = _synthetic_state_dict(cfg)
    tree, jtree = convert_u2_state_dict(sd, cfg), jax_convert(sd, jcfg)
    jax.tree.map(np.testing.assert_array_equal, tree, jtree)
    x = np.random.default_rng(4).standard_normal((1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(u2net_forward(jax.tree.map(jnp.asarray, jtree), jnp.asarray(x), jcfg))
    by_state_dict = U2Net(cfg)
    by_state_dict.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    path = tmp_path / "u2.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for model in (
        u2_params_from_numpy(tree, cfg),
        by_state_dict.eval(),
        u2_params_from_numpy(load_u2_checkpoint(str(path), cfg), cfg),
    ):
        with torch.no_grad():
            got = model(xt).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=SALIENCY_TOL)
    assert float(want.max() - want.min()) > 1e-2


# -- ingest and the routes, against the JAX app -----------------------------


class _Client:
    def __init__(self, app):
        self._c = httpx.AsyncClient(transport=httpx.ASGITransport(app=app), base_url="http://t")

    def post(self, url, **kw):
        return asyncio.run(self._c.request("POST", url, **kw))


@pytest.fixture(scope="module")
def embedders():
    tree = jax.tree.map(np.asarray, init_params(jax.random.key(0), JAX_TINY))
    return JaxEmbedder(config=JAX_TINY), ClipEmbedder(config=TINY, params=tree, device="cpu")


@pytest.fixture
def states(tmp_path, embedders, segmenters, monkeypatch):
    """JAX's and the port's states, each with a tiny-u2 segmenter on the
    same weights (JAX builds its own from IMATCH_SEGMENTER=u2net)."""
    monkeypatch.setenv("IMATCH_SEGMENTER", "u2net")
    monkeypatch.setenv("IMATCH_U2_CONFIG", "tiny-u2")
    jemb, pemb = embedders
    jstate = JaxState(root=str(tmp_path / "jax"), embedder=jemb, captioner=JaxNullCaptioner())
    pstate = AppState(
        root=str(tmp_path / "port"), embedder=pemb, captioner=NullCaptioner(),
        segmenter=segmenters[1], device="cpu",
    )
    assert jstate.segmenter is not None
    return jstate, pstate


def _png(frame) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "PNG")
    return buf.getvalue()


def _alpha(path):
    arr = np.asarray(Image.open(path))
    assert arr.shape[-1] == 4, arr.shape  # an RGBA cutout was saved
    return arr


def _same_cutout(jpath, ppath, frame):
    a, b = _alpha(jpath), _alpha(ppath)
    np.testing.assert_array_equal(b[..., :3], frame)
    assert np.abs(a[..., 3].astype(int) - b[..., 3].astype(int)).max() <= 1


def _embedding(state, id_):
    return np.asarray(state.store.get(ids=[id_], include=["embeddings"])["embeddings"][0], np.float32)


def test_process_image_remove_bg_matches_jax(states):
    jstate, pstate = states
    frame = _frame(7, 44, 60)
    jmd, jnew = jax_process_image(jstate, Image.fromarray(frame), "x.png", remove_bg=True)
    pmd, pnew = process_image(pstate, Image.fromarray(frame), "x.png", remove_bg=True)
    assert jnew and pnew and pmd["id"] == jmd["id"] == image_id(Image.fromarray(frame))
    _same_cutout(jmd["processed_url"], pmd["processed_url"], frame)
    np.testing.assert_allclose(_embedding(pstate, pmd["id"]), _embedding(jstate, jmd["id"]), rtol=0, atol=1e-5)


def test_process_image_keeps_the_frame_when_the_cutout_fails(states):
    """As in JAX: the failure is logged, the original frame saved and
    embedded, the upload kept."""
    _, pstate = states

    class Broken:
        def remove_background(self, arr):
            raise RuntimeError("no cutout")

    pstate.segmenter = Broken()
    frame = _frame(8, 40, 40)
    md, is_new = process_image(pstate, Image.fromarray(frame), "y.png", remove_bg=True)
    assert is_new
    np.testing.assert_array_equal(np.asarray(Image.open(md["processed_url"])), frame)


def test_process_batch_remove_bg_matches_jax(states, segmenters, monkeypatch):
    """A folder of 9 frames of one geometry (a device bucket of
    image_ids_batch, one forward of 8 and one of 1) and 3 of another, an
    in-batch duplicate: ids equal the host image_id, RGBA files within 1
    LSB of JAX's, embeddings of the cutouts' RGB equal JAX's."""
    jstate, pstate = states
    frames = [_frame(100 + i, 40, 56) for i in range(9)] + [_frame(200 + i, 30, 30) for i in range(3)]
    arrays = frames + [frames[2]]
    names = [f"f{i}.png" for i in range(len(arrays))]
    calls = []
    seg = segmenters[1]
    orig = seg.model.forward
    monkeypatch.setattr(seg.model, "forward", lambda x: calls.append(x.shape[0]) or orig(x))
    got = process_batch(pstate, list(arrays), names, remove_bg=True)
    monkeypatch.undo()
    want = jax_process_batch(jstate, list(arrays), names, remove_bg=True)
    assert calls == [8, 1, 4]  # one forward a geometry chunk, padded to pow2
    assert [(r["status"], r.get("id")) for r in got] == [(r["status"], r.get("id")) for r in want]
    for r, jr, frame in zip(got, want, arrays):
        assert r["id"] == image_id(Image.fromarray(frame))
        if r["status"] == "success":
            _same_cutout(jr["metadata"]["processed_url"], r["metadata"]["processed_url"], frame)
            np.testing.assert_allclose(_embedding(pstate, r["id"]), _embedding(jstate, r["id"]), rtol=0, atol=1e-5)
    assert got[-1]["status"] == "skipped"


def _ranked(resp):
    """[(id, score), ...] a result row; one row for a single search."""
    assert resp.status_code == 200, resp.text
    rows = resp.json()["results"]
    rows = rows if isinstance(rows[0], list) else [rows]
    return [[(r["id"], r["similarity_score"]) for r in row] for row in rows]


def _same_results(a, b):
    ra, rb = _ranked(a), _ranked(b)
    assert [[i for i, _ in row] for row in ra] == [[i for i, _ in row] for row in rb]
    np.testing.assert_allclose(
        [s for row in rb for _, s in row], [s for row in ra for _, s in row], rtol=0, atol=SCORE_TOL
    )


def test_routes_remove_bg_match_jax(states):
    """/api/upload and /api/upload-folder with remove_bg store cutouts; the
    three query routes with remove_bg answer as JAX's."""
    jstate, pstate = states
    clients = [_Client(jax_create_app(jstate)), _Client(create_app(pstate))]
    up = _frame(300, 48, 64)
    bodies = [
        c.post("/api/upload", files={"file": ("u.png", _png(up), "image/png")}, data={"remove_bg": "true"})
        for c in clients
    ]
    assert [b.status_code for b in bodies] == [200, 200]
    jmd, pmd = (b.json()["metadata"] for b in bodies)
    assert jmd["id"] == pmd["id"]
    _same_cutout(jmd["processed_url"], pmd["processed_url"], up)
    folder = [_frame(400 + i, 36, 52) for i in range(8)] + [_frame(500, 50, 40)]
    files = [("files", (f"g{i}.png", _png(f), "image/png")) for i, f in enumerate(folder)]
    jr, pr = (c.post("/api/upload-folder", files=files, data={"remove_bg": "true"}) for c in clients)
    assert jr.status_code == pr.status_code == 200 and pr.json() == jr.json()
    assert pr.json()["successful"] == len(folder)
    for r, f in zip(pr.json()["results"], folder):
        assert r["id"] == image_id(Image.fromarray(f))
        _alpha(pstate.image_metadata[r["id"]]["processed_url"])
    q = _png(_frame(600, 40, 40))
    for url, data in (("/api/search/image", {}), ("/api/search/multimodal", {"query": "a drill"})):
        for flag in ("true", "false"):
            ra, rb = (
                c.post(url, files={"file": ("q.png", q, "image/png")}, data={"remove_bg": flag, "limit": 5, **data})
                for c in clients
            )
            _same_results(ra, rb)
    batch = [("files", (f"q{i}.png", _png(_frame(700 + i, 30 + 4 * i, 40)), "image/png")) for i in range(3)]
    ra, rb = (c.post("/api/search/image-batch", files=batch, data={"remove_bg": "true", "limit": 4}) for c in clients)
    _same_results(ra, rb)


def test_query_cutout_is_what_the_route_searches(states, monkeypatch):
    """/api/search/image with remove_bg searches the segmenter's cutout
    (its RGB); a failing segmenter searches the image as sent."""
    from imatch_tpu_torch.pipeline import search as search_mod

    _, pstate = states
    client = _Client(create_app(pstate))
    seen = []
    orig = search_mod.search_by_image
    monkeypatch.setattr(search_mod, "search_by_image", lambda st, im, limit: seen.append(np.asarray(im)) or orig(st, im, limit=limit))
    frame = _frame(800, 40, 40)
    cut = pstate.segmenter.remove_background(frame)
    assert client.post("/api/search/image", files={"file": ("q.png", _png(frame), "image/png")}, data={"remove_bg": "1"}).status_code == 200
    np.testing.assert_array_equal(seen[-1], cut[..., :3])

    class Broken:
        def remove_background(self, arr):
            raise RuntimeError("no cutout")

    pstate.segmenter = Broken()
    assert client.post("/api/search/image", files={"file": ("q.png", _png(frame), "image/png")}, data={"remove_bg": "1"}).status_code == 200
    np.testing.assert_array_equal(seen[-1], frame)
