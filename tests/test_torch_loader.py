"""The port's native decode pool (imatch_tpu_torch/runtime/loader.py)
against the JAX package's, on the CPU.

- The 13 cases of tests/test_loader.py on the port's copy, with every
  frame made here (the WebP and AVIF frames too; AVIF where this Pillow
  writes it).
- Both loaders give bit-identical arrays on a grid of formats: 8- and
  16-bit gray, RGB, RGBA, LA, palette with tRNS and 1-bit PNGs, RGB, CMYK
  and gray JPEGs, lossless and RGBA WebP, and GIF.
- The library builds into the repository's build/, never into the
  package; without it the loader decodes with PIL, a batch on a thread
  pool (``decode_each``, which keeps each item's error in its place).
- The fault the loader fixes: ``POST /api/upload`` of a (48, 64) 16-bit
  grayscale PNG gives the same id in both apps, the pHash of the frame's
  high byte (the port decoded it with PIL's ``convert("RGB")``, which
  clips mode I;16 to near white).
"""

import asyncio
import io
import threading
from pathlib import Path

import httpx
import jax
import numpy as np
import pytest
from PIL import Image, features

from imatch_tpu.models.clip.configs import TINY as JAX_TINY
from imatch_tpu.models.clip.model import init_params
from imatch_tpu.pipeline.captioner import NullCaptioner as JaxNullCaptioner
from imatch_tpu.pipeline.embedder import ClipEmbedder as JaxEmbedder
from imatch_tpu.pipeline.state import AppState as JaxState
from imatch_tpu.runtime.loader import NativeImageLoader as JaxLoader
from imatch_tpu.serving.app import create_app as jax_create_app
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.ops.phash import image_id
from imatch_tpu_torch.pipeline.captioner import NullCaptioner
from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
from imatch_tpu_torch.pipeline.state import AppState
from imatch_tpu_torch.runtime import loader as loader_mod
from imatch_tpu_torch.runtime.loader import (
    NativeImageLoader,
    decode_image_bytes,
    default_loader,
    probe_image_bytes,
)
from imatch_tpu_torch.serving.app import create_app

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def loader():
    return NativeImageLoader(threads=2)


def _save(img: Image.Image, fmt: str, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, fmt, **kw)
    return b.getvalue()


def _png_bytes(arr):
    return _save(Image.fromarray(arr), "PNG")


def _rgb(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def gray16(h=48, w=64, seed=0):
    """A 16-bit grayscale frame whose high byte spans the whole range."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 65535 // max(w - 1, 1) + yy * 97).astype(np.int64)
    return np.clip(base + rng.integers(-300, 301, (h, w)), 0, 65535).astype(np.uint16)


# -- tests/test_loader.py on the port -----------------------------------------


def test_png_exact(loader):
    img = _rgb(0, 37, 53)
    np.testing.assert_array_equal(loader.decode_batch([_png_bytes(img)])[0], img)


def test_jpeg_matches_pil(loader):
    data = _save(Image.fromarray(_rgb(1, 64, 48)), "JPEG", quality=90)
    out = loader.decode_batch([data])[0]
    np.testing.assert_array_equal(out, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def test_webp_and_avif_paths(loader, tmp_path):
    """WebP decodes natively; AVIF through the PIL fallback inside the
    loader (made here where this Pillow writes AVIF)."""
    img = Image.fromarray(_rgb(6, 40, 56))
    webp = tmp_path / "frame.webp"
    img.save(webp, "WEBP", quality=80)
    paths = [str(webp)]
    if features.check("avif"):
        avif = tmp_path / "frame.avif"
        img.save(avif, "AVIF")
        paths.append(str(avif))
    outs = loader.decode_batch(paths)
    for p, out in zip(paths, outs):
        assert out is not None and out.shape == (40, 56, 3)
        np.testing.assert_array_equal(out, np.asarray(Image.open(p).convert("RGB")))


def test_grayscale_png(loader):
    img = np.random.default_rng(2).integers(0, 256, (20, 30), np.uint8)
    out = loader.decode_batch([_save(Image.fromarray(img, mode="L"), "PNG")])[0]
    assert out.shape == (20, 30, 3)
    np.testing.assert_array_equal(out[..., 0], img)


def test_garbage_bytes_fall_back_with_error(loader):
    # per-file isolation: decode_batch yields None by default, not a raise
    assert loader.decode_batch([b"not an image at all"]) == [None]
    with pytest.raises(Exception):
        loader.decode_batch([b"not an image at all"], on_error="raise")


def test_many_concurrent(loader):
    imgs = [_rgb(3 + i, 16 + i, 24) for i in range(20)]
    for a, b in zip(loader.decode_batch([_png_bytes(im) for im in imgs]), imgs):
        np.testing.assert_array_equal(a, b)


def test_decode_image_bytes_helper():
    img = _rgb(4, 10, 12)
    np.testing.assert_array_equal(decode_image_bytes(_png_bytes(img)), img)


def test_submit_directory_path_reports_error(loader, tmp_path):
    """A directory fails as a decode error (ftell), not an abort through
    the C boundary, and the pool stays usable."""
    t = loader.submit_path(str(tmp_path))
    with pytest.raises(Exception):
        loader.wait(t)
    img = _rgb(5, 8, 9)
    np.testing.assert_array_equal(loader.decode_batch([_png_bytes(img)])[0], img)


def test_decode_batch_isolates_failures_and_drains():
    loader = NativeImageLoader()
    img = np.full((8, 8, 3), 128, np.uint8)
    good = _png_bytes(img)
    out = loader.decode_batch([good, b"not an image at all", good])
    assert out[0] is not None and out[2] is not None
    assert out[1] is None
    np.testing.assert_array_equal(out[0], img)
    loader.close()


def test_decode_image_bytes_raises_on_garbage():
    with pytest.raises(Exception):
        decode_image_bytes(b"\x00\x01garbage")


def test_probe_is_header_only_and_correct():
    assert probe_image_bytes(_png_bytes(np.zeros((12, 34, 3), np.uint8))) == (34, 12)
    assert probe_image_bytes(b"garbage bytes") is None


def test_double_wait_returns_instead_of_hanging():
    """A consumed ticket answers err 4 on the C side, and the wait falls
    back to PIL instead of parking the thread."""
    loader = NativeImageLoader()
    img = np.full((4, 4, 3), 7, np.uint8)
    t = loader.submit_bytes(_png_bytes(img))
    np.testing.assert_array_equal(loader.wait(t), img)
    np.testing.assert_array_equal(loader.wait(t), img)
    loader.close()


def test_decode_batch_accepts_bytearray():
    blob = _save(Image.fromarray(np.zeros((16, 16, 3), np.uint8) + np.uint8(200)), "JPEG")
    out = default_loader().decode_batch([blob, bytearray(blob)])
    assert out[0] is not None and out[1] is not None
    assert out[0].shape == out[1].shape == (16, 16, 3)
    assert (out[0] == out[1]).all()


# -- the build and the fallback -----------------------------------------------


def test_native_library_builds_into_build_dir():
    assert default_loader().native
    so = loader_mod.library_path()
    assert so.exists() and so.parent == REPO / "build"
    pkg = REPO / "imatch_tpu_torch"
    assert not list(pkg.rglob("*.so")), "the loader must not write into the package"
    report = loader_mod.toolchain_report()
    assert report["g++"] and all(report["headers"].values()) and report["build_error"] is None


def test_without_the_library_the_loader_decodes_with_pil(monkeypatch):
    monkeypatch.setattr(loader_mod, "_build_lib", lambda: None)
    loader = NativeImageLoader()
    assert not loader.native
    img = _rgb(9, 12, 14)
    np.testing.assert_array_equal(loader.decode_batch([_png_bytes(img)])[0], img)


@pytest.mark.parametrize("native", [True, False], ids=["native", "pil-fallback"])
def test_decode_each_keeps_order_and_errors(monkeypatch, native):
    """``decode_each`` returns each item's array or its exception, in
    order; without the library a batch's PIL decodes run on the thread
    pool, not one after another on the caller's thread."""
    if not native:
        monkeypatch.setattr(loader_mod, "_build_lib", lambda: None)
    threads = []
    pil_decode = loader_mod._pil_decode

    def recording(data):
        threads.append(threading.current_thread().name)
        return pil_decode(data)

    monkeypatch.setattr(loader_mod, "_pil_decode", recording)
    loader = NativeImageLoader(threads=4)
    assert loader.native == native
    imgs = [_rgb(20 + i, 9, 11) for i in range(5)]
    items = [_png_bytes(im) for im in imgs]
    items.insert(2, b"not an image at all")
    out = loader.decode_each(items)
    assert isinstance(out[2], Exception)
    for got, want in zip(out[:2] + out[3:], imgs):
        np.testing.assert_array_equal(got, want)
    if native:
        assert threads == [threading.current_thread().name]  # only the garbage fell back
    else:
        assert len(threads) == 6 and all(t.startswith("imatch-decode") for t in threads)
    loader.close()


def test_close_is_idempotent_and_refuses_nothing_after():
    loader = NativeImageLoader(threads=1)
    loader.close()
    loader.close()
    img = _rgb(10, 6, 7)
    # a closed pool decodes with PIL rather than touching freed memory
    np.testing.assert_array_equal(loader.decode_batch([_png_bytes(img)])[0], img)


# -- the format grid: the port's loader against JAX's --------------------------


def _grid():
    rgb = _rgb(11, 33, 47)
    gray = rgb[..., 0]
    rgba = np.concatenate([rgb, rgb[..., :1]], axis=-1)
    pal = Image.fromarray(rgb).quantize(16)
    pal.info["transparency"] = 3
    return {
        "gray8-png": _save(Image.fromarray(gray, "L"), "PNG"),
        "gray16-png": _save(Image.fromarray(gray16(33, 47)), "PNG"),
        "rgb-png": _save(Image.fromarray(rgb), "PNG"),
        "rgba-png": _save(Image.fromarray(rgba, "RGBA"), "PNG"),
        "la-png": _save(Image.fromarray(np.stack([gray, 255 - gray], -1), "LA"), "PNG"),
        "palette-trns-png": _save(pal, "PNG", transparency=3),
        "1bit-png": _save(Image.fromarray(gray > 127), "PNG"),
        "rgb-jpeg": _save(Image.fromarray(rgb), "JPEG", quality=90),
        "cmyk-jpeg": _save(Image.fromarray(rgba, "RGBA").convert("CMYK"), "JPEG", quality=90),
        "gray-jpeg": _save(Image.fromarray(gray, "L"), "JPEG", quality=90),
        "webp-lossless": _save(Image.fromarray(rgb), "WEBP", lossless=True),
        "webp-rgba": _save(Image.fromarray(rgba, "RGBA"), "WEBP", quality=80),
        "gif": _save(Image.fromarray(rgb).quantize(64), "GIF"),
    }


GRID = _grid()


@pytest.fixture(scope="module")
def jax_loader():
    return JaxLoader(threads=2)


@pytest.mark.parametrize("name", sorted(GRID))
def test_format_grid_equals_jax_loader(loader, jax_loader, name):
    data = GRID[name]
    got = loader.decode_batch([data], on_error="raise")[0]
    want = jax_loader.decode_batch([data], on_error="raise")[0]
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape and got.shape[-1] == 3
    np.testing.assert_array_equal(got, want)


def test_sixteen_bit_png_is_its_high_byte(loader):
    a = gray16()
    out = loader.decode_batch([_save(Image.fromarray(a), "PNG")], on_error="raise")[0]
    for c in range(3):
        np.testing.assert_array_equal(out[..., c], (a >> 8).astype(np.uint8))


# -- the 16-bit PNG upload: the same id in both apps ----------------------------


class _Client:
    def __init__(self, app):
        self._c = httpx.AsyncClient(transport=httpx.ASGITransport(app=app), base_url="http://t")

    def post(self, url, **kw):
        return asyncio.run(self._c.post(url, **kw))


def test_sixteen_bit_png_upload_gets_the_jax_apps_id(tmp_path):
    tree = jax.tree.map(np.asarray, init_params(jax.random.key(0), JAX_TINY))
    ja = _Client(
        jax_create_app(
            JaxState(root=str(tmp_path / "jax"), embedder=JaxEmbedder(config=JAX_TINY), captioner=JaxNullCaptioner())
        )
    )
    pa = _Client(
        create_app(
            AppState(
                root=str(tmp_path / "port"),
                embedder=ClipEmbedder(config=TINY, params=tree, device="cpu"),
                captioner=NullCaptioner(),
                device="cpu",
            )
        )
    )
    a = gray16()
    data = _save(Image.fromarray(a), "PNG")
    ids = []
    for c in (ja, pa):
        r = c.post("/api/upload", files={"file": ("deep.png", data, "image/png")})
        assert r.status_code == 200, r.text
        ids.append(r.json()["metadata"]["id"])
    high = np.repeat((a >> 8).astype(np.uint8)[..., None], 3, axis=-1)
    assert ids[1] == ids[0] == image_id(Image.fromarray(high))
