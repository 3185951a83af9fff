"""The port's embedder data parallelism (``data_parallel=`` / IMATCH_EMBED_DP,
``mesh=``) against one device and against the JAX package's.

8 logical ``cpu`` shards (``mesh=["cpu"] * 8``) are the counterpart of
the JAX suite's 8 virtual host devices. Ports of
tests/test_pipeline.py:214-249:

- DP = 8 equals one device within rtol 2e-5, atol 2e-6 on 5 images of
  different sizes (a count 8 does not divide: the chunk pads to 8) and on
  texts; with the W8A8 image tower (IMATCH_EMBED_QUANT=int8) too.
- The fused bulk-ingest step at DP = 8: pHash ids bit-equal to one
  device's, embeddings within the same bar, host and device-resident.
- The port at DP = 8 with JAX's ``init_params(jax.random.key(0))`` weights
  equals JAX's ``ClipEmbedder(data_parallel=8)`` (rtol 2e-5, atol 2e-6),
  and the chunk bounds equal JAX's ``_chunk_bounds``.
- ``data_parallel`` above the visible devices warns and uses those, as
  JAX does; IMATCH_EMBED_DP is its default.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from imatch_tpu.models.clip.model import init_params
from imatch_tpu.pipeline.embedder import ClipEmbedder as JaxEmbedder
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.ops.phash import DEVICE_BUCKET_MIN
from imatch_tpu_torch.pipeline.embedder import ClipEmbedder

CPU8 = ["cpu"] * 8
BAR = dict(rtol=2e-5, atol=2e-6)


def _images():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (30 + i, 40, 3), np.uint8) for i in range(5)]


TEXTS = ["a red drill", "blue sky", "cat"]


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, init_params(jax.random.key(0), jax_tiny()))


def jax_tiny():
    from imatch_tpu.models.clip import configs

    return configs.TINY


@pytest.mark.parametrize("quant", ["", "int8"])
def test_data_parallel_matches_one_device(quant):
    e1 = ClipEmbedder(config="tiny", device="cpu", quant=quant)
    e8 = ClipEmbedder(config="tiny", mesh=CPU8, quant=quant)
    assert e8.dp == 8 and e8.mesh == [torch.device("cpu")] * 8 and e1.dp == 0
    imgs = _images()
    np.testing.assert_allclose(e8.embed_images(imgs), e1.embed_images(imgs), **BAR)
    np.testing.assert_allclose(e8.embed_texts(TEXTS), e1.embed_texts(TEXTS), **BAR)
    np.testing.assert_allclose(
        e8.embed_images_device(imgs).numpy(), e1.embed_images_device(imgs).numpy(), **BAR
    )


@pytest.mark.parametrize("quant", ["", "int8"])
def test_fused_step_ids_bit_equal(quant):
    rng = np.random.default_rng(1)
    n = DEVICE_BUCKET_MIN + 5  # one fused chunk that 8 does not divide
    frames = [rng.integers(0, 256, (48, 64, 3), np.uint8) for _ in range(n)]
    frames += [rng.integers(0, 256, (40, 40, 3), np.uint8)]  # the host tail
    e1 = ClipEmbedder(config="tiny", device="cpu", quant=quant)
    e8 = ClipEmbedder(config="tiny", mesh=CPU8, quant=quant)
    ids1, emb1 = e1.ids_and_embed_images(frames)
    ids8, emb8 = e8.ids_and_embed_images(frames)
    assert ids8 == ids1 and all(ids8)
    np.testing.assert_allclose(emb8, emb1, **BAR)
    chunks = list(e8.ids_and_embed_images_stream(frames, device_embeddings=True))
    idx, ids_c, e = chunks[0]
    assert isinstance(e, torch.Tensor) and len(idx) == n
    assert ids_c == [ids1[i] for i in idx]
    np.testing.assert_allclose(e.numpy(), emb1[idx], **BAR)


def test_matches_jax_data_parallel(tree):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    je = JaxEmbedder(config="tiny", data_parallel=8)
    assert je.dp == 8
    pe = ClipEmbedder(config=TINY, params=tree, mesh=CPU8)
    imgs = _images()
    np.testing.assert_allclose(pe.embed_images(imgs), je.embed_images(imgs), **BAR)
    np.testing.assert_allclose(pe.embed_texts(TEXTS), je.embed_texts(TEXTS), **BAR)
    for n in (1, 5, 8, 13, 600, 1100):
        for chunk in (4, 512):
            assert list(pe._chunk_bounds(n, chunk)) == list(je._chunk_bounds(n, chunk)), (n, chunk)


def test_data_parallel_over_the_visible_devices(monkeypatch, caplog):
    caplog.set_level(logging.WARNING, logger="imatch.embedder")
    e = ClipEmbedder(config="tiny", device="cpu", data_parallel=4)
    assert e.mesh == [torch.device("cpu")] and e.dp == 1
    assert "requested dp=4 but only 1 devices; using 1" in caplog.messages
    monkeypatch.setenv("IMATCH_EMBED_DP", "2")
    caplog.clear()
    e = ClipEmbedder(config="tiny", device="cpu")
    assert e.dp == 1 and "requested dp=2 but only 1 devices; using 1" in caplog.messages
    monkeypatch.setenv("IMATCH_EMBED_DP", "0")
    assert ClipEmbedder(config="tiny", device="cpu").dp == 0
    with pytest.raises(ValueError):
        ClipEmbedder(config="tiny", mesh=[])
