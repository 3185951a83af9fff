"""Preprocess, pHash ids, tokenizer and resize matrices of the PyTorch
port against the JAX package.

- Preprocess: within 1 uint8 level of JAX ``preprocess_core`` at
  ``IMATCH_RESIZE_PRECISION=highest``, in under 0.1% of pixels.
- pHash ids: bit-identical to ``imatch_tpu.ops.phash.image_id``.
- Tokenizer ids and resize matrices: identical to the originals.
Images are generated here from numpy seeds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from imatch_tpu.ops import phash as jax_phash
from imatch_tpu.ops import resize as jax_resize
from imatch_tpu.ops import tokenizer as jax_tok
from imatch_tpu.ops.preprocess import preprocess_core as jax_preprocess_core
from imatch_tpu_torch.ops import phash, resize, tokenizer
from imatch_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD, preprocess_images

GEOMETRIES = [(37, 53), (224, 224), (300, 180), (64, 401), (512, 384)]
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "clip_bpe")


def _frames(seed):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in GEOMETRIES:
        yy, xx = np.mgrid[0:h, 0:w]
        smooth = np.stack(
            [np.sin(xx / 9.0) * 100, np.cos(yy / 7.0) * 100, (xx + yy) % 97], -1
        )
        noisy = smooth + 128 + rng.integers(-40, 41, (h, w, 3))
        out.append(np.clip(noisy, 0, 255).astype(np.uint8))
    return out


def _levels(x):
    """Normalized pixels back to 0-255 levels."""
    return np.round((np.asarray(x, np.float64) * CLIP_STD + CLIP_MEAN) * 255.0)


def test_preprocess_matches_jax_highest(monkeypatch):
    # The precision is read at trace time: a fresh jit after setting it,
    # since _preprocess_same_size's cache may already hold a `high` trace.
    monkeypatch.setenv("IMATCH_RESIZE_PRECISION", "highest")
    core = jax.jit(lambda im, av, ah: jax_preprocess_core(im, av, ah))
    frames = _frames(0)
    got = preprocess_images(frames, device=torch.device("cpu")).numpy()
    assert got.shape == (len(frames), 224, 224, 3)
    diffs, total = 0, 0
    for j, im in enumerate(frames):
        a_v, a_h = jax_resize.resize_crop_matrices(*im.shape[:2], 224)
        ref = core(jnp.asarray(im[None]), jnp.asarray(a_v), jnp.asarray(a_h))[0]
        d = np.abs(_levels(got[j]) - _levels(ref))
        assert d.max() <= 1
        diffs += int((d > 0).sum())
        total += d.size
    assert diffs / total < 1e-3


def test_preprocess_keeps_input_order_across_geometries():
    frames = _frames(1)
    mixed = [frames[2], frames[0], frames[2], frames[1]]
    got = preprocess_images(mixed, device=torch.device("cpu"))
    alone = preprocess_images([frames[0]], device=torch.device("cpu"))
    np.testing.assert_array_equal(got[1].numpy(), alone[0].numpy())
    np.testing.assert_array_equal(got[0].numpy(), got[2].numpy())


@pytest.mark.parametrize("seed", range(4))
def test_phash_ids_bit_identical(seed):
    frames = _frames(10 + seed)
    for im in frames:
        pil = Image.fromarray(im)
        assert phash.image_id(pil) == jax_phash.image_id(pil)
    a = phash.phash_host(Image.fromarray(frames[0]))
    b = phash.phash_host(Image.fromarray(frames[1]))
    assert phash.hamming(a, b) == jax_phash.hamming(a, b)
    assert phash.bits_to_hex(phash.hex_to_bits(a)) == a


TEXTS = [
    "a red drill",
    "  A Photo of   a CAT, on the mat!  ",
    "café crème — naïve 東京 🙂",
    "<|startoftext|>x<|endoftext|>",
    "",
    "word " * 300,
]


def test_byte_fallback_tokens_identical():
    ours, theirs = tokenizer.CLIPTokenizer.byte_fallback(), jax_tok.CLIPTokenizer.byte_fallback()
    for max_length in (16, 77, 248):
        np.testing.assert_array_equal(
            ours.encode_batch(TEXTS, max_length=max_length),
            theirs.encode_batch(TEXTS, max_length=max_length),
        )
    assert ours.decode(ours.encode(TEXTS[0])) == theirs.decode(theirs.encode(TEXTS[0]))


def test_fixture_vocab_tokens_identical():
    vocab = os.path.join(FIXTURES, "vocab.json")
    merges = os.path.join(FIXTURES, "merges.txt")
    ours = tokenizer.CLIPTokenizer.from_files(vocab, merges)
    theirs = jax_tok.CLIPTokenizer.from_files(vocab, merges)
    texts = ["a photo of a dog", "the quick brown fox", "hello world", "drill"]
    np.testing.assert_array_equal(
        ours.encode_batch(texts, max_length=32), theirs.encode_batch(texts, max_length=32)
    )


def test_default_tokenizer_reads_vocab_env(monkeypatch):
    monkeypatch.setenv("IMATCH_CLIP_VOCAB", os.path.join(FIXTURES, "vocab.json"))
    monkeypatch.setenv("IMATCH_CLIP_MERGES", os.path.join(FIXTURES, "merges.txt"))
    tokenizer.default_tokenizer.cache_clear()
    try:
        tok = tokenizer.default_tokenizer()
        assert tok.vocab_size != tokenizer.CLIPTokenizer.byte_fallback().vocab_size
    finally:
        tokenizer.default_tokenizer.cache_clear()


@pytest.mark.parametrize("h,w", [(37, 53), (224, 224), (1080, 1920), (31, 5)])
def test_resize_matrices_identical(h, w):
    for a, b in zip(
        resize.resize_crop_matrices(h, w, 224), jax_resize.resize_crop_matrices(h, w, 224)
    ):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        resize.resample_matrix(h, 32, "lanczos", quantize_8bpc=True),
        jax_resize.resample_matrix(h, 32, "lanczos", quantize_8bpc=True),
    )
