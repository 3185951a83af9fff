"""Perceptual hash (pHash) ids for duplicate detection, host part.

Counterpart of the host half of ``imatch_tpu/ops/phash.py``
(``phash_host``, ``image_id``, ``bits_to_hex``, ``hex_to_bits``,
``hamming``): ``imagehash.phash`` defaults, grayscale -> 32x32 LANCZOS
resize -> 2D DCT-II -> top-left 8x8 block -> median threshold -> 64
bits as 16 hex chars; v2 image ids are ``img_<hex>``. Built on the same
primitives (PIL convert('L') and LANCZOS resize, scipy's DCT), so ids are
bit-identical to the JAX package's. The batched device pHash belongs to
the bulk-ingest slice (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def _scipy_dct2(pixels: np.ndarray) -> np.ndarray:
    import scipy.fftpack

    return scipy.fftpack.dct(scipy.fftpack.dct(pixels, axis=0), axis=1)


def bits_to_hex(bits: np.ndarray) -> str:
    """64 bools (row-major 8x8) -> 16 hex chars, imagehash serialization."""
    flat = np.asarray(bits, dtype=np.uint8).flatten()
    val = 0
    for b in flat:
        val = (val << 1) | int(b)
    return f"{val:0{len(flat) // 4}x}"


def hex_to_bits(h: str) -> np.ndarray:
    n = len(h) * 4
    val = int(h, 16)
    return np.array([(val >> (n - 1 - i)) & 1 for i in range(n)], dtype=bool)


def hamming(h1: str, h2: str) -> int:
    return int((hex_to_bits(h1) != hex_to_bits(h2)).sum())


def phash_host(
    image: Image.Image, hash_size: int = 8, highfreq_factor: int = 4
) -> str:
    """Bit-identical to imagehash.phash defaults."""
    img_size = hash_size * highfreq_factor
    small = image.convert("L").resize(
        (img_size, img_size), Image.Resampling.LANCZOS
    )
    pixels = np.asarray(small, dtype=np.float64)
    dct = _scipy_dct2(pixels)
    low = dct[:hash_size, :hash_size]
    med = np.median(low)
    return bits_to_hex(low > med)


def image_id(image: Image.Image) -> str:
    """v2 content-addressed id: ``img_`` + the pHash hex."""
    return f"img_{phash_host(image)}"
