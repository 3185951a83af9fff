"""Perceptual hash (pHash) ids for duplicate detection.

Counterpart of ``imatch_tpu/ops/phash.py``: ``imagehash.phash`` defaults,
grayscale -> 32x32 LANCZOS resize -> 2D DCT-II -> top-left 8x8 block ->
median threshold -> 64 bits as 16 hex chars; v2 image ids are
``img_<hex>``.

- ``phash_host`` / ``image_id``: authoritative, on the same primitives
  (PIL convert('L') and LANCZOS resize, scipy's DCT), so ids are
  bit-identical to the JAX package's.
- ``phash_core`` and its batch forms: the device pHash of bulk ingest,
  grayscale + LANCZOS resample + DCT as fp32 matrix products with PIL's
  two-pass uint8 rounding, and a per-image margin flag. A confident id is
  provably ``phash_host``'s; the others take the exact fp64 tail on the
  device's 32x32 grid (``host_bits_from_small``).
- ``image_ids_batch``: device hashes for same-geometry runs of at least
  ``DEVICE_BUCKET_MIN`` images, threaded host hashes for the rest.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from imatch_tpu_torch.device import DeviceLike, resolve_device
from imatch_tpu_torch.ops.resize import resample_matrix


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


# ---------------------------------------------------------------------------
# Batched device path
# ---------------------------------------------------------------------------


@functools.lru_cache()
def _dct2_matrix(n: int) -> np.ndarray:
    """scipy.fftpack.dct type-II (norm=None) as a matrix: y = C @ x."""
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    return (2.0 * np.cos(np.pi * k * (2 * m + 1) / (2 * n))).astype(np.float32)


# PIL convert('L') ITU-R 601-2 integer weights: (R*19595+G*38470+B*7471+0x8000)>>16
_L_WEIGHTS = np.array([19595.0, 38470.0, 7471.0], dtype=np.float32) / 65536.0


def phash_core(
    imgs: torch.Tensor,
    a_v: torch.Tensor,
    a_h: torch.Tensor,
    hash_size: int = 8,
    highfreq_factor: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """uint8 (B, H, W, 3) frames -> (bits (B, 8, 8) bool, confident (B,)
    bool, small (B, 32, 32) uint8), on the frames' device. ``a_v`` (32, H)
    and ``a_h`` (32, W) are the 8-bit-quantized LANCZOS matrices
    (``resample_matrix(..., quantize_8bpc=True)``) on that device.

    The products are full fp32 (TF32 is off wherever the port resolves a
    CUDA device, device.py), so the L conversion is exact integer math and
    ``floor(gray + 0.5)`` is PIL's rounding. Each resample pass rounds half
    UP, ``floor(x + 0.5)``, as PIL's ``(ss + 2^21) >> 22`` does;
    ``torch.round`` would round half to even. ``small`` agrees with PIL's
    grid except where an fp32 pass sum lands within rounding of a
    half-integer. ``confident`` is the absolute DCT margin: a one-level
    flip of a grid pixel moves a coefficient by at most 4, so a minimum
    distance to the median above 16 keeps the bits through up to four
    such flips, and a confident id equals PIL's."""
    x = imgs.float()
    w = [float(v) for v in _L_WEIGHTS]  # exact in fp32, as every product and sum here
    gray = torch.floor(x[..., 0] * w[0] + x[..., 1] * w[1] + x[..., 2] * w[2] + 0.5)
    x = torch.matmul(gray, a_h.T)  # (B, H, 32): horizontal pass first, as PIL
    x = torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)
    x = torch.matmul(a_v, x)  # (B, 32, 32)
    x = torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)
    c = torch.from_numpy(_dct2_matrix(hash_size * highfreq_factor)).to(x.device)
    d = torch.matmul(torch.matmul(c, x), c.T)  # 2D DCT-II
    flat = d[:, :hash_size, :hash_size].reshape(d.shape[0], -1)
    # The median of an even count is the mean of the two middle values,
    # as jnp.median and np.median take it; torch.median would return the
    # lower one and flip bits.
    srt = torch.sort(flat, dim=1).values
    n = flat.shape[1]
    med = (srt[:, (n - 1) // 2 : (n - 1) // 2 + 1] + srt[:, n // 2 : n // 2 + 1]) * 0.5
    confident = (flat - med).abs().amin(dim=1) > 16.0
    bits = (flat > med).reshape(-1, hash_size, hash_size)
    return bits, confident, x.to(torch.uint8)


def host_bits_from_small(small_u8: np.ndarray, hash_size: int = 8) -> str:
    """Exact imagehash.phash tail on a device-resampled grid: fp64 DCT +
    median threshold -> hex chars. Matches ``phash_host`` whenever the
    grid matches PIL's resample. ``hash_size`` must match the one the grid
    was built with (grid side = hash_size * highfreq_factor)."""
    dct = _scipy_dct2(np.asarray(small_u8, np.float64))
    low = dct[:hash_size, :hash_size]
    return bits_to_hex(low > np.median(low))


def _phash_batch_device(imgs_u8, hash_size, highfreq_factor, device):
    dev = resolve_device(device)
    h, w = imgs_u8.shape[1:3]
    n = hash_size * highfreq_factor
    a_v = torch.from_numpy(resample_matrix(h, n, "lanczos", quantize_8bpc=True)).to(dev)
    a_h = torch.from_numpy(resample_matrix(w, n, "lanczos", quantize_8bpc=True)).to(dev)
    frames = torch.from_numpy(np.ascontiguousarray(imgs_u8)).to(dev)
    bits, confident, small = phash_core(frames, a_v, a_h, hash_size, highfreq_factor)
    return bits.cpu().numpy(), confident.cpu().numpy(), small.cpu().numpy()


def phash_batch(
    imgs_u8: np.ndarray,
    hash_size: int = 8,
    highfreq_factor: int = 4,
    device: DeviceLike = None,
) -> List[str]:
    """Device pHash for a same-geometry uint8 RGB batch (B, H, W, 3)."""
    bits, _, _ = _phash_batch_device(imgs_u8, hash_size, highfreq_factor, device)
    return [bits_to_hex(b) for b in bits]


def phash_batch_checked(
    imgs_u8: np.ndarray,
    hash_size: int = 8,
    highfreq_factor: int = 4,
    device: DeviceLike = None,
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Device pHash + per-image margin confidence + the 32x32 grids. A
    confident hash is provably ``phash_host``'s answer (``phash_core``);
    callers give unconfident images ``host_bits_from_small`` of their grid."""
    bits, confident, small = _phash_batch_device(imgs_u8, hash_size, highfreq_factor, device)
    return [bits_to_hex(b) for b in bits], confident, small


# Device hashing pays off only for same-geometry runs: each geometry needs
# its own resample matrices, so small buckets go to the host pool.
DEVICE_BUCKET_MIN = 8


def image_ids_batch(
    arrays: List[Optional[np.ndarray]],
    pool: Optional[ThreadPoolExecutor] = None,
    device: DeviceLike = None,
) -> List[Optional[str]]:
    """Bulk ``image_id`` for decoded RGB arrays (None entries skipped).
    Same-geometry runs of at least ``DEVICE_BUCKET_MIN`` images hash on
    the device (confident bits, else the fp64 tail on the device grid);
    the rest hash on the host, over ``pool`` when one is given."""
    out: List[Optional[str]] = [None] * len(arrays)
    buckets: Dict[tuple, List[int]] = {}
    for i, a in enumerate(arrays):
        if a is not None:
            buckets.setdefault(a.shape, []).append(i)

    host_idx: List[int] = []
    for idxs in buckets.values():
        if len(idxs) >= DEVICE_BUCKET_MIN:
            hexes, confident, smalls = phash_batch_checked(
                np.stack([arrays[i] for i in idxs]), device=device
            )
            for j, i in enumerate(idxs):
                if confident[j]:
                    out[i] = f"img_{hexes[j]}"
                else:
                    out[i] = f"img_{host_bits_from_small(smalls[j])}"
        else:
            host_idx.extend(idxs)

    def host_one(i):
        return i, image_id(Image.fromarray(arrays[i]))

    if pool is not None and len(host_idx) > 1:
        for i, id_ in pool.map(host_one, host_idx):
            out[i] = id_
    else:
        for i in host_idx:
            out[i] = host_one(i)[1]
    return out
