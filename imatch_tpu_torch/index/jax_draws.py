"""JAX's random draws, in numpy: the k-means sample and init of the IVF tier.

``imatch_tpu/index/ivf.py:train_centroids`` draws its training sample with
``jax.random.randint`` and its initial centroids with ``jax.random.choice(
key, n, (C,), p=...)``, from ``jax.random.split(jax.random.key(seed))``.
This module computes the same numbers without JAX, so that the port trains
the same centroids from the same seed and either package may rebuild the
other's index:

- the threefry2x32 counter hash (20 rounds, key schedule and rotations of
  ``jax/_src/prng.py:_threefry2x32_lowering``);
- ``key``, ``split`` and ``random_bits`` as JAX computes them with
  ``jax_threefry_partitionable`` on (the default): element i of a draw of
  shape s hashes the 64-bit counter i, split as (high, low) words, and a
  32-bit draw is the xor of the hash's two output words;
- ``uniform`` (float32 in [0, 1): 23 random mantissa bits under the
  exponent of 1.0, minus 1) and ``randint`` (two keys, the higher and lower
  bits reduced modulo the span with a 2^32 mod span multiplier, in
  wrapping uint32 arithmetic);
- ``choice`` with ``p``, with replacement: ``r = cumsum(p)[-1] * (1 -
  uniform)``, then ``searchsorted``, side left;
- ``cumsum32``: the float32 prefix sum as XLA's CPU backend rounds it
  (``jnp.cumsum``): a sequential sum inside tiles of 16, the tiles' totals
  scanned by the same rule, recursively, and each tile's exclusive prefix
  added to its sums. The search boundaries sit 1/n_live apart, so a prefix
  sum wrong in its last bit moves draws to another row; numpy's sequential
  ``np.cumsum`` differs from ``jnp.cumsum`` in most of its outputs.

A key is a pair of uint32 (the words of ``jax.random.key_data``). Draws run
on the host in every case, on the card too: they are at most 2^18 samples
and 4096 centroids.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

Key = np.ndarray  # (2,) uint32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_TILE = 16


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: Key, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 hash of the counter words (x0, x1) under ``key``;
    returns both output words, uint32 arrays of the counters' shape."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)``'s data: the seed's high and low 32 bits (the
    high word is 0 for a seed that fits 32 bits, as JAX without x64 holds
    it)."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit int32 (JAX without x64)")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The 64-bit iota 0..n-1 as (high, low) uint32 words."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(k: Key, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (num, 2) uint32 keys."""
    hi, lo = _counters(num)
    b0, b1 = threefry2x32(k, hi, lo)
    return np.stack([b0, b1], axis=1)


def random_bits(k: Key, shape: Sequence[int]) -> np.ndarray:
    """32 random bits an element, uint32 of ``shape``."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(int(np.prod(shape, dtype=np.int64)))
    b0, b1 = threefry2x32(k, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(k: Key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.uniform(k, shape)``: float32 in [0, 1)."""
    bits = (random_bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def randint(k: Key, shape: Sequence[int], minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval)``, int32 (JAX's
    default integer without x64)."""
    lo_lim, hi_lim = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    minval, maxval = int(np.clip(minval, lo_lim, hi_lim)), int(np.clip(maxval, lo_lim, hi_lim))
    k1, k2 = split(k)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32((maxval - minval) & 0xFFFFFFFF) if maxval > minval else np.uint32(1)
    multiplier = np.uint32(2**16) % span
    multiplier = np.uint32((int(multiplier) * int(multiplier)) & 0xFFFFFFFF) % span
    offset = (higher % span) * multiplier + lower % span
    offset = offset % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)


def cumsum32(p: np.ndarray) -> np.ndarray:
    """``jnp.cumsum`` of a float32 vector as the CPU backend rounds it:
    sequential sums inside tiles of 16, each tile shifted by the scanned
    (same rule, recursively) totals of the tiles before it."""
    p = np.asarray(p, np.float32).ravel()
    n = p.shape[0]
    if n <= _TILE:
        return np.cumsum(p, dtype=np.float32)
    n_tiles = -(-n // _TILE)
    tiles = np.zeros(n_tiles * _TILE, np.float32)
    tiles[:n] = p
    local = np.cumsum(tiles.reshape(n_tiles, _TILE), axis=1, dtype=np.float32)
    inclusive = cumsum32(local[:, -1])
    prefix = np.concatenate([np.zeros(1, np.float32), inclusive[:-1]])
    out = local.copy()
    out[1:] = local[1:] + prefix[1:, None]
    return out.ravel()[:n]


def choice_p(k: Key, n: int, size: int, p: np.ndarray) -> np.ndarray:
    """``jax.random.choice(k, n, (size,), p=p)`` with replacement: int32
    row ids drawn by inverse CDF over float32 ``p``."""
    p = np.asarray(p, np.float32)
    if p.shape != (n,):
        raise ValueError(f"p has shape {p.shape}, expected ({n},)")
    p_cuml = cumsum32(p)
    r = p_cuml[-1] * (np.float32(1.0) - uniform(k, (size,)))
    return np.searchsorted(p_cuml, r, side="left").astype(np.int32)


def valid_probs(valid: np.ndarray) -> np.ndarray:
    """``valid / valid.sum()`` in float32, as ``_kmeans_chunked`` weighs the
    init (the sum of 0/1 weights is exact; no live row gives NaN, as in
    JAX)."""
    probs = np.asarray(valid, np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        return probs / np.float32(probs.sum(dtype=np.float64))


def kmeans_draws(valid: np.ndarray, n_clusters: int, seed: int, sample: int):
    """The two draws of JAX's ``train_centroids`` over a corpus with host
    validity ``valid``: returns (sample row ids into the corpus or None when
    the corpus has at most ``sample`` rows, init row ids into the training
    rows)."""
    valid = np.asarray(valid, bool)
    n = valid.shape[0]
    key_s, key_k = split(key(seed))
    if n > sample:
        live_idx = np.flatnonzero(valid)
        if live_idx.size:
            idx = live_idx[randint(key_s, (sample,), 0, live_idx.size)]
        else:
            idx = randint(key_s, (sample,), 0, n).astype(np.int64)
        tvalid = valid[idx]
    else:
        idx, tvalid = None, valid
    init = choice_p(key_k, tvalid.shape[0], n_clusters, valid_probs(tvalid))
    return idx, init
