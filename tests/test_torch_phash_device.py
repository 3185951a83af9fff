"""The port's device pHash (ops/phash.py) against the JAX package's.

- ``phash_core`` on the same uint8 batches: the confidence flags and the
  confident images' bits equal JAX's; the 32x32 grids within one level
  (fp32 pass sums in another order can round a boundary pixel the other
  way), and the image ids of the batch forms equal the host ``image_id``.
- The median of the 64 coefficients is the mean of the two middle ones,
  as ``jnp.median`` takes it. ``torch.median`` returns the lower one: the
  smallest distance to it is 0, so no image would ever be confident.
Frames are generated here from numpy seeds; the port runs on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from imatch_tpu.ops import phash as jax_phash
from imatch_tpu.ops.resize import resample_matrix as jax_resample_matrix
from imatch_tpu_torch.ops import phash

CPU = torch.device("cpu")


def _frames(n, h, w, seed):
    """Smooth gradients and blobs with noise: photo-like low frequencies,
    so most hashes clear the margin."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for _ in range(n):
        f = rng.uniform(1.0, 6.0, (3, 2))
        ph = rng.uniform(0, 6.3, 3)
        img = np.stack(
            [np.sin(f[c, 0] * np.pi * xx + ph[c]) * np.cos(f[c, 1] * np.pi * yy) for c in range(3)],
            -1,
        )
        img = img * 100 + 128 + rng.normal(0, 6, (h, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


def _core_both(frames):
    h, w = frames.shape[1:3]
    a_v = jax_resample_matrix(h, 32, "lanczos", quantize_8bpc=True)
    a_h = jax_resample_matrix(w, 32, "lanczos", quantize_8bpc=True)
    theirs = [np.asarray(t) for t in jax_phash.phash_core(jnp.asarray(frames), jnp.asarray(a_v), jnp.asarray(a_h))]
    ours = [
        t.numpy()
        for t in phash.phash_core(torch.from_numpy(frames), torch.from_numpy(a_v), torch.from_numpy(a_h))
    ]
    return ours, theirs


@pytest.mark.parametrize("h,w,seed", [(96, 128, 0), (240, 320, 1), (37, 53, 2), (300, 180, 3)])
def test_phash_core_matches_jax(h, w, seed):
    frames = _frames(10, h, w, seed)
    (bits, conf, small), (jbits, jconf, jsmall) = _core_both(frames)
    assert bits.shape == (10, 8, 8) and bits.dtype == bool
    assert small.shape == (10, 32, 32) and small.dtype == np.uint8
    np.testing.assert_array_equal(conf, jconf)
    np.testing.assert_array_equal(bits[conf], jbits[jconf])
    assert np.abs(small.astype(int) - jsmall.astype(int)).max() <= 1
    for j in range(len(frames)):
        host = phash.phash_host(Image.fromarray(frames[j]))
        if conf[j]:
            assert phash.bits_to_hex(bits[j]) == host
        tail = phash.host_bits_from_small(small[j])
        assert tail == jax_phash.host_bits_from_small(small[j])


def test_batch_forms_give_host_ids():
    frames = _frames(9, 120, 90, 4)
    hexes, conf, small = phash.phash_batch_checked(frames, device=CPU)
    jhexes, jconf, _ = jax_phash.phash_batch_checked(frames)
    np.testing.assert_array_equal(conf, jconf)
    assert [h for h, c in zip(hexes, conf) if c] == [h for h, c in zip(jhexes, jconf) if c]
    assert phash.phash_batch(frames, device=CPU) == hexes
    mixed = list(frames) + list(_frames(3, 64, 64, 5)) + [None]
    ids = phash.image_ids_batch(mixed, device=CPU)
    host = [phash.image_id(Image.fromarray(a)) for a in mixed[:-1]] + [None]
    assert ids == host
    assert ids == jax_phash.image_ids_batch(mixed)
    assert phash.DEVICE_BUCKET_MIN == jax_phash.DEVICE_BUCKET_MIN == 8


def test_median_is_the_two_middle_mean():
    frames = _frames(10, 96, 128, 6)
    a_v = torch.from_numpy(phash.resample_matrix(96, 32, "lanczos", quantize_8bpc=True))
    a_h = torch.from_numpy(phash.resample_matrix(128, 32, "lanczos", quantize_8bpc=True))
    bits, conf, small = phash.phash_core(torch.from_numpy(frames), a_v, a_h)
    # the same coefficients in fp64 from the grid: thresholds at np.median
    for j in range(len(frames)):
        d = phash._scipy_dct2(small[j].numpy().astype(np.float64))[:8, :8]
        med = np.median(d)
        lower = np.sort(d.ravel())[31]
        assert lower < med  # a case where the two conventions differ
        gap = np.abs(d - med).min()
        assert conf[j].item() == (gap > 16.0) or abs(gap - 16.0) < 1e-2
        assert np.abs(d - lower).min() == 0.0  # torch.median's value: never confident
        if conf[j]:
            np.testing.assert_array_equal(bits[j].numpy(), d > med)
    assert conf.any()
