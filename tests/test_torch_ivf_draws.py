"""JAX's k-means draws in numpy (imatch_tpu_torch/index/jax_draws.py)
against the installed JAX, bit for bit, and the port's IVF training
against JAX's.

- ``key``, ``split``, ``uniform``, ``randint`` (two keys, higher and lower
  bits) and ``choice`` with ``p`` equal ``jax.random``'s outputs exactly,
  for seeds {0, 1, 3, 12345}, n up to 2^18 with invalid rows and C up to
  4096; ``cumsum32`` equals ``jnp.cumsum`` bit for bit on the CPU backend
  (numpy's sequential ``np.cumsum`` does not, and one bit moves draws to
  another row).
- ``train_centroids`` equals JAX's within 1e-5, with and without the
  live-row sample.
- The fault this module fixes: 4096 x 32 clustered unit rows, 64
  clusters, seed 0. Both packages keep the same number of non-empty
  clusters and give the same top-10 ids at ``n_probe`` 2 over 32 queries
  (a ``torch.Generator`` draw kept 64 clusters against JAX's 63, and 2 of
  32 queries got other ids).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imatch_tpu.index.ivf as jivf
from imatch_tpu_torch.index import jax_draws as D
from imatch_tpu_torch.index.ivf import build_ivf, ivf_topk, train_centroids

SEEDS = (0, 1, 3, 12345)
SIZES = (1000, 4096, 100003, 1 << 18)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _valid(n, seed):
    v = np.random.default_rng(seed).random(n) > 0.2
    v[0] = True
    return v


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_equal_jax(seed):
    k = jax.random.key(seed)
    np.testing.assert_array_equal(D.key(seed), np.asarray(jax.random.key_data(k)))
    for num in (2, 3):
        want = np.asarray(jax.random.key_data(jax.random.split(k, num)))
        np.testing.assert_array_equal(D.split(D.key(seed), num), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_randint_equal_jax(seed):
    k = jax.random.key(seed)
    for n in (1, 7, 4096, 1 << 18):
        np.testing.assert_array_equal(
            _bits(D.uniform(D.key(seed), (n,))), _bits(jax.random.uniform(k, (n,)))
        )
    # spans below 2^16 (the multiplier's square stays exact), past 2^16
    # (it wraps in uint32) and a power of two
    for n, span in ((5, 777), (4096, 100003), (1 << 18, 1 << 18), (1 << 18, 209715)):
        want = np.asarray(jax.random.randint(k, (n,), 0, span))
        got = D.randint(D.key(seed), (n,), 0, span)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", (1, 15, 16, 17, 255, 257, 4097) + SIZES)
def test_cumsum_equals_jnp_bit_for_bit(n):
    v = _valid(n, n)
    p = jnp.asarray(v, jnp.float32)
    p = p / jnp.sum(p)
    np.testing.assert_array_equal(_bits(D.valid_probs(v)), _bits(p))
    np.testing.assert_array_equal(_bits(D.cumsum32(np.asarray(p))), _bits(jnp.cumsum(p)))


def test_numpy_sequential_cumsum_is_not_jax():
    """Why cumsum32 exists: at 2^18 rows numpy's sequential fp32 prefix
    sum differs from jnp.cumsum in most outputs."""
    v = _valid(1 << 18, 5)
    p = D.valid_probs(v)
    differ = np.mean(_bits(np.cumsum(p, dtype=np.float32)) != _bits(jnp.cumsum(jnp.asarray(p))))
    assert differ > 0.5


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_choice_with_p_equals_jax(seed, n):
    v = _valid(n, seed + n)
    p = jnp.asarray(v, jnp.float32)
    p = p / jnp.sum(p)
    for c in (64, 4096):
        want = np.asarray(jax.random.choice(jax.random.key(seed), n, (c,), p=p))
        np.testing.assert_array_equal(D.choice_p(D.key(seed), n, c, D.valid_probs(v)), want)


def test_choice_with_no_live_row_equals_jax():
    v = np.zeros(50, bool)
    p = jnp.asarray(v, jnp.float32)
    p = p / jnp.sum(p)  # 0/0: JAX's weights are NaN
    want = np.asarray(jax.random.choice(jax.random.key(0), 50, (8,), p=p))
    np.testing.assert_array_equal(D.choice_p(D.key(0), 50, 8, D.valid_probs(v)), want)


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _clustered(n_clusters=64, per=64, d=32, seed=0):
    rng = np.random.default_rng(seed)
    centers = _norm(rng.standard_normal((n_clusters, d)))
    rows = centers.repeat(per, axis=0) + 0.15 * rng.standard_normal((n_clusters * per, d))
    return _norm(rows).astype(np.float32), rng


@pytest.mark.parametrize(
    "kw",
    [dict(n_clusters=64, seed=0), dict(n_clusters=32, seed=3, sample=1024), dict(seed=12345, sample=2048)],
    ids=["full", "sampled", "default-clusters"],
)
def test_train_centroids_equal_jax(kw):
    rows, _ = _clustered()
    valid = np.ones(len(rows), bool)
    valid[::13] = False
    want = np.asarray(jivf.train_centroids(rows, valid, **kw))
    got = train_centroids(rows, valid, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_same_clusters_and_ids_as_jax_from_the_same_seed():
    rows, rng = _clustered()
    valid = np.ones(len(rows), bool)
    j_index = jivf.build_ivf(rows, valid, n_clusters=64, seed=0)
    t_index = build_ivf(rows, valid, n_clusters=64, seed=0)
    j_nonempty = int((np.asarray(j_index.members) >= 0).any(axis=1).sum())
    t_nonempty = int((t_index.members >= 0).any(dim=1).sum())
    assert t_nonempty == j_nonempty
    q = _norm(rows[rng.choice(len(rows), 32)] + 0.05 * rng.standard_normal((32, 32))).astype(np.float32)
    _, ji = jivf.ivf_topk(jnp.asarray(q), j_index, k=10, n_probe=2)
    _, ti = ivf_topk(torch.from_numpy(q), t_index, k=10, n_probe=2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
