"""K1 and the two-phase top-k engine of the PyTorch port against JAX.

The port's engine (``index/search.py``: K1's plain version for phase 1 on
CPU tensors, then the PyTorch phase 2) is held to JAX
``pallas_cosine_topk(..., interpret=True)`` and ``cosine_topk`` at fp32:
identical ids, scores within rtol 1e-5 / atol 1e-6 (tests/test_pallas.py).
The Pallas kernel marks invalid rows with a penalty feature column, the
port with a mask; equal results show that phase 2 picks the same rows
either way. bf16 scoring is held to ``_tilemax_topk``. The CUDA kernel is held to
its plain version on the card by tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imatch_tpu.index.search import _tilemax_topk, cosine_topk
from imatch_tpu.index.search import prepare_device_corpus as jax_prepare
from imatch_tpu.ops.pallas import pallas_cosine_topk
from imatch_tpu_torch.index.search import prepare_device_corpus, tilemax_topk
from imatch_tpu_torch.ops.kernels.topk import NEG_INF, tile_max

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)


def _corpus(seed, n, d, n_dead=7):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    valid = np.ones((n,), bool)
    valid[rng.integers(0, n, n_dead)] = False
    return corpus, valid


def _port_topk(queries, corpus, valid, k, tile_n, score_dtype=torch.float32, margin=4):
    dc = prepare_device_corpus(
        corpus, valid, tile_n=tile_n, score_dtype=score_dtype, margin=margin
    )
    s, i = tilemax_topk(torch.from_numpy(queries), dc, k=k)
    return s.numpy(), i.numpy()


@pytest.mark.parametrize("n,k", [(100, 10), (5000, 25), (130, 200)])
def test_engine_matches_pallas_and_reference(n, k):
    corpus, valid = _corpus(2, n, 64)
    queries = corpus[:5]
    jc, jv, jq = jnp.asarray(corpus), jnp.asarray(valid), jnp.asarray(queries)
    ref_s, ref_i = cosine_topk(jq, jc, jv, k=k, score_dtype=jnp.float32)
    pal_s, pal_i = pallas_cosine_topk(
        jq, jc, jv, k=k, tile_n=128, score_dtype=jnp.float32, interpret=True
    )
    s, i = _port_topk(queries, corpus, valid, k, tile_n=128)
    np.testing.assert_array_equal(i, np.asarray(ref_i))
    np.testing.assert_array_equal(i, np.asarray(pal_i))
    np.testing.assert_allclose(s, np.asarray(ref_s), **SCORE_TOL)
    np.testing.assert_allclose(s, np.asarray(pal_s), **SCORE_TOL)


def test_k_beyond_valid_rows_pads_minus_one():
    corpus, valid = _corpus(4, 40, 32, n_dead=5)
    n_valid = int(valid.sum())
    s, i = _port_topk(corpus[:2], corpus, valid, k=60, tile_n=16)
    pal_s, pal_i = pallas_cosine_topk(
        jnp.asarray(corpus[:2]), jnp.asarray(corpus), jnp.asarray(valid),
        k=60, tile_n=16, score_dtype=jnp.float32, interpret=True,
    )
    np.testing.assert_array_equal(i, np.asarray(pal_i))
    assert (i[:, n_valid:] == -1).all() and (s[:, n_valid:] == np.float32(NEG_INF)).all()
    assert (i[:, :n_valid] >= 0).all()
    assert set(i[0, :n_valid]) == set(np.nonzero(valid)[0])


def test_duplicate_rows_tie_to_lower_index():
    # tests/test_pallas.py::test_pallas_topk_duplicate_rows_tie_break
    rng = np.random.default_rng(3)
    base = rng.standard_normal((40, 32)).astype(np.float32)
    corpus = np.concatenate([base, base[:10]])  # rows 40..49 duplicate 0..9
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    valid = np.ones((len(corpus),), bool)
    s, i = _port_topk(corpus[:3], corpus, valid, k=4, tile_n=16)
    np.testing.assert_array_equal(i[:, 0], np.arange(3))
    np.testing.assert_array_equal(i[:, 1], np.arange(3) + 40)
    pal_s, pal_i = pallas_cosine_topk(
        jnp.asarray(corpus[:3]), jnp.asarray(corpus), jnp.asarray(valid),
        k=4, tile_n=16, score_dtype=jnp.float32, interpret=True,
    )
    np.testing.assert_array_equal(i, np.asarray(pal_i))


@pytest.mark.parametrize("tile_n", [64, 512])
def test_bf16_engine_matches_tilemax(tile_n):
    corpus, valid = _corpus(6, 3000, 48, n_dead=40)
    queries = corpus[10:18] + 0.01
    queries /= np.linalg.norm(queries, axis=-1, keepdims=True)
    jdc = jax_prepare(jnp.asarray(corpus), jnp.asarray(valid), tile_n=tile_n)
    ref_s, ref_i = _tilemax_topk(
        jnp.asarray(queries), jdc.scoring, jdc.exact, jdc.valid, jdc.scale,
        k=20, tile_n=tile_n,
    )
    s, i = _port_topk(queries, corpus, valid, 20, tile_n, score_dtype=torch.bfloat16)
    np.testing.assert_array_equal(i, np.asarray(ref_i))
    np.testing.assert_allclose(s, np.asarray(ref_s), **SCORE_TOL)


def test_bf16_tile_maxima_match_jax_phase1():
    """Phase 1 itself: the tile maxima the port selects tiles from equal
    the JAX engine's (bf16 operands, fp32 accumulation; only the order
    of the fp32 sums differs)."""
    corpus, valid = _corpus(9, 1024, 40, n_dead=100)
    valid[128:256] = False  # one tile with no valid row
    queries = corpus[:4]
    jq = jnp.asarray(queries).astype(jnp.bfloat16)
    js = jnp.einsum(
        "qd,nd->qn", jq, jnp.asarray(corpus).astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )
    js = jnp.where(jnp.asarray(valid)[None, :], js, -3.0e38)
    ref = np.asarray(jnp.max(js.reshape(4, 8, 128), axis=2))
    dc = prepare_device_corpus(corpus, valid, tile_n=128, score_dtype=torch.bfloat16)
    qs = torch.zeros((4, dc.scoring.shape[1]), dtype=torch.bfloat16)
    qs[:, :40] = torch.from_numpy(queries)
    got = tile_max(qs, dc.scoring, dc.valid, 128).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert (got[:, 1] == np.float32(NEG_INF)).all()


def test_tile_max_refuses_bad_cuda_inputs():
    """The CUDA path validates before launching (meta tensors stand in
    for CUDA ones): odd widths and mixed dtypes raise."""
    from imatch_tpu_torch.ops.kernels.topk import _check

    q = torch.empty((2, 12), device="meta", dtype=torch.bfloat16)
    c = torch.empty((64, 12), device="meta", dtype=torch.bfloat16)
    v = torch.empty((64,), device="meta", dtype=torch.bool)
    with pytest.raises(ValueError, match="multiple of 8"):
        _check(q, c, v, 32)
    with pytest.raises(TypeError):
        _check(q.float(), c, v, 32)
    with pytest.raises(ValueError, match="not a multiple"):
        _check(q, c, v, 48)

