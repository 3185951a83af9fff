"""The port's store runs its engine at JAX's bucketed k.

The JAX store queries its engine at ``k_c``, the next power of two of k,
and keeps the first k (imatch_tpu/index/store.py ``_k_bucket`` and
``_query_impl``), so phase 2 rescores ``k_c + margin`` candidate tiles.
On a corpus where more than k + margin tiles tie within bf16 rounding,
which tiles are candidates decides the answer. The corpus: 24 tiles of
512 rows, d = 16; one row a tile scores 0.9 + t * 1e-5 against the query
(identical in bf16), every other row scores 0. Port and JAX stores must
return the same ids on the tilemax (bf16 and int8) and pallas engines.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from imatch_tpu.index.store import VectorStore as JaxStore
from imatch_tpu_torch.index.store import VectorStore

TILE, N_TILES, D = 512, 24, 16


def _near_tie_corpus():
    rng = np.random.default_rng(0)
    rows = np.zeros((TILE * N_TILES, D), np.float32)
    far = rng.standard_normal((rows.shape[0], D - 2)).astype(np.float32)
    rows[:, 2:] = far / np.linalg.norm(far, axis=1, keepdims=True)  # score 0
    for t in range(N_TILES):
        c = 0.9 + t * 1e-5
        rows[t * TILE + 7] = 0
        rows[t * TILE + 7, :2] = (c, np.sqrt(1 - c * c))
    query = np.zeros((1, D), np.float32)
    query[0, 0] = 1.0
    return rows, [f"r{i:05d}" for i in range(len(rows))], query


@pytest.mark.parametrize("n_results", [10, 3])
@pytest.mark.parametrize("engine,dtype", [("tilemax", "bf16"), ("tilemax", "int8"), ("pallas", "bf16")])
def test_near_tie_corpus_matches_jax(engine, dtype, n_results):
    rows, ids, query = _near_tie_corpus()
    jax_dtype = {"bf16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    a = JaxStore(dim=D, engine=engine, score_dtype=jax_dtype)
    b = VectorStore(dim=D, engine=engine, score_dtype=dtype, device="cpu")
    for s in (a, b):
        s.add(ids=ids, embeddings=rows)
    ra = a.query(query, n_results=n_results)
    rb = b.query(query, n_results=n_results)
    assert rb["ids"] == ra["ids"]
    np.testing.assert_allclose(rb["distances"], ra["distances"], rtol=0, atol=1e-6)
    if (engine, dtype, n_results) == ("tilemax", "bf16", 10):
        # k_c = 16 and margin 4: tiles 0..19 are the candidates, so the
        # answer is the special rows of tiles 19..10
        assert rb["ids"][0] == [ids[t * TILE + 7] for t in range(19, 9, -1)]


def test_k_bucket():
    assert [VectorStore._k_bucket(k) for k in (1, 2, 3, 10, 16, 17, 1000)] == [
        1, 2, 4, 16, 16, 32, 1024,
    ]
    assert all(VectorStore._k_bucket(k) == JaxStore._k_bucket(k) for k in range(1, 2000))
