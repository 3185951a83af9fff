"""The int8 score tier and the tilemax-host capacity tier of the PyTorch
port against the JAX package.

- Codes and scales of both prepares are bit-identical to JAX's
  (``_prepare_device_corpus(score_dtype=jnp.int8)``: XLA folds
  ``amax / 127.0`` into a multiply by fp32(1/127) under jit, which the port
  writes out; ``prepare_host_rescore_corpus``: numpy's true division).
- ``int8_scores`` and the int8 tile maxima equal JAX's ``_int8_scores`` as
  the JAX engines run it (under jit, for the same reason) exactly: integer
  dots are exact and the two dequantize multiplies round alike.
- The engines: ids identical, scores within 1e-5 (tilemax) and 1e-6
  (tilemax-host: the same numpy rescore); the stores: identical ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imatch_tpu.index import search as jsearch
from imatch_tpu.index.store import VectorStore as JaxStore
from imatch_tpu_torch.index.search import (
    HOST_MARGIN,
    host_rescore_topk,
    int8_scores,
    int8_tile_max,
    phase1_tiles,
    prepare_device_corpus,
    prepare_host_rescore_corpus,
    tilemax_topk,
)
from imatch_tpu_torch.index.store import VectorStore
from imatch_tpu_torch.ops.kernels.topk import tile_max_int8

NEG_INF = -3.0e38


def _corpus(seed, n, d, n_dead=30):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((n, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c[3] = 0  # a zero row: scale 1, codes 0
    valid = np.ones((n,), bool)
    valid[rng.integers(0, n, n_dead)] = False
    q = c[10:16] + 0.02 * rng.standard_normal((6, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return c, valid, q


@pytest.mark.parametrize("n,d", [(1000, 40), (3000, 64), (700, 768)])
def test_int8_codes_and_scales_match_jax(n, d):
    c, valid, _ = _corpus(n, n, d)
    jdc = jsearch.prepare_device_corpus(
        jnp.asarray(c), jnp.asarray(valid), tile_n=256, score_dtype=jnp.int8
    )
    dc = prepare_device_corpus(c, valid, tile_n=256, score_dtype=torch.int8, margin=16)
    assert dc.scoring.dtype == torch.int8 and dc.scoring.shape[1] % 16 == 0
    np.testing.assert_array_equal(dc.scoring[:, :d].numpy(), np.asarray(jdc.scoring))
    assert not dc.scoring[:, d:].any()
    np.testing.assert_array_equal(dc.scale.numpy(), np.asarray(jdc.scale))
    assert float(dc.scale[3]) == 1.0 and not dc.scoring[3].any()

    jhc = jsearch.prepare_host_rescore_corpus(c, valid, tile_n=512)
    hc = prepare_host_rescore_corpus(c, valid, tile_n=512)
    np.testing.assert_array_equal(hc.scoring[:, :d].numpy(), np.asarray(jhc.scoring))
    np.testing.assert_array_equal(hc.scale.numpy(), np.asarray(jhc.scale))
    np.testing.assert_array_equal(hc.valid.numpy(), np.asarray(jhc.valid))
    assert hc.n == jhc.n == n


@pytest.mark.parametrize("d", [40, 768])
def test_int8_scores_and_tile_max_match_jax(d):
    c, valid, q = _corpus(7, 2048, d)
    jdc = jsearch.prepare_device_corpus(
        jnp.asarray(c), jnp.asarray(valid), tile_n=256, score_dtype=jnp.int8
    )
    dc = prepare_device_corpus(c, valid, tile_n=256, score_dtype=torch.int8)
    want = np.asarray(jax.jit(jsearch._int8_scores)(jnp.asarray(q), jdc.scoring, jdc.scale))
    got = int8_scores(torch.from_numpy(q), dc.scoring, dc.scale).numpy()
    np.testing.assert_array_equal(got, want)
    want_tm = np.where(valid[None, :], want, NEG_INF).reshape(6, 8, 256).max(axis=2)
    valid_tile = valid.copy()
    valid_tile[512:768] = False  # a tile with no valid row
    tm = int8_tile_max(torch.from_numpy(q), dc.scoring, dc.valid, dc.scale, 256).numpy()
    np.testing.assert_array_equal(tm, want_tm.astype(np.float32))
    tm_dead = int8_tile_max(
        torch.from_numpy(q), dc.scoring, torch.from_numpy(valid_tile), dc.scale, 256
    ).numpy()
    assert (tm_dead[:, 2] == np.float32(NEG_INF)).all()


@pytest.mark.parametrize("k", [10, 37])
def test_tilemax_topk_int8_matches_jax(k):
    c, valid, q = _corpus(11, 5000, 48)
    jdc = jsearch.prepare_device_corpus(
        jnp.asarray(c), jnp.asarray(valid), tile_n=128, score_dtype=jnp.int8
    )
    ref_s, ref_i = jsearch.tilemax_topk(jnp.asarray(q), jdc, k=k)
    dc = prepare_device_corpus(c, valid, tile_n=128, score_dtype=torch.int8, margin=16)
    s, i = tilemax_topk(torch.from_numpy(q), dc, k=k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=0, atol=1e-5)


def test_tilemax_topk_int8_scoring():
    """tests/test_index.py::test_tilemax_topk_int8_scoring on the port:
    final scores are exact fp32 and the ids are the fp64 reference's."""
    rng = np.random.default_rng(7)
    n, d, nq, k = 4000, 64, 4, 10
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = corpus[:nq]
    dc8 = prepare_device_corpus(
        corpus, np.ones(n, bool), tile_n=256, score_dtype=torch.int8, margin=16
    )
    assert dc8.scoring.dtype == torch.int8 and dc8.scale is not None
    s8, i8 = tilemax_topk(torch.from_numpy(queries), dc8, k=k)
    ref = queries @ corpus.astype(np.float64).T
    for qi in range(nq):
        order = np.argsort(-ref[qi], kind="stable")[:k]
        assert i8[qi].tolist() == order.tolist()
        np.testing.assert_allclose(s8[qi].numpy(), ref[qi][order], atol=1e-5)


@pytest.mark.parametrize("k", [10, 100])
def test_host_rescore_topk_matches_jax(k):
    c, valid, q = _corpus(13, 6000, 32, n_dead=200)
    jhc = jsearch.prepare_host_rescore_corpus(c, valid)
    hc = prepare_host_rescore_corpus(c, valid)
    jt = np.asarray(
        jsearch._phase1_tiles(
            jnp.asarray(q), jhc.scoring, jhc.valid, jhc.scale, k=k, tile_n=jhc.tile_n
        )
    )
    tiles = phase1_tiles(torch.from_numpy(q), hc, k=k).numpy()
    assert tiles.shape[1] == min(k + HOST_MARGIN, 12)
    np.testing.assert_array_equal(tiles, jt)
    ref_s, ref_i = jsearch.host_rescore_topk(q, jhc, k=k)
    s, i = host_rescore_topk(torch.from_numpy(q), hc, k=k)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, rtol=0, atol=1e-6)
    assert not np.isin(i, np.nonzero(~valid)[0]).any()


def test_int8_wrapper_refuses_bad_cuda_inputs():
    """The CUDA path validates before launching (meta tensors stand in for
    CUDA ones)."""
    from imatch_tpu_torch.ops.kernels.topk import _check_int8

    qi = torch.empty((2, 24), device="meta", dtype=torch.int8)
    c = torch.empty((64, 24), device="meta", dtype=torch.int8)
    qs = torch.empty((2,), device="meta")
    sc = torch.empty((64,), device="meta")
    v = torch.empty((64,), device="meta", dtype=torch.bool)
    with pytest.raises(ValueError, match="multiple of 16"):
        _check_int8(qi, c, qs, sc, v, 32)
    qi, c = qi[:, :16], torch.empty((64, 16), device="meta", dtype=torch.int8)
    with pytest.raises(TypeError):
        _check_int8(qi.float(), c, qs, sc, v, 32)
    with pytest.raises(ValueError, match="scale"):
        _check_int8(qi, c, qs, sc[:10], v, 32)
    with pytest.raises(ValueError, match="not a multiple"):
        _check_int8(qi.contiguous(), c, qs, sc, v, 48)
    assert tile_max_int8.launches == 0


def _store_rows(seed=17, n=3000, d=32):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb, [f"r{i:05d}" for i in range(n)], emb[rng.integers(0, n, 5)]


def test_store_tiers_match_each_other_and_jax():
    """tests/test_index.py::test_tilemax_host_matches_device_int8 on both
    packages: the tilemax int8 engine and the tilemax-host tier give
    identical ids, to each other and to the JAX stores, and a delete flows
    through."""
    emb, ids, q = _store_rows()
    d = emb.shape[1]
    stores = {
        "jax_dev": JaxStore(dim=d, engine="tilemax", score_dtype=jnp.int8),
        "jax_host": JaxStore(dim=d, engine="tilemax-host"),
        "dev": VectorStore(dim=d, engine="tilemax", score_dtype="int8", device="cpu"),
        "host": VectorStore(dim=d, engine="tilemax-host", device="cpu"),
    }
    for st in stores.values():
        st.add(ids=ids, embeddings=emb)
    res = {name: st.query(q, n_results=10) for name, st in stores.items()}
    for name in ("jax_host", "dev", "host"):
        assert res[name]["ids"] == res["jax_dev"]["ids"], name
        for a, b in zip(res[name]["distances"], res["jax_dev"]["distances"]):
            np.testing.assert_allclose(a, b, atol=1e-5)
    assert stores["dev"].stats()["last_build"]["engine"] == "tilemax"
    assert stores["host"].stats()["last_build"]["engine"] == "tilemax-host"
    gone = res["host"]["ids"][0][0]
    for name in ("jax_host", "host", "dev"):
        stores[name].delete([gone])
    after = {name: stores[name].query(q[:1], n_results=5)["ids"] for name in ("jax_host", "host", "dev")}
    assert gone not in after["host"][0]
    assert after["host"] == after["jax_host"] == after["dev"]


def test_auto_engine_capacity_escalation(monkeypatch):
    """The single-device half of tests/test_index.py::
    test_auto_engine_capacity_escalation: with IMATCH_INDEX_ENGINE=auto a
    build escalates to tilemax-host when the device copies exceed
    IMATCH_AUTO_HBM_FRAC of the budget; results stay the exact engine's; a
    generous budget does not escalate and a non-auto engine never does."""
    rng = np.random.default_rng(23)
    e = rng.standard_normal((64, 32)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    ids = [f"r{j}" for j in range(64)]
    exact = VectorStore(dim=32, engine="tilemax", device="cpu")
    exact.add(ids=ids, embeddings=e)
    r_e = exact.query(e[:3], n_results=5)

    monkeypatch.setenv("IMATCH_DEVICE_BYTES_BUDGET", str(4096))
    auto = VectorStore(dim=32, engine="auto", device="cpu")
    assert auto.engine == "tilemax"  # the default stays
    auto.add(ids=ids, embeddings=e)
    r_a = auto.query(e[:3], n_results=5)
    assert auto.stats()["last_build"]["engine"] == "tilemax-host"
    assert auto.engine == "tilemax"
    assert r_a["ids"] == r_e["ids"]
    np.testing.assert_allclose(r_a["distances"], r_e["distances"], atol=1e-4)

    pinned = VectorStore(dim=32, engine="tilemax", device="cpu")
    pinned.add(ids=ids, embeddings=e)
    pinned.query(e[:1], n_results=5)
    assert pinned.stats()["last_build"]["engine"] == "tilemax"

    monkeypatch.setenv("IMATCH_DEVICE_BYTES_BUDGET", str(1 << 30))
    auto2 = VectorStore(dim=32, engine="auto", device="cpu")
    auto2.add(ids=ids, embeddings=e)
    auto2.query(e[:1], n_results=5)
    assert auto2.stats()["last_build"]["engine"] == "tilemax"

    monkeypatch.delenv("IMATCH_DEVICE_BYTES_BUDGET")
    auto3 = VectorStore(dim=32, engine="auto", device="cpu")  # no budget on the CPU
    auto3.add(ids=ids, embeddings=e)
    auto3.query(e[:1], n_results=5)
    assert auto3.stats()["last_build"]["engine"] == "tilemax"


@pytest.mark.parametrize("n_rows", [1000, 1024, 1025, 1500])
def test_auto_escalation_threshold_matches_jax(monkeypatch, n_rows):
    """Both packages size the auto footprint from the slot capacity (1024,
    doubling), not from the live rows: with a limit of 300000 bytes, 1024
    slots of 32 bf16 + fp32 (196608 B) stay on tilemax and 2048 (393216 B)
    escalate, though 1025-1500 live rows padded to 512-row tiles (294912 B)
    would fit. The port's decision equals JAX ``_engine_for``'s."""
    monkeypatch.delenv("IMATCH_SCORE_DTYPE", raising=False)
    monkeypatch.delenv("IMATCH_AUTO_HBM_FRAC", raising=False)
    monkeypatch.setenv("IMATCH_DEVICE_BYTES_BUDGET", str(600000))
    rng = np.random.default_rng(n_rows)
    e = rng.standard_normal((n_rows, 32)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    ids = [f"r{j}" for j in range(n_rows)]
    ref = JaxStore(dim=32, engine="tilemax")
    ref._auto = True  # auto resolves to the sharded engine on the test mesh
    ref.add(ids=ids, embeddings=e)
    want = ref._engine_for(ref._emb.copy())
    auto = VectorStore(dim=32, engine="auto", device="cpu")
    auto.add(ids=ids, embeddings=e)
    auto.query(e[:1], n_results=3)
    got = auto.stats()["last_build"]["engine"]
    assert got == want == ("tilemax-host" if n_rows > 1024 else "tilemax")


def test_pallas_int8_coerces_and_margins(monkeypatch):
    monkeypatch.delenv("IMATCH_TILEMAX_MARGIN", raising=False)
    emb, ids, q = _store_rows(n=600)
    pal = VectorStore(dim=32, engine="pallas", score_dtype="int8", device="cpu")
    pal.add(ids=ids, embeddings=emb)
    pal.query(q, n_results=3)
    eng, state = pal._device_corpus
    assert eng == "pallas" and state.scoring.dtype == torch.bfloat16 and state.margin == 4
    ref = JaxStore(dim=32, engine="pallas", score_dtype=jnp.int8)
    ref.add(ids=ids, embeddings=emb)
    assert pal.query(q, n_results=3)["ids"] == ref.query(q, n_results=3)["ids"]

    assert VectorStore(engine="tilemax", score_dtype="int8", device="cpu").margin == 16
    assert VectorStore(engine="tilemax", device="cpu").margin == 4
    assert VectorStore(engine="tilemax-host", device="cpu").margin == HOST_MARGIN
    monkeypatch.setenv("IMATCH_TILEMAX_MARGIN", "7")
    assert VectorStore(engine="tilemax", score_dtype="int8", device="cpu").margin == 7
    assert VectorStore(engine="tilemax", device="cpu").margin == 7
    monkeypatch.setenv("IMATCH_SCORE_DTYPE", "int8")
    st = VectorStore(engine="tilemax", device="cpu")
    assert st.score_dtype == torch.int8 and st.stats()["score_dtype"] == "int8"
