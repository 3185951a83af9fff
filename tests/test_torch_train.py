"""CLIP contrastive training of the PyTorch port against the JAX package.

One JAX init tree of the ``tiny`` config (``init_params(jax.random.key(0))``)
is carried across through ``models/clip/bridge.py``; the batch is made
from a numpy seed; both sides run on the CPU.

- ``mha_xla`` against ``_mha_xla``: fp32 within rtol/atol 2e-5, causal and
  not; bf16 within one bf16 rounding (rtol = atol = 2^-7), with at most
  0.1% of the outputs differing at all (the two follow the same rounding
  steps; only the order of the fp32 sums differs).
- ``clip_forward``'s embeddings and logits against JAX's at fp32 (rtol 1e-5,
  atol 1e-6).
- The loss (rtol 1e-5) and every gradient leaf against
  ``jax.value_and_grad`` of JAX's loss: per leaf, the largest difference
  within 1e-4 of the leaf's largest magnitude plus 1e-8 (the key biases'
  gradient is zero in exact arithmetic: both sides give rounding noise).
- Parameters, ``count``, ``mu`` and ``nu`` after two steps against optax's
  (params atol 1e-6; moments per leaf 1e-4 of the largest magnitude plus
  1e-10 for ``mu`` and 1e-14 for ``nu``).
- The logit-scale clamp, ``weight_decay * p`` on a LayerNorm leaf and the
  logit scale, bf16 differentiation (the port of
  tests/test_parallel.py::test_train_step_bf16_grad), and a training step
  with a ``flash_mha`` that raises in place: the step never reaches K2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imatch_tpu.models.clip import configs as jax_configs
from imatch_tpu.models.clip.model import clip_forward as jax_clip_forward
from imatch_tpu.models.clip.model import init_params
from imatch_tpu.ops.attention import _mha_xla
from imatch_tpu.parallel import train as jax_train
from imatch_tpu_torch.models.clip.bridge import named_to_numpy, params_to_numpy
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.models.clip.model import clip_forward, encode_image
from imatch_tpu_torch.ops import attention
from imatch_tpu_torch.parallel import TrainState, clip_loss, init_train_state, make_mesh, make_train_step
from imatch_tpu_torch.parallel.sharding import gather_named
from imatch_tpu_torch.parallel.train import (
    B1,
    MAX_LOGIT_SCALE,
    AdamW,
    loss_and_grads,
    make_optimizer,
)

JTINY = jax_configs.TINY
HIGHEST = jax.lax.Precision.HIGHEST


def _batch(seed=0, b=4):
    rng = np.random.default_rng(seed)
    px = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    tok = rng.integers(0, TINY.text.eos_token_id, (b, TINY.text.max_positions)).astype(np.int32)
    for i, n in enumerate(rng.integers(3, TINY.text.max_positions, b)):
        tok[i, n:] = TINY.text.eos_token_id  # eos-padded, as the tokenizer pads
    return px, tok


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, init_params(jax.random.key(0), JTINY))


@pytest.fixture(scope="module")
def batch():
    return _batch()


def _leaf_close(want, got, rel, atol):
    """Per leaf: max |got - want| <= rel * max |want| + atol."""

    def check(path, a, b):
        a = np.asarray(a, np.float64)
        err = np.abs(a - np.asarray(b, np.float64)).max(initial=0.0)
        bound = rel * np.abs(a).max(initial=0.0) + atol
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)

    jax.tree_util.tree_map_with_path(check, want, got)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [2 * rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 4, 17, 16), (2, 12, 77, 64)])
def test_mha_xla_matches_jax_fp32(shape, causal):
    q, k, v = _qkv(shape)
    want = np.asarray(_mha_xla(*map(jnp.asarray, (q, k, v)), causal=causal, precision=HIGHEST))
    got = attention.mha_xla(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 4, 17, 16), (1, 16, 257, 64)])
def test_mha_xla_matches_jax_bf16(shape, causal):
    q, k, v = _qkv(shape, seed=1)
    want = np.asarray(
        _mha_xla(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=causal).astype(
            jnp.float32
        )
    )
    got = attention.mha_xla(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), causal=causal)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=2.0**-7)
    assert (got != want).mean() <= 1e-3


def test_mha_impl_dispatch(monkeypatch):
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 2, 8, 8)))
    calls = []
    monkeypatch.setattr(attention, "flash_mha", lambda *a, **kw: calls.append(1) or a[0])
    attention.mha(q, k, v, impl="auto")
    attention.mha(q, k, v, impl="kernel")
    assert len(calls) == 2
    torch.testing.assert_close(attention.mha(q, k, v, impl="xla"), attention.mha_xla(q, k, v))
    assert len(calls) == 2
    with pytest.raises(ValueError, match="attention impl"):
        attention.mha(q, k, v, impl="pallas")


@pytest.fixture(scope="module")
def jax_ref(tree, batch):
    """JAX's forward, loss and gradients at fp32 on the tiny tree."""
    px, tok = map(jnp.asarray, batch)

    def loss_fn(p):
        img, txt, logits = jax_clip_forward(p, px, tok, JTINY)
        return jax_train.clip_loss(logits), (img, txt, logits)

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, (img, txt, logits)), grads = fn(jax.tree.map(jnp.asarray, tree))
    return {
        "img": np.asarray(img),
        "txt": np.asarray(txt),
        "logits": np.asarray(logits),
        "loss": float(loss),
        "grads": jax.tree.map(np.asarray, grads),
    }


@pytest.fixture
def state(tree):
    st, _ = init_train_state(tree, TINY, device="cpu")
    return st


def test_clip_forward_matches_jax_fp32(state, batch, jax_ref):
    px, tok = map(torch.from_numpy, batch)
    img, txt, logits = clip_forward(state.params, px, tok)
    for got, name in ((img, "img"), (txt, "txt"), (logits, "logits")):
        assert got.dtype == torch.float32 and got.requires_grad
        np.testing.assert_allclose(got.detach().numpy(), jax_ref[name], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(clip_loss(logits.detach())), jax_ref["loss"], rtol=1e-5
    )


def test_loss_and_every_gradient_match_jax(state, batch, jax_ref):
    px, tok = map(torch.from_numpy, batch)
    loss, grads = loss_and_grads(state.params, px, tok)
    np.testing.assert_allclose(float(loss), jax_ref["loss"], rtol=1e-5)
    assert set(grads) == {n for n, _ in state.params.named_parameters()}
    got = named_to_numpy(grads, TINY)
    assert jax.tree.structure(got) == jax.tree.structure(jax_ref["grads"])
    _leaf_close(jax_ref["grads"], got, 1e-4, 1e-8)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's jitted train step with the default optimizer, compiled once."""
    tx = jax_train.make_optimizer()
    return tx, jax_train.make_train_step(JTINY, tx)


def test_two_steps_match_optax(state, batch, jax_step):
    tx_j, step_j = jax_step
    st_j, _ = jax_train.init_train_state(jax.random.key(0), JTINY, tx_j)
    step = make_train_step(TINY, make_optimizer())
    for seed in (0, 1):
        px, tok = _batch(seed)
        st_j, loss_j = step_j(st_j, jnp.asarray(px), jnp.asarray(tok))
        state, loss = step(state, px, tok)
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    assert state.step == int(st_j.step) == 2
    adam = st_j.opt_state[1][0]
    assert int(state.opt_state.count) == int(adam.count) == 2
    assert state.opt_state.count.dtype == torch.int32
    _leaf_close(jax.tree.map(np.asarray, st_j.params), params_to_numpy(state.params), 0.0, 1e-6)
    _leaf_close(jax.tree.map(np.asarray, adam.mu), named_to_numpy(state.opt_state.mu, TINY), 1e-4, 1e-10)
    _leaf_close(jax.tree.map(np.asarray, adam.nu), named_to_numpy(state.opt_state.nu, TINY), 1e-4, 1e-14)


def test_logit_scale_clamped_like_jax(tree, batch, jax_step):
    hot = dict(tree, logit_scale=np.float32(5.0))
    tx_j, step_j = jax_step
    params_j = jax.tree.map(jnp.asarray, hot)
    st_j = jax_train.TrainState(jnp.zeros((), jnp.int32), params_j, tx_j.init(params_j))
    st_j, _ = step_j(st_j, *map(jnp.asarray, batch))
    st, tx = init_train_state(hot, TINY, device="cpu")
    st, _ = make_train_step(TINY, tx)(st, *batch)
    got = float(st.params.logit_scale)
    assert got == float(st_j.params["logit_scale"]) == np.float32(MAX_LOGIT_SCALE)
    assert jax_train.MAX_LOGIT_SCALE == MAX_LOGIT_SCALE


def test_weight_decay_on_every_leaf(state):
    """Zero gradients leave only the decoupled decay: p - lr * wd * p, on
    a LayerNorm scale and on the logit scale too."""
    tx = AdamW(lr=1e-2, weight_decay=0.5)
    opt = tx.init(state.params)
    named = dict(state.params.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    zeros = {n: torch.zeros_like(p) for n, p in named.items()}
    opt = tx.update(zeros, opt, state.params)
    assert int(opt.count) == 1
    for n in ("vision.pre_ln.weight", "text.encoder.layers.0.ln1.weight", "logit_scale"):
        want = before[n] + (before[n] * 0.5) * -1e-2
        torch.testing.assert_close(named[n].detach(), want, rtol=0, atol=0)
    ln = named["vision.pre_ln.weight"].detach()
    assert torch.all(ln == np.float32(1.0) + np.float32(-0.005)) and torch.all(ln < 1.0)


def test_global_norm_clip_divides_by_the_norm(state, batch):
    """optax's clip: g / norm * clip (torch's clip_grad_norm_ divides by
    norm + 1e-6). The first moment after one update is (1 - b1) times the
    clipped gradient."""
    px, tok = map(torch.from_numpy, batch)
    _, grads = loss_and_grads(state.params, px, tok)
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
    clip = float(norm) / 4
    tx = AdamW(grad_clip=clip)
    opt = tx.update(grads, tx.init(state.params), state.params)
    for n, g in grads.items():
        torch.testing.assert_close(opt.mu[n], g / norm * clip * (1 - B1), rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_step_differentiates(tree, batch, dtype):
    """The port of test_train_step_bf16_grad, at both compute dtypes: the
    loss is finite and so is every gradient; the q, k and v projections
    get gradients through the attention."""
    st, tx = init_train_state(tree, TINY, device="cpu")
    loss, grads = loss_and_grads(st.params, *map(torch.from_numpy, batch), dtype=dtype)
    assert torch.isfinite(loss)
    d = TINY.vision.hidden_size
    for n, g in grads.items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), n
    for i in range(TINY.vision.num_layers):
        g = grads[f"vision.encoder.layers.{i}.qkv.weight"]
        assert all(g[j * d : (j + 1) * d].abs().max() > 0 for j in range(3))
    st, loss2 = make_train_step(TINY, tx, dtype=dtype)(st, *batch)
    assert torch.isfinite(loss2) and st.step == 1
    assert all(torch.isfinite(p).all() for p in st.params.parameters())


def test_training_never_reaches_k2(tree, batch, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the training path reached K2's wrapper")

    monkeypatch.setattr(attention, "flash_mha", refuse)
    for dtype in (torch.float32, torch.bfloat16):
        st, tx = init_train_state(tree, TINY, device="cpu")
        st, loss = make_train_step(TINY, tx, dtype=dtype)(st, *batch)
        assert torch.isfinite(loss)
    # the serving towers still go through the (refusing) wrapper
    with pytest.raises(AssertionError, match="reached K2"):
        encode_image(st.params, torch.from_numpy(batch[0]))


def test_init_from_seed_and_mesh(batch):
    a, _ = init_train_state(7, TINY, device="cpu")
    b, _ = init_train_state(7, TINY, mesh=["cpu"])
    assert isinstance(a, TrainState) and a.step == 0
    for (n, p), (_, q) in zip(a.params.named_parameters(), b.params.named_parameters()):
        assert p.dtype == torch.float32 and p.requires_grad and torch.equal(p, q), n
    assert all(float(m.abs().max()) == 0 for m in a.opt_state.mu.values())
    # a device list is the grid's data axis: the same masters, unsharded;
    # a step over 4 data shards splits the batch and equals one device's
    c, tx = init_train_state(7, TINY, mesh=["cpu", "cpu"])
    assert not len(c.params.peers)
    for (n, p), (_, q) in zip(a.params.named_parameters(), c.params.named_parameters()):
        assert torch.equal(p, q), n
    _, want = make_train_step(TINY, tx)(a, *batch)
    _, got = make_train_step(TINY, tx, mesh=["cpu"] * 4)(c, *batch)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5)
    # model_parallel 2: shard 0 and one peer holding the split slices
    d, _ = init_train_state(7, TINY, mesh=make_mesh(2, ["cpu", "cpu"]))
    assert len(d.params.peers) == 1
    full = gather_named(dict(d.params.named_parameters()), d.params)
    b_named = dict(b.params.named_parameters())
    assert set(full) == set(b_named) and all(torch.equal(full[n], b_named[n]) for n in full)


def test_wider_tree_refused(tree):
    wide = dataclasses.replace(
        TINY, vision=dataclasses.replace(TINY.vision, hidden_size=128)
    )
    with pytest.raises(ValueError):
        init_train_state(tree, wide, device="cpu")
