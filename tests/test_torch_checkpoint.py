"""Checkpoints of the PyTorch port's training state, against the JAX package.

- The port of tests/test_parallel.py::test_checkpoint_roundtrip: a state
  restored into a fresh template continues the uninterrupted trajectory
  (loss rtol 1e-6, parameters rtol 1e-6 / atol 1e-7).
- The npz keys, shapes and dtypes equal those JAX's ``save_checkpoint``
  writes for the ``tiny`` config: 140 leaves.
- Across packages, both ways: a JAX checkpoint restores in the port and
  the port's next step equals JAX's next step (loss rtol 1e-5, parameters
  atol 1e-6); a port checkpoint restores through JAX's
  ``restore_checkpoint`` (which raises on a missing leaf) and JAX's next
  step equals the port's.
- A checkpoint of another config raises ``ValueError``, a missing leaf
  ``KeyError``; ``latest_step`` of a missing or empty directory is None.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imatch_tpu.models.clip import configs as jax_configs
from imatch_tpu.parallel import checkpoint as jax_ckpt
from imatch_tpu.parallel import train as jax_train
from imatch_tpu_torch.models.clip.bridge import params_to_numpy
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.parallel.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from imatch_tpu_torch.parallel.train import init_train_state, make_optimizer, make_train_step

JTINY = jax_configs.TINY


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    px = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    tok = rng.integers(0, TINY.text.vocab_size, (b, TINY.text.max_positions)).astype(np.int32)
    return px, tok


def _params_close(want, got, rtol, atol):
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol, atol=atol),
        jax.tree.map(np.asarray, want),
        got,
    )


@pytest.fixture(scope="module")
def jax_step():
    tx = jax_train.make_optimizer()
    return tx, jax_train.make_train_step(JTINY, tx)


def test_checkpoint_roundtrip(tmp_path):
    tx = make_optimizer()
    state, _ = init_train_state(3, TINY, tx, device="cpu")
    step = make_train_step(TINY, tx)
    px, tok = _batch(0)
    state, _ = step(state, px, tok)
    save_checkpoint(str(tmp_path), state)
    assert latest_step(str(tmp_path)) == 1

    state2, loss2 = step(state, px, tok)  # continue the original

    fresh, _ = init_train_state(99, TINY, tx, device="cpu")
    restored = restore_checkpoint(str(tmp_path), fresh)
    assert restored.step == 1 and int(restored.opt_state.count) == 1
    restored2, loss2r = step(restored, px, tok)
    np.testing.assert_allclose(float(loss2r), float(loss2), rtol=1e-6)
    _params_close(params_to_numpy(state2.params), params_to_numpy(restored2.params), 1e-6, 1e-7)
    for n, m in state2.opt_state.mu.items():
        torch.testing.assert_close(restored2.opt_state.mu[n], m, rtol=1e-6, atol=1e-12)


def test_keys_equal_jax_keys(tmp_path, jax_step):
    tx_j, _ = jax_step
    st_j, _ = jax_train.init_train_state(jax.random.key(0), JTINY, tx_j)
    with np.load(jax_ckpt.save_checkpoint(str(tmp_path / "jax"), st_j)) as z:
        want = {k: (z[k].shape, z[k].dtype) for k in z.files}
    st, _ = init_train_state(0, TINY, device="cpu")
    with np.load(save_checkpoint(str(tmp_path / "port"), st)) as z:
        got = {k: (z[k].shape, z[k].dtype) for k in z.files}
    assert len(want) == 140
    assert got == want
    assert {"step", "opt_state/1/0/count", "params/vision/layers/attn/wq"} <= set(got)
    assert "opt_state/1/0/mu/text/layers/mlp/w2" in got and "opt_state/1/0/nu/logit_scale" in got


def test_jax_checkpoint_continues_in_the_port(tmp_path, jax_step):
    tx_j, step_j = jax_step
    st_j, _ = jax_train.init_train_state(jax.random.key(5), JTINY, tx_j)
    st_j, _ = step_j(st_j, *map(jnp.asarray, _batch(1)))
    jax_ckpt.save_checkpoint(str(tmp_path), st_j)

    template, tx = init_train_state(0, TINY, device="cpu")
    st = restore_checkpoint(str(tmp_path), template)
    assert st.step == 1 and int(st.opt_state.count) == 1
    _params_close(st_j.params, params_to_numpy(st.params), 0, 0)  # fp32 leaves, exact

    px, tok = _batch(2)
    st_j, loss_j = step_j(st_j, jnp.asarray(px), jnp.asarray(tok))
    st, loss = make_train_step(TINY, tx)(st, px, tok)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    assert st.step == int(st_j.step) == 2
    _params_close(st_j.params, params_to_numpy(st.params), 0, 1e-6)


def test_port_checkpoint_continues_in_jax(tmp_path, jax_step):
    tx_j, step_j = jax_step
    st, tx = init_train_state(6, TINY, device="cpu")
    step = make_train_step(TINY, tx)
    st, _ = step(st, *_batch(3))
    save_checkpoint(str(tmp_path), st)

    template, _ = jax_train.init_train_state(jax.random.key(0), JTINY, tx_j)
    st_j = jax_ckpt.restore_checkpoint(str(tmp_path), template)  # KeyError on a missing leaf
    assert int(st_j.step) == 1 and int(st_j.opt_state[1][0].count) == 1
    st_j = jax.tree.map(jnp.asarray, st_j)

    px, tok = _batch(4)
    st_j, loss_j = step_j(st_j, jnp.asarray(px), jnp.asarray(tok))
    st, loss = step(st, px, tok)
    np.testing.assert_allclose(float(loss_j), float(loss), rtol=1e-5)
    _params_close(params_to_numpy(st.params), jax.tree.map(np.asarray, st_j.params), 0, 1e-6)


def test_wrong_config_and_missing_leaf_raise(tmp_path):
    st, _ = init_train_state(0, TINY, device="cpu")
    path = save_checkpoint(str(tmp_path), st)
    wide = dataclasses.replace(TINY, text=dataclasses.replace(TINY.text, hidden_size=64))
    other, _ = init_train_state(0, wide, device="cpu")
    with pytest.raises(ValueError, match="wrong config"):
        restore_checkpoint(str(tmp_path), other)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "opt_state/1/0/nu/logit_scale"}
    arrays["step"] = arrays["step"].reshape(1)  # a one-element scalar is reshaped
    np.savez(os.path.join(tmp_path, "step_00000002.npz"), **arrays)
    with pytest.raises(KeyError, match="nu/logit_scale"):
        restore_checkpoint(str(tmp_path), st)
    arrays["opt_state/1/0/nu/logit_scale"] = np.zeros((), np.float32)
    np.savez(os.path.join(tmp_path, "step_00000002.npz"), **arrays)
    assert restore_checkpoint(str(tmp_path), st).step == 0


def test_latest_step_of_missing_or_empty_directory(tmp_path):
    assert latest_step(str(tmp_path / "absent")) is None
    assert latest_step(str(tmp_path)) is None
    (tmp_path / "step_1.npz.tmp").write_bytes(b"")
    assert latest_step(str(tmp_path)) is None
    st, _ = init_train_state(0, TINY, device="cpu")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), st)
