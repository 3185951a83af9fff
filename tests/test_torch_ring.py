"""The port's ring attention against the JAX package's, on 8 devices.

The port's ring runs over 8 logical ``cpu`` shards; JAX's over the 8
virtual host devices the root conftest.py asks for. Ports of
tests/test_parallel.py:280-310, and more:

- causal and not at (2, 3, 64, 16) fp32: the port against JAX's
  ``ring_attention`` and against ``_mha_xla`` at HIGHEST, within rtol and
  atol 2e-5; over the data axis of a (8, 1) and a (4, 2) grid and over the
  model axis of a (1, 8) grid;
- bf16 at (2, 4, 64, 32) against JAX's bf16 ring: both round one fp32
  result to bf16, so they differ by at most one bf16 ulp (2^-8 relative,
  2^-8 absolute below 1), the bar;
- an S the ring size does not divide, and q/k/v of other lengths, raise
  ``ValueError``;
- causal at P = 8, S = 8 (one position a shard: every shard but the last
  holds fully masked blocks) is finite and equals ``mha_xla``;
- the gradient of ``sum(ring)`` equals ``mha_xla``'s within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imatch_tpu.ops.attention import _mha_xla as jax_mha_xla
from imatch_tpu.parallel import mesh as jax_mesh
from imatch_tpu.parallel.ring_attention import ring_attention as jax_ring
from imatch_tpu_torch.ops.attention import mha_xla
from imatch_tpu_torch.parallel import make_mesh, ring_attention

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual host devices of the root conftest.py")


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("model, axis", [(1, "data"), (2, "data"), (8, "model")])
def test_ring_matches_jax_and_reference(causal, model, axis):
    q, k, v = _qkv((2, 3, 64, 16))
    got = ring_attention(*map(torch.from_numpy, (q, k, v)), mesh=make_mesh(model, CPU8), axis=axis, causal=causal)
    jmesh = jax_mesh.make_mesh(model_parallel=model)
    want = jax_ring(*map(jnp.asarray, (q, k, v)), mesh=jmesh, axis=axis, causal=causal)
    ref = jax_mha_xla(*map(jnp.asarray, (q, k, v)), causal=causal, precision=jax.lax.Precision.HIGHEST)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 64, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_bf16_matches_jax_bf16(causal):
    q, k, v = _qkv((2, 4, 64, 32), seed=1)
    got = ring_attention(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), mesh=make_mesh(CPU8), causal=causal
    )
    want = jax_ring(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), mesh=jax_mesh.make_mesh(model_parallel=1), causal=causal
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2.0**-8, atol=2.0**-8)


def test_ring_rejects_uneven_seq():
    x = torch.zeros((1, 1, 50, 8))
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(x, x, x, mesh=make_mesh(CPU8))


def test_ring_rejects_mismatched_lengths():
    q = torch.zeros((1, 1, 16, 8))
    kv = torch.zeros((1, 1, 24, 8))
    with pytest.raises(ValueError, match="must match"):
        ring_attention(q, kv, kv, mesh=make_mesh(CPU8))


def test_ring_fully_masked_hops_stay_finite():
    q, k, v = (torch.from_numpy(x) for x in _qkv((2, 2, 8, 8), seed=2))
    got = ring_attention(q, k, v, mesh=make_mesh(CPU8), causal=True)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), mha_xla(q, k, v, causal=True).numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_gradient_matches_reference(causal):
    grads = []
    for fn in (
        lambda q, k, v: ring_attention(q, k, v, mesh=make_mesh(CPU8), causal=causal),
        lambda q, k, v: mha_xla(q, k, v, causal=causal),
    ):
        q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _qkv((2, 3, 64, 16), seed=3))
        fn(q, k, v).sum().backward()
        grads.append([t.grad for t in (q, k, v)])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
