"""K2 (flash attention) in the PyTorch port against the JAX package.

The port's ``mha`` and ``flash_mha_plain`` (what a CPU tensor runs) are
held to JAX ``flash_mha(..., interpret=True)`` (the Pallas kernel, as the
JAX suite runs it on the CPU) and ``_mha_xla`` at HIGHEST, at fp32 with
rtol = atol = 2e-5, the bar of tests/test_pallas.py. The kernel itself
runs only on the card: tests/test_torch_kernels_cuda.py holds it to its
plain version there.

The bf16 kernel's rounding points (fp32 logits of the bf16 inputs, Dh^-1/2
on the logits, an online softmax over 64-key tiles in base 2, P rounded to
bf16 before P @ V, fp32 accumulation) are emulated in plain torch and held
to ``_mha_xla`` at fp32 HIGHEST on the same bf16 values, at the bar the
card holds the kernel to: 2 bf16 ulps at magnitude 1 absolute plus 2^-8
relative.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imatch_tpu.ops.attention import _mha_xla
from imatch_tpu.ops.pallas.flash_attention import flash_mha as jax_flash_mha
from imatch_tpu_torch.ops.attention import mha
from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha, flash_mha_plain

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _port(fn, q, k, v, **kw):
    return fn(*(torch.from_numpy(x) for x in (q, k, v)), **kw).numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [16, 50, 77])
def test_mha_matches_jax(causal, s):
    q, k, v = _qkv(s, (1, 2, s, 64))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    ref_xla = np.asarray(
        _mha_xla(jq, jk, jv, causal=causal, precision=jax.lax.Precision.HIGHEST)
    )
    ref_flash = np.asarray(jax_flash_mha(jq, jk, jv, causal=causal, interpret=True))
    got = _port(mha, q, k, v, causal=causal)
    np.testing.assert_allclose(got, ref_xla, **TOL)
    np.testing.assert_allclose(got, ref_flash, **TOL)
    np.testing.assert_allclose(_port(flash_mha_plain, q, k, v, causal=causal), ref_xla, **TOL)


def test_uneven_blocks_match_jax():
    # tests/test_pallas.py::test_flash_mha_uneven_blocks
    q, k, v = _qkv(1, (1, 2, 130, 32))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    ref = np.asarray(
        jax_flash_mha(jq, jk, jv, causal=True, block_q=64, block_k=64, interpret=True)
    )
    np.testing.assert_allclose(_port(mha, q, k, v, causal=True), ref, **TOL)


def test_mismatched_blocks_match_jax():
    # tests/test_pallas.py::test_flash_mismatched_blocks_cover_tail
    q, k, v = _qkv(5, (1, 2, 600, 16))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    ref = np.asarray(jax_flash_mha(jq, jk, jv, block_q=48, block_k=128, interpret=True))
    np.testing.assert_allclose(_port(mha, q, k, v), ref, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_rows_write_zero(causal):
    q, k, v = _qkv(7, (2, 2, 40, 64))
    got = _port(flash_mha, q, k, v, causal=causal, kv_len=0)
    assert np.array_equal(got, np.zeros_like(got))


def test_keys_past_kv_len_are_masked():
    """Masking keys at or past kv_len is attention over the first kv_len
    keys: the JAX reference on the truncated keys."""
    q, k, v = _qkv(8, (1, 3, 50, 64))
    n = 29
    ref = np.asarray(
        _mha_xla(
            jnp.asarray(q[:, :, :n]),
            jnp.asarray(k[:, :, :n]),
            jnp.asarray(v[:, :, :n]),
            causal=False,
            precision=jax.lax.Precision.HIGHEST,
        )
    )
    got = _port(flash_mha, q, k, v, kv_len=n)
    np.testing.assert_allclose(got[:, :, :n], ref, **TOL)


def test_cuda_wrapper_refuses_what_the_kernel_cannot_take():
    """Validation runs before any launch: a head dim that is not a
    multiple of 8 raises on a CUDA tensor; there is no plain fallback.
    (meta tensors stand in for CUDA ones: the check is device-free.)"""
    from imatch_tpu_torch.ops.kernels.flash_attention import _check

    q = torch.empty((1, 2, 16, 12), device="meta")
    with pytest.raises(ValueError, match="multiples of 8"):
        _check(q, q, q, 16)
    q = torch.empty((1, 2, 16, 64), device="meta", dtype=torch.float16)
    with pytest.raises(TypeError):
        _check(q, q, q, 16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_mha(q, q, q)



def test_cuda_wrapper_refuses_unaligned_bf16_rows():
    """The bf16 kernel copies rows 16 bytes at a time: a view whose rows
    do not start 16-byte aligned raises before any launch."""
    from imatch_tpu_torch.ops.kernels.flash_attention import _check

    x = torch.zeros((1, 2, 16, 68), dtype=torch.bfloat16)[..., 4:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check(x, x, x, 16)
    x = torch.zeros((1, 2, 16, 68), dtype=torch.float32)[..., 4:]
    _check(x, x, x, 16)  # fp32 reads elements one by one: any offset


BF16_ATOL = 2 * 2.0**-7
BF16_RTOL = 2.0**-8
KEY_TILE = 64


def _bf16_kernel_emulation(q, k, v, *, causal):
    """flash_fwd_mma_kernel's arithmetic on bf16 (B, H, S, Dh) tensors, in
    fp32 torch: logits in fp32, scaled by log2(e) * Dh^-1/2; per 64-key
    tile, the running max m (starting at -1e30), P = exp2(s - m) rounded
    to bf16, l the sum of the rounded P, O rescaled by exp2(m_old - m_new)
    and accumulated in fp32; the output O / l rounded to bf16."""
    s, dh = q.shape[-2], q.shape[-1]
    scale = torch.tensor(math.log2(math.e), dtype=torch.float32) / math.sqrt(dh)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        pos = torch.arange(s)
        logits = logits.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    m = torch.full(q.shape[:-1], -1e30)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape, dtype=torch.float32)
    for k0 in range(0, s, KEY_TILE):
        blk = logits[..., k0 : k0 + KEY_TILE]
        m_new = torch.maximum(m, blk.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(blk - m_new[..., None]).to(torch.bfloat16).float()
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(p, v[..., k0 : k0 + KEY_TILE, :].float())
        m = m_new
    return torch.where(l[..., None] > 0, acc / l[..., None], 0.0).to(torch.bfloat16)


@pytest.mark.parametrize("dh", [64, 72])
@pytest.mark.parametrize("s,causal", [(257, False), (248, True)])
def test_bf16_rounding_points_match_jax(s, causal, dh):
    rng = np.random.default_rng(s + dh)
    q, k, v = (
        torch.from_numpy(rng.standard_normal((1, 2, s, dh)).astype(np.float32)).bfloat16()
        for _ in range(3)
    )
    got = _bf16_kernel_emulation(q, k, v, causal=causal)
    jq, jk, jv = (jnp.asarray(x.float().numpy()) for x in (q, k, v))
    ref = np.asarray(
        _mha_xla(jq, jk, jv, causal=causal, precision=jax.lax.Precision.HIGHEST)
    )
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=BF16_RTOL, atol=BF16_ATOL)
