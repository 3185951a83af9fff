"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device: every test skips without one (decided inside the
``cuda`` fixture). This file imports torch and the port only, so it also
runs where JAX is not installed; skip the repository's conftest.py there,
which sets JAX up:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Tolerances: fp32 2e-5 (tests/test_pallas.py's bar); bf16 2 bf16 ulps at
magnitude 1 (2 * 2^-7), against the plain version in fp32 on the same
bf16 inputs; tile maxima 1e-5 (fp32 sums in another order).
"""

import pytest
import torch

from imatch_tpu_torch.index.search import prepare_device_corpus, tilemax_topk
from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha, flash_mha_plain
from imatch_tpu_torch.ops.kernels.topk import NEG_INF, tile_max, tile_max_plain

BF16_TOL = 2 * 2.0**-7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,causal,kv_len",
    [
        ((2, 16, 257, 64), False, None),
        ((2, 12, 248, 64), True, None),
        ((3, 8, 77, 64), True, None),
        ((2, 4, 130, 72), False, 70),
        ((2, 4, 77, 8), False, 0),
    ],
)
def test_flash_attention_matches_plain(cuda, dtype, shape, causal, kv_len):
    q, k, v = _qkv(shape, dtype, cuda)
    before = flash_mha.launches
    out = flash_mha(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_mha.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    ref = flash_mha_plain(q.float(), k.float(), v.float(), causal=causal, kv_len=kv_len)
    tol = 2e-5 if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)


def test_flash_attention_reads_strided_heads(cuda):
    """The fused-QKV layout the towers hand it: (B, S, 3, H, Dh) views."""
    b, s, h, dh = 2, 50, 12, 64
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((b, s, 3, h, dh), generator=g, device=cuda).bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = flash_mha(q, k, v)
    ref = flash_mha_plain(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), ref, rtol=BF16_TOL, atol=BF16_TOL)


def test_flash_attention_raises_instead_of_falling_back(cuda):
    q, k, v = _qkv((1, 2, 16, 12), torch.float32, cuda)  # head dim 12
    before = flash_mha.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_mha(q, k, v)
    q, k, v = _qkv((1, 2, 16, 64), torch.float16, cuda)
    with pytest.raises(TypeError):
        flash_mha(q, k, v)
    assert flash_mha.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq", [1, 5, 16, 33])
def test_tile_max_matches_plain(cuda, dtype, nq):
    g = torch.Generator(device=cuda).manual_seed(nq)
    corpus = torch.randn((8192, 768), generator=g, device=cuda)
    corpus /= corpus.norm(dim=1, keepdim=True)
    valid = torch.rand((8192,), generator=g, device=cuda) >= 0.05
    valid[1024:1536] = False  # a tile with no valid row
    dc = prepare_device_corpus(corpus, valid, tile_n=512, score_dtype=dtype, device=cuda)
    qs = dc.scoring[:nq].clone()
    before = tile_max.launches
    got = tile_max(qs, dc.scoring, dc.valid, 512)
    torch.cuda.synchronize()
    assert tile_max.launches == before + 1
    torch.testing.assert_close(got, tile_max_plain(qs, dc.scoring, dc.valid, 512), rtol=1e-5, atol=1e-5)
    assert (got[:, 2] == NEG_INF).all()


def test_engine_matches_brute_force_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    corpus = torch.randn((20000, 768), generator=g, device=cuda)
    corpus /= corpus.norm(dim=1, keepdim=True)
    corpus[-50:] = corpus[:50]  # duplicates: ties go to the lower index
    valid = torch.rand((20000,), generator=g, device=cuda) >= 0.01
    queries = corpus[:8].clone()
    dc = prepare_device_corpus(corpus, valid, tile_n=512, device=cuda)
    s, i = tilemax_topk(queries, dc, k=10)
    bs = torch.where(valid[None, :], queries @ corpus.T, NEG_INF)
    bs, bi = torch.sort(bs, dim=1, descending=True, stable=True)
    assert torch.equal(i, bi[:, :10])
    torch.testing.assert_close(s, bs[:, :10], rtol=1e-5, atol=1e-5)
