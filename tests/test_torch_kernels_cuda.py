"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device: every test skips without one (decided inside the
``cuda`` fixture). This file imports torch and the port only, so it also
runs where JAX is not installed; skip the repository's conftest.py there,
which sets JAX up:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Tolerances: fp32 2e-5 (tests/test_pallas.py's bar); bf16 2 bf16 ulps at
magnitude 1 (2 * 2^-7), against the plain version in fp32 on the same
bf16 inputs; tile maxima 1e-5 (fp32 sums in another order), K1's int8
variant bit-identical (integer dots, the same two roundings), K6 within
1e-6 of K1 on the same rows (exp_pallas_search.py's bar); int8 codes of
K3 and K4 within 1 LSB of the plain version with under 1e-3 (K3) or 2e-3
(K4) of them differing, scales within rtol 1e-6
(tests/test_quant_kernel.py's bars; K4's rsqrtf is not correctly rounded).
"""

import pytest
import torch

from imatch_tpu_torch.device import resolve_device
from imatch_tpu_torch.index.search import (
    _int8_queries,
    host_rescore_topk,
    prepare_device_corpus,
    prepare_host_rescore_corpus,
    tilemax_topk,
)
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.models.clip.model import init_random
from imatch_tpu_torch.models.clip.quant import encode_image_w8a8
from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha, flash_mha_plain
from imatch_tpu_torch.ops.kernels.quantize import (
    ln_quant_rows,
    ln_quant_rows_plain,
    quant_rows,
    quant_rows_plain,
)
from imatch_tpu_torch.ops.kernels.int4_topk import int4_tile_max, int4_tile_max_plain, pack_int4
from imatch_tpu_torch.ops.kernels.topk import (
    NEG_INF,
    tile_max,
    tile_max_int8,
    tile_max_int8_plain,
    tile_max_plain,
)
from imatch_tpu_torch.ops.kernels.topk_t import tile_max_t, tile_max_t_plain
from imatch_tpu_torch.ops.quant import qdot_int8, quantize_weight_int8

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


def _assert_bf16_close(out, ref):
    """chip_smoke.py's bf16 bar: 2 bf16 ulps at magnitude 1 absolute plus
    half an ulp (2^-8) relative, against fp32 math on the same inputs."""
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref, rtol=2.0**-8, atol=BF16_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1, 15, 17, 64, 65, 257])
@pytest.mark.parametrize("dh", [8, 16, 64, 72, 128])
def test_flash_attention_bf16_tensor_cores(cuda, dh, s, causal):
    """The tensor-core kernel at every head-dim shape class (one k16 step,
    a k16 step with a zero-padded half, Dh/8 odd), and sequence lengths
    around its 16-row warps and 64-key tiles, at B = 1 (few blocks, one
    warp each)."""
    q, k, v = _qkv((1, 3, s, dh), torch.bfloat16, cuda, seed=s + dh)
    before = flash_mha.launches
    out = flash_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_mha.launches == before + 1
    _assert_bf16_close(out, flash_mha_plain(q.float(), k.float(), v.float(), causal=causal))


@pytest.mark.parametrize(
    "shape,causal,kv_len",
    [
        ((1, 2, 257, 64), True, 100),  # causal and keys past kv_len masked
        ((2, 4, 130, 72), True, 70),
        ((1, 3, 65, 128), True, 1),
        ((2, 3, 77, 72), False, 0),  # every key masked: rows write 0
        ((1, 2, 17, 16), True, 0),
        ((64, 16, 257, 64), False, None),  # the bulk-ingest chunk: 4-warp blocks
    ],
)
def test_flash_attention_bf16_masks(cuda, shape, causal, kv_len):
    q, k, v = _qkv(shape, torch.bfloat16, cuda, seed=7)
    out = flash_mha(q, k, v, causal=causal, kv_len=kv_len)
    ref = flash_mha_plain(q.float(), k.float(), v.float(), causal=causal, kv_len=kv_len)
    _assert_bf16_close(out, ref)
    if kv_len == 0:
        assert not bool(out.float().abs().max())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,h,dh", [(2, 50, 12, 64), (1, 257, 16, 64), (3, 77, 8, 72), (1, 1, 4, 72)])
def test_flash_attention_reads_strided_heads(cuda, b, s, h, dh, causal):
    """The fused-QKV layout the towers hand it: (B, S, 3, H, Dh) views."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((b, s, 3, h, dh), generator=g, device=cuda).bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = flash_mha(q, k, v, causal=causal)
    ref = flash_mha_plain(q.float(), k.float(), v.float(), causal=causal)
    _assert_bf16_close(out, ref)


@pytest.mark.parametrize("layout", ["contiguous", "fused_qkv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,kv_len",
    [
        ((1, 16, 729, 72), None),  # the Moondream vision tower, one upload
        ((16, 16, 729, 72), None),  # a folder's or a back-fill's chunk of 16
        ((2, 16, 729, 72), 500),  # keys past kv_len masked
    ],
)
def test_flash_attention_moondream_vision_shape(cuda, dtype, shape, kv_len, layout):
    """K2 where the JAX package runs its Pallas kernel: S = 729 (11 full
    64-key tiles and one of 25 keys; 45 full 16-row warps and one of 9
    rows), Dh = 72 (four k16 steps and a zero-padded half), B*H up to 256
    heads; contiguous or the tower's (B, S, 3, H, Dh) fused-QKV views."""
    b, h, s, dh = shape
    if layout == "contiguous":
        q, k, v = _qkv(shape, dtype, cuda, seed=s + b)
    else:
        g = torch.Generator(device=cuda).manual_seed(s + b)
        qkv = torch.randn((b, s, 3, h, dh), generator=g, device=cuda).to(dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    before = flash_mha.launches
    out = flash_mha(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_mha.launches == before + 1 and out.shape == shape
    ref = flash_mha_plain(q.float(), k.float(), v.float(), kv_len=kv_len)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    else:
        _assert_bf16_close(out, ref)


@pytest.mark.parametrize("sq,s", [(5, 40), (1, 896), (771, 771)])
def test_moondream_decoder_attention_bf16_matches_fp32(cuda, sq, s):
    """The decoder's plain attention (models/moondream/model.py
    ``_attend_cached``) in bf16 on the card, whose two products run on the
    tensor cores with fp32 results, against its fp32 math on the CPU on the
    same bf16 values: a causal prefill block, one decode token over a
    896-slot cache, the caption prefill's 771 tokens."""
    from imatch_tpu_torch.models.moondream.model import _attend_cached

    g = torch.Generator(device=cuda).manual_seed(sq + s)
    q = torch.randn((2, 32, sq, 64), generator=g, device=cuda).bfloat16()
    ck, cv = (torch.randn((2, 32, s, 64), generator=g, device=cuda).bfloat16() for _ in range(2))
    qpos = torch.arange(s - sq, s, device=cuda)
    hidden = torch.arange(s, device=cuda)[None, :] > qpos[:, None] if sq > 1 else None
    got = _attend_cached(q, ck, cv, hidden)
    want = _attend_cached(
        q.cpu().float(), ck.cpu().float(), cv.cpu().float(), None if hidden is None else hidden.cpu()
    )
    _assert_bf16_close(got, want.to(cuda))


def test_flash_attention_raises_instead_of_falling_back(cuda):
    q, k, v = _qkv((1, 2, 16, 12), torch.float32, cuda)  # head dim 12
    before = flash_mha.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_mha(q, k, v)
    q, k, v = _qkv((1, 2, 16, 64), torch.float16, cuda)
    with pytest.raises(TypeError):
        flash_mha(q, k, v)
    x = torch.zeros((1, 2, 16, 68), dtype=torch.bfloat16, device=cuda)[..., 4:]
    with pytest.raises(ValueError, match="16-byte aligned"):  # rows 136 bytes apart
        flash_mha(x, x, x)
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


@pytest.mark.parametrize("tile_n", [512, 2048])
@pytest.mark.parametrize("nq", [2, 3, 8, 9, 16, 17, 33])
@pytest.mark.parametrize("d", [768, 200])
def test_tile_max_bf16_tensor_cores(cuda, d, nq, tile_n):
    """bf16 at Q >= 2 (the tensor-core kernel): one or two n-tiles, Q past
    a chunk, a corpus dim that is not a multiple of 32 (a partial chunk),
    and a tile with no valid row."""
    corpus, valid = _unit_corpus(8192, d, cuda, seed=nq + d)
    valid[2048:4096] = False  # tile 1 at 2048, tiles 4-7 at 512
    scoring = corpus.bfloat16()
    qs = (corpus[:nq] + 0.05 * corpus[nq : 2 * nq]).bfloat16()
    before = (tile_max.launches, tile_max.mma_launches)
    got = tile_max(qs, scoring, valid, tile_n)
    torch.cuda.synchronize()
    assert (tile_max.launches, tile_max.mma_launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, tile_max_plain(qs, scoring, valid, tile_n), rtol=1e-5, atol=1e-5)
    assert (got[:, 4096 // tile_n - 1] == NEG_INF).all()


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


def _unit_corpus(n, d, device, seed, dead=0.05):
    g = torch.Generator(device=device).manual_seed(seed)
    corpus = torch.randn((n, d), generator=g, device=device)
    corpus /= corpus.norm(dim=1, keepdim=True)
    corpus[-64:] = corpus[:64]  # duplicate rows
    valid = torch.rand((n,), generator=g, device=device) >= dead
    return corpus, valid


@pytest.mark.parametrize("n,nq", [(8192, 1), (8192, 5), (8192, 16), (8192, 33), (1 << 20, 16)])
def test_tile_max_int8_bit_identical(cuda, n, nq):
    corpus, valid = _unit_corpus(n, 768, cuda, seed=nq)
    valid[1024:1536] = False  # a tile with no valid row
    dc = prepare_device_corpus(corpus, valid, tile_n=512, score_dtype=torch.int8, device=cuda)
    qi, qscale = _int8_queries(corpus[:nq] + 0.01, dc.scoring.shape[1])
    before = tile_max_int8.launches
    got = tile_max_int8(qi, dc.scoring, qscale, dc.scale, dc.valid, 512)
    torch.cuda.synchronize()
    assert tile_max_int8.launches == before + 1
    want = tile_max_int8_plain(qi, dc.scoring, qscale, dc.scale, dc.valid, 512)
    assert torch.equal(got, want)
    assert (got[:, 2] == NEG_INF).all()


def test_int8_tiers_match_brute_force_on_card(cuda):
    corpus, valid = _unit_corpus(20000, 768, cuda, seed=4, dead=0.01)
    queries = corpus[:8].clone()
    bs = torch.where(valid[None, :], queries @ corpus.T, NEG_INF)
    bs, bi = torch.sort(bs, dim=1, descending=True, stable=True)
    dc = prepare_device_corpus(corpus, valid, tile_n=512, score_dtype=torch.int8, margin=16, device=cuda)
    s, i = tilemax_topk(queries, dc, k=10)
    assert torch.equal(i, bi[:, :10])
    torch.testing.assert_close(s, bs[:, :10], rtol=1e-5, atol=1e-5)
    hc = prepare_host_rescore_corpus(corpus.cpu().numpy(), valid.cpu().numpy(), device=cuda)
    hs, hi = host_rescore_topk(queries, hc, k=10)
    assert (hi == bi[:, :10].cpu().numpy()).all()


@pytest.mark.parametrize(
    "n,d,nq,tile_n",
    [
        (4096, 512, 8, 512),
        (4096, 96, 3, 512),
        (4096, 192, 5, 512),  # two chunk steps a lane, the last two chunks past the row
        (4096, 768, 8, 512),  # past D = 512: each row in two segments
        (1 << 20, 512, 8, 2048),
    ],
)
def test_int4_tile_max_matches_plain(cuda, n, d, nq, tile_n):
    corpus, _ = _unit_corpus(n, d, cuda, seed=5)
    valid = torch.arange(n, device=cuda) % 97 != 0
    packed, side, _, _ = pack_int4(corpus, valid)
    g = torch.Generator(device=cuda).manual_seed(6)
    qbf = torch.randn((nq, d), generator=g, device=cuda)
    qbf = (qbf / qbf.norm(dim=1, keepdim=True)).bfloat16()
    before = int4_tile_max.launches
    got = int4_tile_max(qbf, packed, side, tile_n)
    torch.cuda.synchronize()
    assert int4_tile_max.launches == before + 1
    torch.testing.assert_close(got, int4_tile_max_plain(qbf, packed, side, tile_n), rtol=0, atol=1e-5)


def _int4_queries(nq, d, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((nq, d), generator=g, device=device)
    return (q / q.norm(dim=1, keepdim=True)).bfloat16()


@pytest.mark.parametrize("tile_n", [16, 512, 2048])
@pytest.mark.parametrize("h", [48, 256])
@pytest.mark.parametrize("nq", [1, 3, 8, 9, 17])
def test_int4_tile_max_tensor_cores(cuda, nq, h, tile_n):
    """Zero query columns (Q < 8, the last chunk of 9 and 17), chunks past
    the row's 64-byte multiples (H = 48) and one m-tile a tile (16)."""
    n = 8192
    corpus, valid = _unit_corpus(n, 2 * h, cuda, seed=nq + h)
    packed, side, _, _ = pack_int4(corpus, valid)
    qbf = _int4_queries(nq, 2 * h, cuda, seed=tile_n)
    before = int4_tile_max.launches
    got = int4_tile_max(qbf, packed, side, tile_n)
    torch.cuda.synchronize()
    assert int4_tile_max.launches == before + 1
    torch.testing.assert_close(got, int4_tile_max_plain(qbf, packed, side, tile_n), rtol=0, atol=1e-5)


def test_int4_tile_max_extreme_codes_and_tombstoned_tile(cuda):
    """Rows of all +-7 codes (the largest sums), and tiles with no valid
    row (-3e38)."""
    n, d = 8192, 512
    g = torch.Generator(device=cuda).manual_seed(11)
    corpus = torch.where(torch.rand((n, d), generator=g, device=cuda) < 0.5, -0.05, 0.05)
    valid = torch.ones((n,), dtype=torch.bool, device=cuda)
    valid[2048:4096] = False
    packed, side, codes, _ = pack_int4(corpus, valid)
    assert bool((codes.abs() == 7).all())
    qbf = _int4_queries(8, d, cuda, seed=12)
    for tile_n in (512, 2048):
        got = int4_tile_max(qbf, packed, side, tile_n)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, int4_tile_max_plain(qbf, packed, side, tile_n), rtol=0, atol=1e-5)
        dead = slice(2048 // tile_n, 4096 // tile_n)
        assert bool((got[:, dead] == NEG_INF).all()) and bool((got > NEG_INF).sum() == got.numel() - got[:, dead].numel())


@pytest.mark.parametrize("n", [16384, 1 << 20])
@pytest.mark.parametrize("tile_n", [512, 1024, 2048, 4096])
def test_tile_max_t_matches_plain_and_k1(cuda, n, tile_n):
    corpus, valid = _unit_corpus(n, 512, cuda, seed=7, dead=0.01)
    scoring = torch.zeros((n, 640), device=cuda)
    scoring[:, :512] = corpus
    scoring[:, 512] = torch.where(valid, 0.0, -4.0)
    scoring = scoring.bfloat16()
    q = torch.zeros((8, 640), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(8)
    q[:, :512] = torch.randn((8, 512), generator=g, device=cuda)  # the script's: random unit queries
    q[:, :512] /= q[:, :512].norm(dim=1, keepdim=True)
    q[:, 512] = 1.0
    q = q.bfloat16()
    st = scoring.T.contiguous()
    before = tile_max_t.launches
    got = tile_max_t(q, st, tile_n)
    torch.cuda.synchronize()
    assert tile_max_t.launches == before + 1
    torch.testing.assert_close(got, tile_max_t_plain(q, st, tile_n), rtol=0, atol=1e-5)
    k1 = tile_max(q, scoring, torch.ones((n,), dtype=torch.bool, device=cuda), tile_n)
    torch.testing.assert_close(got, k1, rtol=0, atol=1e-6)


def test_new_kernels_raise_instead_of_falling_back(cuda):
    before = (tile_max_int8.launches, int4_tile_max.launches, tile_max_t.launches)
    c8 = torch.zeros((1024, 24), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        tile_max_int8(c8[:2], c8, torch.ones(2, device=cuda), torch.ones(1024, device=cuda),
                      torch.ones(1024, dtype=torch.bool, device=cuda), 512)
    with pytest.raises(TypeError):
        int4_tile_max(torch.ones((8, 512), device=cuda), torch.zeros((1024, 256), dtype=torch.int8, device=cuda),
                      torch.ones((8, 1024), dtype=torch.bfloat16, device=cuda), 512)
    with pytest.raises(ValueError, match="tile_n"):
        tile_max_t(torch.ones((8, 640), dtype=torch.bfloat16, device=cuda),
                   torch.ones((640, 3072), dtype=torch.bfloat16, device=cuda), 768)
    assert (tile_max_int8.launches, int4_tile_max.launches, tile_max_t.launches) == before


def _assert_codes(got, ref, frac):
    (q, s), (qr, sr) = got, ref
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == qr.shape and s.shape == sr.shape
    torch.testing.assert_close(s, sr, rtol=1e-6, atol=0)
    diff = (q.int() - qr.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff != 0).float().mean()) < frac


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64), (257, 1024), (3, 257, 4096), (1000, 104)])
def test_quantize_kernels_match_plain(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(shape[-1])
    x = (torch.randn(shape, generator=g, device=cuda) * 3).to(dtype)
    x.view(-1, shape[-1])[-1] = 0  # a zero row: scale 1, codes 0 (K3)
    d = shape[-1]
    gamma = torch.randn(d, generator=g, device=cuda) * 0.5 + 1
    beta = torch.randn(d, generator=g, device=cuda) * 0.1
    before = (quant_rows.launches, ln_quant_rows.launches)
    got3 = quant_rows(x)
    got4 = ln_quant_rows(x, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    assert (quant_rows.launches, ln_quant_rows.launches) == (before[0] + 1, before[1] + 1)
    _assert_codes(got3, quant_rows_plain(x), 1e-3)
    _assert_codes(got4, ln_quant_rows_plain(x, gamma, beta, 1e-5), 2e-3)
    assert float(got3[1].view(-1)[-1]) == 1.0 and not got3[0].view(-1, d)[-1].any()


@pytest.mark.parametrize(
    "shape",
    [(760, 2048), (761, 2048), (1523, 8192), (2, 761, 8192), (12160, 2048)],
    ids=["b1-d2048", "b1-odd-rows", "b2-d8192", "b2-3d-d8192", "b16-d2048"],
)
def test_quantize_kernels_moondream_shapes(cuda, shape):
    """The W8A8 Moondream prefill's rows (B x (1 + 729 + prompt)) at D 2048
    (K4 on the residual stream, K3 on the attention output) and 8192 (K3
    on gelu(fc1)), bf16, with a zero row."""
    test_quantize_kernels_match_plain(cuda, torch.bfloat16, shape)


def test_moondream_int8_modes_on_card_match_cpu(cuda):
    """tiny-md in fp32, the same weights on the card and on the CPU: int8
    weights (prefill logits within 1e-4), an int8 cache (the first decode
    step within 1e-4) and the W8A8 prefill through K4 and K3 (one K4 and
    two K3 a layer; within 2e-3, the K3/K4 codes being within one LSB of
    the plain versions')."""
    from imatch_tpu_torch.models.moondream.configs import TINY_MD
    from imatch_tpu_torch.models.moondream.generate import prefill
    from imatch_tpu_torch.models.moondream.model import (
        decoder_forward,
        embed_tokens,
        init_random as md_init_random,
        lm_logits,
        quantize_int8,
    )

    resolve_device(cuda)
    cpu = quantize_int8(md_init_random(TINY_MD, seed=0, device="cpu", dtype=torch.float32))
    card = quantize_int8(md_init_random(TINY_MD, seed=0, device="cpu", dtype=torch.float32)).to(cuda)
    g = torch.Generator().manual_seed(3)
    feats = torch.randn((2, TINY_MD.vision.num_patches, TINY_MD.text.hidden_size), generator=g)
    toks = torch.randint(0, 256, (2, 6), generator=g)
    want, wc, pos = prefill(cpu, feats, toks, max_new=4, cache_dtype=torch.int8)
    got, gc, _ = prefill(card, feats.to(cuda), toks.to(cuda), max_new=4, cache_dtype=torch.int8)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    nxt = torch.argmax(want, dim=-1)[:, None]
    h_w, _ = decoder_forward(cpu, embed_tokens(cpu, nxt), wc, pos)
    h_g, _ = decoder_forward(card, embed_tokens(card, nxt.to(cuda)), gc, pos)
    torch.testing.assert_close(lm_logits(card, h_g).cpu(), lm_logits(cpu, h_w), rtol=0, atol=1e-4)
    before = (quant_rows.launches, ln_quant_rows.launches)
    got, _, _ = prefill(card, feats.to(cuda), toks.to(cuda), use_cache=False, act_quant=True)
    torch.cuda.synchronize()
    n = TINY_MD.text.num_layers
    assert (quant_rows.launches, ln_quant_rows.launches) == (before[0] + 2 * n, before[1] + n)
    want, _, _ = prefill(cpu, feats, toks, use_cache=False, act_quant=True)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-3)


def test_quantize_kernels_raise_instead_of_falling_back(cuda):
    before = (quant_rows.launches, ln_quant_rows.launches)
    with pytest.raises(ValueError, match="multiple of 8"):
        quant_rows(torch.ones((4, 12), device=cuda))
    with pytest.raises(TypeError):
        quant_rows(torch.ones((4, 64), device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        quant_rows(torch.ones((64, 4), device=cuda).t())
    with pytest.raises(ValueError, match="gamma"):
        ln_quant_rows(torch.ones((4, 64), device=cuda), torch.ones(64, device=cuda).bfloat16(), torch.zeros(64, device=cuda))
    assert (quant_rows.launches, ln_quant_rows.launches) == before


def test_qdot_int8_exact_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(9)
    xi = torch.randint(-127, 128, (2, 257, 1024), generator=g, device=cuda, dtype=torch.int8)
    ascale = torch.rand((2, 257, 1), generator=g, device=cuda)
    w = quantize_weight_int8(torch.randn((1024, 4096), generator=g, device=cuda))
    wq = w["q"].t().contiguous().t()  # the W8A8 layer's layout
    bias = torch.randn(4096, generator=g, device=cuda)
    got = qdot_int8(xi, ascale, wq, w["s"], bias, torch.float32)
    acc = (xi.double().reshape(-1, 1024) @ w["q"].double()).reshape(2, 257, 4096)
    ref = ((acc.float() * ascale) * w["s"]) + bias
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_w8a8_tower_on_card_matches_cpu(cuda):
    resolve_device(cuda)  # full fp32 products: no TF32 in the patch convolution
    model = init_random(
        TINY,
        device="cpu",
        dtype=torch.float32,
        generator=torch.Generator().manual_seed(0),
        quant="int8",
    )
    pixels = torch.randn((4, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    want = encode_image_w8a8(model, pixels)
    before = (quant_rows.launches, ln_quant_rows.launches, flash_mha.launches)
    got = encode_image_w8a8(model.to(cuda), pixels.to(cuda)).cpu()
    n = TINY.vision.num_layers
    assert (quant_rows.launches, ln_quant_rows.launches, flash_mha.launches) == (
        before[0] + 2 * n,
        before[1] + 2 * n,
        before[2] + n,
    )
    assert float((got * want).sum(-1).min()) >= 0.9999


# -- patched device states (index/patch.py) on the card -----------------------

_PATCH_ENGINES = [("tilemax", "bf16"), ("tilemax", "fp32"), ("tilemax", "int8"), ("pallas", "bf16"), ("tilemax-host", "bf16")]


def _unit_rows(n, seed, d=768):
    import numpy as np

    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _states_equal(a, b):
    import numpy as np

    assert type(a) is type(b)
    for name, x in a._asdict().items():
        y = getattr(b, name)
        if isinstance(x, torch.Tensor):
            assert x.device == y.device and x.dtype == y.dtype and torch.equal(x, y), name
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name


@pytest.mark.parametrize("in_place", [True, False])
@pytest.mark.parametrize("engine,dtype", _PATCH_ENGINES)
def test_patched_state_equals_fresh_build_on_card(cuda, engine, dtype, in_place):
    """Appends, deletes and (on the device-only engines) updates patch the
    state on the card; it then equals a fresh build of the same host
    buffers tensor for tensor, in place (no query holds it) and through
    clones (one does, and its captured tensors stay as they were). K1, or
    K1's int8 variant, on the patched state equals its plain version."""
    from imatch_tpu_torch.index.store import VectorStore

    s = VectorStore(dim=768, engine=engine, score_dtype=dtype, device=cuda)
    s.add([f"a{i}" for i in range(3000)], _unit_rows(3000, 0) * 2.5)
    s.query(_unit_rows(1, 9), n_results=3)
    held = None
    if not in_place:
        _, held, _, _, _ = s._snapshot_for_query()
        before = {k: v.clone() for k, v in held[1]._asdict().items() if isinstance(v, torch.Tensor)}
    s.add([f"b{i}" for i in range(37)], _unit_rows(37, 1))
    s.delete([f"a{i}" for i in range(5, 60)])
    if engine != "tilemax-host":
        s.update(["a1", "b3"], embeddings=_unit_rows(2, 2))
    st = s.stats()
    assert st["rebuild_mutations"] == 0 and st["patched_mutations"] == (2 if engine == "tilemax-host" else 3)
    patched = s._device_corpus[1]
    _states_equal(patched, s._build_device(s._emb.copy(), s._alive.copy())[0][1])
    if held is not None:
        for k, v in held[1]._asdict().items():
            if isinstance(v, torch.Tensor):
                assert v.data_ptr() != getattr(patched, k).data_ptr(), k
                assert torch.equal(v, before[k]), k
        s._release_snapshot(held)
    q32 = torch.from_numpy(_unit_rows(4, 3)).to(cuda)
    if patched.scoring.dtype == torch.int8:
        qi, qscale = _int8_queries(q32, patched.scoring.shape[1])
        got = tile_max_int8(qi, patched.scoring, qscale, patched.scale, patched.valid, patched.tile_n)
        assert torch.equal(got, tile_max_int8_plain(qi, patched.scoring, qscale, patched.scale, patched.valid, patched.tile_n))
    else:
        qs = torch.zeros((4, patched.scoring.shape[1]), dtype=patched.scoring.dtype, device=cuda)
        qs[:, :768] = q32
        got = tile_max(qs, patched.scoring, patched.valid, patched.tile_n)
        torch.testing.assert_close(got, tile_max_plain(qs, patched.scoring, patched.valid, patched.tile_n), rtol=1e-5, atol=1e-5)
    # the store answers as a fresh store over the same content
    fresh = VectorStore(dim=768, engine=engine, score_dtype=dtype, device=cuda)
    g = s.get(include=["embeddings"])
    fresh.add(g["ids"], g["embeddings"])
    q = _unit_rows(3, 4)
    assert s.query(q, n_results=10)["ids"] == fresh.query(q, n_results=10)["ids"]


def test_captured_state_survives_patches_on_card(cuda):
    """A query that captured the state before a mutation keeps reading the
    old rows while the store serves the new ones."""
    from imatch_tpu_torch.index.store import VectorStore

    s = VectorStore(dim=768, engine="tilemax", device=cuda)
    s.add([f"a{i}" for i in range(500)], _unit_rows(500, 0))
    s.query(_unit_rows(1, 9), n_results=3)
    _, dc, ids_l, _, _ = s._snapshot_for_query()
    new = _unit_rows(4, 1)
    s.add([f"b{i}" for i in range(4)], new)
    s.delete(["a7"])
    _, idx = s._run_engine(_unit_rows(500, 0)[7:8], dc, 4)
    assert ids_l[idx[0][0]] == "a7"  # deleted after the capture
    _, idx = s._run_engine(new[:1], dc, 4)
    assert not any(ids_l[i].startswith("b") for i in idx[0] if i >= 0)
    s._release_snapshot(dc)
    assert s.query(new[:1], n_results=1)["ids"] == [["b0"]]
    assert "a7" not in s.query(_unit_rows(500, 0)[7:8], n_results=3)["ids"][0]


# -- the serving surface's shapes: batched queries, device-resident adds ------


@pytest.mark.parametrize("nq", [2, 3, 5, 9, 16, 17, 64, 256])
def test_tile_max_bf16_at_serving_query_counts(cuda, nq):
    """K1 on the tensor cores at the query counts of /api/search/batch,
    the coalescer and warm (powers of two, and the odd counts between),
    over 768-wide rows in 512-row tiles."""
    corpus, valid = _unit_corpus(16384, 768, cuda, seed=100 + nq)
    valid[512:1024] = False  # a tile with no valid row
    scoring = corpus.bfloat16()
    g = torch.Generator(device=cuda).manual_seed(nq)
    qs = torch.randn((nq, 768), generator=g, device=cuda)
    qs = (qs / qs.norm(dim=1, keepdim=True)).bfloat16()
    before = (tile_max.launches, tile_max.mma_launches)
    got = tile_max(qs, scoring, valid, 512)
    torch.cuda.synchronize()
    assert (tile_max.launches, tile_max.mma_launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, tile_max_plain(qs, scoring, valid, 512), rtol=1e-5, atol=1e-5)
    assert (got[:, 1] == NEG_INF).all()


@pytest.mark.parametrize("nq", [2, 16, 33])
def test_tile_max_int8_at_serving_query_counts(cuda, nq):
    corpus, valid = _unit_corpus(16384, 768, cuda, seed=200 + nq)
    dc = prepare_device_corpus(corpus, valid, tile_n=512, score_dtype=torch.int8, device=cuda)
    qi, qscale = _int8_queries(corpus[:nq] * 0.9 + 0.01, dc.scoring.shape[1])
    before = tile_max_int8.launches
    got = tile_max_int8(qi, dc.scoring, qscale, dc.scale, dc.valid, 512)
    torch.cuda.synchronize()
    assert tile_max_int8.launches == before + 1
    assert torch.equal(got, tile_max_int8_plain(qi, dc.scoring, qscale, dc.scale, dc.valid, 512))


def _numpy_int8_rows(rows):
    """The int8 tier's row quantization in numpy: scale = amax * fp32(1/127)
    (1 for a zero row), codes = clip(round-half-even(x / scale), -127, 127)."""
    import numpy as np

    amax = np.abs(rows).max(axis=1)
    scale = np.where(amax > 0, amax * np.float32(1.0 / 127.0), np.float32(1.0)).astype(np.float32)
    codes = np.clip(np.round(rows / scale[:, None]), -127, 127).astype(np.int8)
    return codes, scale


def test_device_append_int8_codes_equal_numpy(cuda):
    """Rows appended from a tensor on the card are quantized there; their
    codes and scales equal the numpy quantization bit for bit."""
    import numpy as np

    from imatch_tpu_torch.index.store import VectorStore

    s = VectorStore(dim=768, engine="tilemax", score_dtype="int8", device=cuda)
    s.add([f"a{i}" for i in range(600)], _unit_rows(600, 0))
    s.query(_unit_rows(1, 9), n_results=3)
    rows = _unit_rows(64, 1) * np.float32(1.7)
    rows[3] = 0.0  # a zero row: scale 1
    s.add([f"b{i}" for i in range(64)], torch.from_numpy(rows).to(cuda))
    assert s.stats()["patched_mutations"] == 1
    state = s._device_corpus[1]
    codes, scale = _numpy_int8_rows(rows)
    np.testing.assert_array_equal(state.scoring[600:664, :768].cpu().numpy(), codes)
    np.testing.assert_array_equal(state.scale[600:664].cpu().numpy(), scale)
    assert not state.scoring[600:664, 768:].any()


@pytest.mark.parametrize("engine,dtype", _PATCH_ENGINES)
def test_device_add_patch_equals_fresh_build_on_card(cuda, engine, dtype):
    """A device-resident add (a tensor on the card) patches the built state
    with no rebuild; after the flush the host mirror holds the card's rows
    bit for bit, and the patched state equals a fresh build of the mirror
    tensor for tensor."""
    import numpy as np

    from imatch_tpu_torch.index.store import VectorStore

    s = VectorStore(dim=768, engine=engine, score_dtype=dtype, device=cuda)
    s.add([f"a{i}" for i in range(3000)], _unit_rows(3000, 0))
    s.query(_unit_rows(1, 9), n_results=3)
    rows = torch.from_numpy(_unit_rows(64, 1)).to(cuda)
    s.add([f"b{i}" for i in range(64)], rows)
    st = s.stats()
    assert (st["patched_mutations"], st["rebuild_mutations"], st["pending_host_syncs"]) == (1, 0, 1)
    s.flush()
    assert s.stats()["pending_host_syncs"] == 0
    np.testing.assert_array_equal(s._emb[3000:3064], rows.cpu().numpy())
    _states_equal(s._device_corpus[1], s._build_device(s._emb.copy(), s._alive.copy())[0][1])
    q = _unit_rows(3, 4)
    fresh = VectorStore(dim=768, engine=engine, score_dtype=dtype, device=cuda)
    g = s.get(include=["embeddings"])
    fresh.add(g["ids"], g["embeddings"])
    assert s.query(q, n_results=10)["ids"] == fresh.query(q, n_results=10)["ids"]


def test_batched_store_query_equals_single_on_card(cuda):
    """A (Q, d) query (five rows, no padding, K1 on the tensor cores)
    gives each row the ids and scores of its own single query."""
    import numpy as np

    from imatch_tpu_torch.index.store import VectorStore

    s = VectorStore(dim=768, device=cuda)
    s.add([f"a{i}" for i in range(20000)], _unit_rows(20000, 0))
    q = torch.from_numpy(_unit_rows(20000, 0)[:5] * 0.7 + _unit_rows(5, 5) * 0.3).to(cuda)
    q = q / q.norm(dim=1, keepdim=True)
    got = s.query(q, n_results=10, include=["distances"])
    for i in range(5):
        one = s.query(q[i : i + 1], n_results=10, include=["distances"])
        assert got["ids"][i] == one["ids"][0]
        np.testing.assert_array_equal(got["distances"][i], one["distances"][0])


def _clustered_rows(n, seed, centres=64, d=768):
    """Unit rows around ``centres`` unit centres (noise of norm about 0.5):
    nearest centroids keep a margin, so the card's and the CPU's fp32
    products pick the same ones."""
    import numpy as np

    rng = np.random.default_rng(seed)
    c = _unit_rows(centres, seed + 1, d)
    x = c[rng.integers(0, centres, n)] + rng.standard_normal((n, d)).astype(np.float32) * (0.5 / d**0.5)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_sharded_store_equals_tilemax_on_card(cuda, p, dtype):
    """The sharded engine at P shards on the card (P = 4: logical shards
    on one card) answers as tilemax does bit for bit, with tombstones and
    duplicate rows, launching K1 once a shard an engine call; adds,
    deletes and updates patch it into a fresh build's state, tensor for
    tensor."""
    import numpy as np

    from imatch_tpu_torch.index.store import VectorStore

    rows = _unit_rows(6000, 0)
    rows[5990:] = rows[:10]
    ids = [f"r{i}" for i in range(6000)]
    ref = VectorStore(dim=768, engine="tilemax", score_dtype=dtype, device=cuda)
    st = VectorStore(dim=768, engine="sharded", score_dtype=dtype, device=cuda, mesh=[cuda] * p)
    q = np.concatenate([rows[:3], _unit_rows(13, 5)])
    for s in (ref, st):
        s.add(ids, rows)
        s.delete(ids[100:130])
        s.query(q[:1], n_results=1)  # the builds
    for nq in (1, 16):
        before = tile_max.launches
        got = st.query(q[:nq], n_results=10)
        torch.cuda.synchronize()
        assert tile_max.launches - before == p
        assert got == ref.query(q[:nq], n_results=10)
    for s in (ref, st):
        s.add([f"n{i}" for i in range(16)], _unit_rows(16, 6))
        s.delete(ids[200:264])
        s.update(ids[300:364], embeddings=_unit_rows(64, 7))
    stats = st.stats()
    assert (stats["patched_mutations"], stats["rebuild_mutations"]) == (3, 0)
    fresh = st._build_device(st._emb.copy(), st._alive.copy())[0][1]
    for got_shard, want_shard in zip(st._device_corpus[1].shards, fresh.shards):
        _states_equal(got_shard, want_shard)
    assert st.query(q, n_results=10) == ref.query(q, n_results=10)


@pytest.mark.parametrize("engines", [("ivf", "tilemax", 1), ("ivf-sharded", "sharded", 4)])
def test_ivf_full_probe_equals_exact_on_card(cuda, engines, monkeypatch):
    """At a full probe the IVF kinds answer as their exact engines, bit
    for bit, at Q = 1 and 16."""
    import numpy as np

    from imatch_tpu_torch.index.store import VectorStore

    ann_engine, exact_engine, p = engines
    rows = _clustered_rows(8000, 0)
    ids = [f"c{i}" for i in range(8000)]
    ann = VectorStore(dim=768, engine=ann_engine, device=cuda, mesh=[cuda] * p)
    exact = VectorStore(dim=768, engine=exact_engine, device=cuda, mesh=[cuda] * p)
    for s in (ann, exact):
        s.add(ids, rows)
        s.delete(ids[50:90])
    monkeypatch.setenv("IMATCH_IVF_NPROBE", "1000000")
    q = np.concatenate([rows[:8], _unit_rows(8, 3)])
    for nq in (1, 16):
        assert ann.query(q[:nq], n_results=10) == exact.query(q[:nq], n_results=10)


def test_ivf_on_card_matches_cpu(cuda):
    """The same centroids on the card and the CPU: the same assignments
    and member lists, the probe's ids, scores within 1e-5 (fp32 products
    in another order)."""
    import numpy as np

    from imatch_tpu_torch.index import ivf

    rows = _clustered_rows(20000, 1)
    valid = np.ones(20000, bool)
    valid[::17] = False
    cents = ivf.train_centroids(rows, valid, n_clusters=64, seed=2).numpy()
    assign = ivf.assign_rows(rows, cents)
    np.testing.assert_array_equal(ivf.assign_rows(torch.from_numpy(rows).to(cuda), cents), assign)
    cpu, stats = ivf.pack_ivf_stats(rows, valid, cents, assign)
    card, card_stats = ivf.pack_ivf_stats(rows, valid, cents, assign, device=cuda)
    assert torch.equal(card.members.cpu(), cpu.members)
    np.testing.assert_array_equal(card_stats["counts"], stats["counts"])
    q = torch.from_numpy(np.concatenate([rows[:4], _unit_rows(12, 4)]))
    for n_probe in (1, 8, 64):
        s_cpu, i_cpu = ivf.ivf_topk(q, cpu, k=10, n_probe=n_probe)
        s_card, i_card = ivf.ivf_topk(q.to(cuda), card, k=10, n_probe=n_probe)
        assert torch.equal(i_card.cpu(), i_cpu)
        assert float((s_card.cpu() - s_cpu).abs().max()) <= 1e-5


def test_ivf_append_patch_equals_repack_on_card(cuda):
    """Rows appended to a built ivf store on the card are assigned against
    its centroids and written into free member slots, without a k-means
    run or a rebuild; the member lists equal a repack's."""
    import numpy as np

    from imatch_tpu_torch.index import ivf
    from imatch_tpu_torch.index.store import VectorStore

    rows = _clustered_rows(3100, 3)
    s = VectorStore(dim=768, engine="ivf", device=cuda)
    s.add([f"a{i}" for i in range(3000)], rows[:3000])
    s.query(rows[:1], n_results=3)
    s.add([f"b{i}" for i in range(64)], torch.from_numpy(rows[3000:3064]).to(cuda))  # from the card
    s.add([f"c{i}" for i in range(36)], rows[3064:])
    st = s.stats()
    assert (st["patched_mutations"], st["rebuild_mutations"], st["ivf"]["last_mode"]) == (2, 0, "train")
    _, state = s._device_corpus
    h = s._ivf_host
    repack, stats = ivf.pack_ivf_stats(s._emb, s._alive, h["cents"], h["assign"], device=cuda)
    w = min(state.members.shape[1], repack.members.shape[1])
    assert torch.equal(state.members[:, :w], repack.members[:, :w])
    assert bool((state.members[:, w:] == -1).all()) and bool((repack.members[:, w:] == -1).all())
    np.testing.assert_array_equal(stats["counts"], h["counts"])
    s.delete([f"b{i}" for i in range(2)])  # a validity write: the member lists stay
    assert s.stats()["patched_mutations"] == 3
    got = [r[0] for r in s.query(rows[3000:3004], n_results=1)["ids"]]
    assert got[2:] == ["b2", "b3"] and not {"b0", "b1"} & set(got)
