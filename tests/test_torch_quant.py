"""The port's W8A8 pieces against the JAX package on the same inputs.

- K3 and K4's plain versions (ops/kernels/quantize.py, what the wrappers
  run on the CPU) against the Pallas kernels in interpret mode
  (``quant_rows_pallas``, ``ln_quant_rows_pallas``) and against the XLA
  compositions of imatch_tpu/ops/quant.py, with the JAX suite's bars
  (tests/test_quant_kernel.py): codes within 1 LSB with under 1e-3 (K3)
  or 2e-3 (K4) of codes differing, scales within rtol 1e-6.
- ``quantize_weight_int8`` codes and scales bit-identical to JAX's;
  ``qdot_int8`` equal to JAX's at fp32.
- The ``tiny`` W8A8 image tower, weights carried across by the bridge,
  against JAX ``encode_image_w8a8`` at fp32: per-row cosine >= 0.9999;
  and JAX's own check, cosine > 0.98 against the fp32 tower.
Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imatch_tpu.models.clip.configs import TINY as JAX_TINY
from imatch_tpu.models.clip.model import init_params
from imatch_tpu.models.clip.quant import encode_image_w8a8 as jax_encode_image_w8a8
from imatch_tpu.models.clip.quant import quantize_vision_tower as jax_quantize_vision_tower
from imatch_tpu.ops import quant as jax_quant
from imatch_tpu.ops.pallas.quantize import ln_quant_rows_pallas, quant_rows_pallas
from imatch_tpu_torch.models.clip.bridge import params_from_numpy
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.models.clip.model import encode_image
from imatch_tpu_torch.models.clip.quant import EncoderW8A8, encode_image_w8a8
from imatch_tpu_torch.ops import quant
from imatch_tpu_torch.ops.kernels.quantize import (
    ln_quant_rows,
    ln_quant_rows_plain,
    quant_rows,
    quant_rows_plain,
)

SHAPES = [(3, 257, 64), (5, 1024), (4, 65, 256)]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, dtype_name, seed, scale=3.0):
    """The same values for both packages: fp32 numpy, rounded to bf16
    first where the input is bf16 (so both sides see exact values), with
    one all-zero row."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x.reshape(-1, shape[-1])[1] = 0.0
    tdt, jdt = DTYPES[dtype_name]
    xj = jnp.asarray(x, jdt)
    x = np.array(xj.astype(jnp.float32))
    return torch.from_numpy(x).to(tdt), xj


def _assert_codes(got, ref, frac):
    (qg, sg), (qr, sr) = got, ref
    qg, sg = qg.numpy(), sg.numpy()
    qr, sr = np.asarray(qr), np.asarray(sr)
    assert qg.dtype == np.int8 and sg.dtype == np.float32
    assert qg.shape == qr.shape and sg.shape == sr.shape
    np.testing.assert_allclose(sg, sr, rtol=1e-6, atol=0)
    diff = np.abs(qg.astype(np.int32) - qr.astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() < frac


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_k3_plain_matches_pallas_and_xla(shape, dtype):
    x, xj = _inputs(shape, dtype, seed=len(shape) + shape[-1])
    got = quant_rows_plain(x)
    _assert_codes(got, quant_rows_pallas(xj, interpret=True), 1e-3)
    _assert_codes(got, jax_quant.quant_rows_int8_xla(xj), 1e-3)
    flat_q, flat_s = got[0].reshape(-1, shape[-1]), got[1].reshape(-1)
    assert flat_s[1] == 1.0 and (flat_q[1] == 0).all()  # the zero row


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_k4_plain_matches_pallas_and_composition(shape, dtype, monkeypatch):
    x, xj = _inputs(shape, dtype, seed=7 + shape[-1], scale=2.0)
    rng = np.random.default_rng(shape[-1])
    d = shape[-1]
    g = (rng.standard_normal(d) * 0.5 + 1.0).astype(np.float32)
    b = (rng.standard_normal(d) * 0.1).astype(np.float32)
    got = ln_quant_rows_plain(x, torch.from_numpy(g), torch.from_numpy(b), 1e-5)
    ref = ln_quant_rows_pallas(xj, jnp.asarray(g), jnp.asarray(b), eps=1e-5, interpret=True)
    _assert_codes(got, ref, 2e-3)
    monkeypatch.setenv("IMATCH_QUANT_KERNEL", "xla")
    ref = jax_quant.ln_quant_rows_int8(xj, {"scale": jnp.asarray(g), "bias": jnp.asarray(b)}, 1e-5)
    _assert_codes(got, ref, 2e-3)
    # the zero row normalises to beta
    np.testing.assert_array_equal(
        got[0].reshape(-1, d)[1].numpy(), quant_rows_plain(torch.from_numpy(b))[0].numpy()
    )


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    x, _ = _inputs((4, 64), "float32", seed=1)
    g, b = torch.ones(64), torch.zeros(64)
    before = (quant_rows.launches, ln_quant_rows.launches)
    for got, ref in (
        (quant_rows(x), quant_rows_plain(x)),
        (ln_quant_rows(x, g, b), ln_quant_rows_plain(x, g, b)),
        (quant.quant_rows_int8(x), quant_rows_plain(x)),
        (quant.ln_quant_rows_int8(x, g, b, 1e-5), ln_quant_rows_plain(x, g, b)),
    ):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert (quant_rows.launches, ln_quant_rows.launches) == before


@pytest.mark.parametrize("shape", [(64, 192), (2, 48, 96), (3, 8, 16)])
def test_quantize_weight_bit_identical(shape):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero output channel: scale 1, codes 0
    ours = quant.quantize_weight_int8(torch.from_numpy(w))
    theirs = jax_quant.quantize_weight_int8(jnp.asarray(w))
    np.testing.assert_array_equal(ours["q"].numpy(), np.asarray(theirs["q"]))
    np.testing.assert_array_equal(ours["s"].numpy(), np.asarray(theirs["s"]))
    assert ours["s"][..., 3].eq(1.0).all()


def test_qdot_equals_jax_at_fp32():
    rng = np.random.default_rng(5)
    xi = rng.integers(-127, 128, (2, 7, 64)).astype(np.int8)
    ascale = rng.uniform(0.01, 0.1, (2, 7, 1)).astype(np.float32)
    w = jax_quant.quantize_weight_int8(jnp.asarray(rng.standard_normal((64, 96)), jnp.float32))
    bias = rng.standard_normal(96).astype(np.float32)
    ref = jax_quant.qdot_int8(jnp.asarray(xi), jnp.asarray(ascale), w, jnp.asarray(bias), jnp.float32)
    wq = torch.from_numpy(np.array(w["q"]))
    got = quant.qdot_int8(
        torch.from_numpy(xi),
        torch.from_numpy(ascale),
        wq.t().contiguous().t(),  # the module's layout: a (D_out, D_in) buffer, transposed
        torch.from_numpy(np.array(w["s"])),
        torch.from_numpy(bias),
        torch.float32,
    )
    assert got.shape == (2, 7, 96) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def tiny():
    params = init_params(jax.random.key(0), JAX_TINY)
    tree = jax.tree.map(np.asarray, params)
    pixels = np.random.default_rng(1).standard_normal((4, 32, 32, 3)).astype(np.float32)
    return params, tree, pixels


def test_w8a8_tower_matches_jax(tiny):
    params, tree, pixels = tiny
    qvision = jax_quantize_vision_tower(params["vision"])
    ref = np.asarray(
        jax_encode_image_w8a8(params, qvision, jnp.asarray(pixels), JAX_TINY, dtype=jnp.float32)
    )
    model = params_from_numpy(tree, TINY, quant="int8")
    got = encode_image_w8a8(model, torch.from_numpy(pixels)).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    cos = (got * ref).sum(-1)
    assert cos.min() >= 0.9999, cos
    # the quantized weights are JAX's, layer by layer
    layer0 = model.vision.encoder.layers[0]
    wq = np.concatenate([np.asarray(qvision["attn"][w]["q"][0]) for w in ("wq", "wk", "wv")], 1)
    np.testing.assert_array_equal(layer0.qkv_q.t().numpy(), wq)
    np.testing.assert_array_equal(layer0.fc2_s.numpy(), np.asarray(qvision["mlp"]["w2"]["s"][0]))


def test_w8a8_tower_close_to_fp32(tiny):
    """JAX's own check (tests/test_clip_parity.py:136-158) on the port."""
    _, tree, pixels = tiny
    f32 = encode_image(params_from_numpy(tree, TINY), torch.from_numpy(pixels))
    q = encode_image_w8a8(params_from_numpy(tree, TINY, quant="int8"), torch.from_numpy(pixels))
    cos = (f32 * q).sum(-1)
    assert float(cos.min()) > 0.98, cos


def test_w8a8_model_layout(tiny):
    _, tree, _ = tiny
    model = params_from_numpy(tree, TINY, dtype=torch.bfloat16, quant="int8")
    assert isinstance(model.vision.encoder, EncoderW8A8)
    layer = model.vision.encoder.layers[0]
    d, f = TINY.vision.hidden_size, TINY.vision.mlp_size
    assert layer.qkv_q.dtype == torch.int8 and layer.qkv_q.shape == (3 * d, d)
    assert layer.fc1_q.shape == (f, d) and layer.fc2_q.shape == (d, f)
    assert layer.qkv_s.dtype == torch.float32 and layer.qkv_s.shape == (3 * d,)
    assert layer.qkv_b.dtype == torch.bfloat16 and layer.ln1.weight.dtype == torch.float32
    # the fp32 encoder matrices are gone; the text tower is untouched
    names = {n for n, _ in model.vision.named_parameters()}
    assert not any(n.endswith(("qkv.weight", "fc1.weight")) for n in names)
    assert model.text.encoder.layers[0].qkv.weight.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="not quantized"):
        encode_image_w8a8(params_from_numpy(tree, TINY), torch.zeros((1, 32, 32, 3)))
    with pytest.raises(ValueError, match="quant="):
        params_from_numpy(tree, TINY, quant="int4")
