"""K6 (tile max over a transposed corpus) of the PyTorch port against
scripts/exp_pallas_search.py.

``phase1_transposed`` in the script has no interpret switch and reads the
module's N, so the test builds the same ``pl.pallas_call`` of
``_tile_max_kernel_T`` itself, in interpret mode. The corpus is the
script's: unit rows of 512, the penalty feature at column 512 (0 valid, -4
invalid; the query has 1 there), padded to 640 or 528. Tolerances: 1e-5
against the Pallas kernel and 1e-6 against K1's plain version on the same
rows (fp32 sums of the same exact bf16 products in another order); 2e-3
between the 528- and 640-wide corpora (the script's bar: the narrower
contraction sums in another order). The CUDA kernel is held to its plain
version on the card by tests/test_torch_kernels_cuda.py.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from imatch_tpu_torch.ops.kernels.topk import tile_max_plain
from imatch_tpu_torch.ops.kernels.topk_t import _check, tile_max_t, tile_max_t_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, QP = 16384, 512, 8


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "exp_pallas_search_jax", os.path.join(REPO, "scripts", "exp_pallas_search.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data(d_pad, seed=0):
    """The script's make_data with numpy: (N, d_pad) bf16 scoring and
    (QP, d_pad) bf16 queries, as torch tensors."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((N, D)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    valid = rng.random(N) > 0.01
    scoring = np.zeros((N, d_pad), np.float32)
    scoring[:, :D] = c
    scoring[:, D] = np.where(valid, 0.0, -4.0)
    q = np.zeros((QP, d_pad), np.float32)
    q[0, :D] = c[17] + 0.1 * rng.standard_normal(D)
    q[0, :D] /= np.linalg.norm(q[0, :D])
    q[1:, :D] = rng.standard_normal((QP - 1, D)) / np.sqrt(D)
    q[:, D] = 1.0
    return torch.from_numpy(scoring).bfloat16(), torch.from_numpy(q).bfloat16()


def _pallas_transposed(script, qs, scoring_t, tile_n):
    d_pad, n = scoring_t.shape
    n_tiles = n // tile_n
    nt_pad = -(-n_tiles // script.GROUP) * script.GROUP
    return pl.pallas_call(
        script._tile_max_kernel_T,
        grid=(n_tiles,),
        in_specs=[
            pl.BlockSpec((QP, d_pad), lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((d_pad, tile_n), lambda i: (0, i), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec(
            (QP, script.GROUP), lambda i: (0, i // script.GROUP), memory_space=pltpu.VMEM
        ),
        out_shape=jax.ShapeDtypeStruct((QP, nt_pad), jnp.float32),
        interpret=True,
    )(qs, scoring_t)[:, :n_tiles]


def _jax_bf16(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("tile_n", [1024, 2048, 4096])
def test_plain_matches_pallas_interpret(script, tile_n):
    scoring, qs = _data(640)
    st = scoring.T.contiguous()
    want = np.asarray(_pallas_transposed(script, _jax_bf16(qs), _jax_bf16(st), tile_n))
    got = tile_max_t(qs, st, tile_n).numpy()  # CPU tensors: the plain version
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got, tile_max_t_plain(qs, st, tile_n).numpy())


@pytest.mark.parametrize("tile_n", [512, 2048])
def test_equals_k1_on_the_transpose(tile_n):
    scoring, qs = _data(640)
    ones = torch.ones((N,), dtype=torch.bool)
    k1 = tile_max_plain(qs, scoring, ones, tile_n)
    k6 = tile_max_t_plain(qs, scoring.T.contiguous(), tile_n)
    torch.testing.assert_close(k6, k1, rtol=0, atol=1e-6)
    # the penalty row keeps invalid rows out of every tile max
    assert (k6[0] > -1).all()


def test_528_against_640():
    s640, q640 = _data(640)
    s528, q528 = _data(528)
    assert torch.equal(s528, s640[:, :528]) and torch.equal(q528, q640[:, :528])
    a = tile_max_t_plain(q640, s640.T.contiguous(), 2048)
    b = tile_max_t_plain(q528, s528.T.contiguous(), 2048)
    torch.testing.assert_close(b[0], a[0], rtol=0, atol=2e-3)


def test_wrapper_refuses_bad_cuda_inputs():
    """Checked before any launch (meta tensors stand in for CUDA ones)."""
    q = torch.empty((8, 640), device="meta", dtype=torch.bfloat16)
    c = torch.empty((640, 8192), device="meta", dtype=torch.bfloat16)
    for tile_n in (256, 512, 1024, 2048, 4096, 8192):
        _check(q, c, tile_n)
    for tile_n in (100, 768, 3072):
        with pytest.raises(ValueError, match="tile_n"):
            _check(q, c, tile_n)
    with pytest.raises(ValueError, match="not a multiple"):
        _check(q, torch.empty((640, 8192 + 512), device="meta", dtype=torch.bfloat16), 1024)
    with pytest.raises(TypeError):
        _check(q.float(), c, 1024)
    with pytest.raises(ValueError, match="transposed corpus"):
        _check(q[:, :528], c, 1024)


def test_script_port_runs_on_cpu(capsys):
    from imatch_tpu_torch.scripts import exp_pallas_search

    out = exp_pallas_search.main(device="cpu", rows=N)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    assert out["transposed_matches"] is True and out["transposed_528_matches"] is True
    assert out["card"] == "cpu" and not any(k.endswith("_ms") for k in out)
