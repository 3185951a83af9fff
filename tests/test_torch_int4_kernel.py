"""K5 (int4 tile max) of the PyTorch port against scripts/exp_int4_kernel.py.

The script is no package, so it is loaded by path. ``pack_int4`` must be
bit-identical to the script's (it runs under jit, where XLA folds
``amax / 7.0`` into a multiply by fp32(1/7)); the plain version must match
the script's Pallas kernel in interpret mode within atol 1e-5 (both sum the
same exact fp32 products, in another order). The CUDA kernel is held to
the plain version on the card by tests/test_torch_kernels_cuda.py.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imatch_tpu_torch.ops.kernels.int4_topk import (
    _check,
    int4_tile_max,
    int4_tile_max_plain,
    pack_int4,
    unpack_int4,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "exp_int4_kernel_jax", os.path.join(REPO, "scripts", "exp_int4_kernel.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data(n=4096, d=512, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((n, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c[5] = 0  # a zero row: scale 1, codes 0
    valid = np.arange(n) % 97 != 0  # some tombstones
    q = rng.standard_normal((8, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qbf = torch.from_numpy(q).bfloat16()
    return c, valid, qbf


def test_pack_int4_bit_identical(script):
    c, valid, _ = _data()
    want = script.pack_int4(jnp.asarray(c), jnp.asarray(valid))
    got = pack_int4(torch.from_numpy(c), torch.from_numpy(valid))
    for name, w, g in zip(("packed", "side", "q", "scale"), want, got):
        w = np.asarray(w.astype(jnp.float32) if name == "side" else w)
        g = g.float().numpy() if name == "side" else g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(unpack_int4(got[0]).numpy(), got[2].numpy())


@pytest.mark.parametrize("tile_n", [512, 1024])
def test_plain_matches_pallas_interpret(script, tile_n):
    c, valid, qbf = _data()
    packed, side, _, _ = script.pack_int4(jnp.asarray(c), jnp.asarray(valid))
    jq = jnp.asarray(qbf.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(script.int4_tile_max(jq, packed, side, tile_n=tile_n, interpret=True))
    p, s, _, _ = pack_int4(torch.from_numpy(c), torch.from_numpy(valid))
    got = int4_tile_max(qbf, p, s, tile_n).numpy()  # CPU tensors: the plain version
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got, int4_tile_max_plain(qbf, p, s, tile_n).numpy())


@pytest.mark.parametrize(
    "nq,d,n,tile_n",
    [
        (3, 512, 4096, 512),  # Q < 8: the card kernel's zero query columns
        (8, 96, 2048, 512),  # H = 48: chunks past the row's 64-byte multiples
        (3, 96, 1024, 16),  # both, at one m-tile a tile
    ],
)
def test_plain_matches_pallas_interpret_other_shapes(script, monkeypatch, nq, d, n, tile_n):
    """The shapes the card kernel's predicates cover, against the script's
    kernel with its module constants (query rows, feature width) set to
    them; interpret mode takes any block shape."""
    monkeypatch.setattr(script, "QP", nq)
    monkeypatch.setattr(script, "D", d)
    monkeypatch.setattr(script, "HALF", d // 2)
    c, valid, _ = _data(n=n, d=d, seed=d + nq)
    rng = np.random.default_rng(nq)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    qbf = torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True)).bfloat16()
    packed, side, _, _ = script.pack_int4(jnp.asarray(c), jnp.asarray(valid))
    jq = jnp.asarray(qbf.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(script.int4_tile_max(jq, packed, side, tile_n=tile_n, interpret=True))
    p, s, _, _ = pack_int4(torch.from_numpy(c), torch.from_numpy(valid))
    np.testing.assert_array_equal(p.numpy(), np.asarray(packed))
    got = int4_tile_max(qbf, p, s, tile_n).numpy()  # CPU tensors: the plain version
    assert got.shape == want.shape == (nq, n // tile_n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_tombstoned_tile_is_neg_inf():
    c, valid, qbf = _data(n=2048)
    valid[512:1024] = False
    p, s, _, _ = pack_int4(torch.from_numpy(c), torch.from_numpy(valid))
    got = int4_tile_max_plain(qbf, p, s, 512)
    assert (got[:, 1] == -3.0e38).all() and (got[:, [0, 2, 3]] > -1).all()


def test_wrapper_refuses_bad_cuda_inputs():
    """Checked before any launch (meta tensors stand in for CUDA ones)."""
    q = torch.empty((8, 512), device="meta", dtype=torch.bfloat16)
    p = torch.empty((4096, 256), device="meta", dtype=torch.int8)
    s = torch.empty((8, 4096), device="meta", dtype=torch.bfloat16)
    _check(q, p, s, 512)
    with pytest.raises(ValueError, match="2 x packed width"):
        _check(q[:, :500], p, s, 512)
    with pytest.raises(TypeError):
        _check(q.float(), p, s, 512)
    with pytest.raises(ValueError, match="side"):
        _check(q, p, s[:2], 512)
    with pytest.raises(ValueError, match="not a multiple"):
        _check(q, p, s, 1000)
    with pytest.raises(ValueError, match="multiple of 16"):
        _check(q[:, :40], p[:, :20], s, 512)


def test_script_port_runs_on_cpu(capsys):
    from imatch_tpu_torch.scripts import exp_int4_kernel

    out = exp_int4_kernel.main(device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    assert out["kernel_matches_plain_torch"] is True and out["card"] == "cpu"
    assert not any(k.endswith("_ms") for k in out)  # no CPU time under a device key
