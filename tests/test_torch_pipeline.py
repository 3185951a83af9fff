"""The port's GPipe against the JAX package's, on 8 devices.

The port's pipeline runs over the model axis of a grid of 8 logical
``cpu`` shards; JAX's over the 8 virtual host devices the root
conftest.py asks for. Ports of tests/test_parallel.py:313-396, and more:

- (stages, microbatches) = (2, 4), (4, 2), (8, 8) on a tanh MLP stack of
  8 layers from numpy weights: the port against JAX's ``lax.scan`` and
  JAX's ``gpipe_scan``, within rtol 1e-5, atol 1e-6; the stack given in
  JAX's form (a dict of stacked tensors) and as a list of layers;
- the gradient of a sum of squares of the output, in x and in the stack,
  against ``jax.grad`` of JAX's ``gpipe_scan`` and of ``lax.scan`` at the
  same (stages, microbatches), within the same bars;
- the tiny CLIP vision encoder from ``jax.random.key(0)``, carried across
  by the bridge, over 2 stages of the port's ``Encoder.layers`` (4
  microbatches): against JAX's ``_encoder(attn_impl="xla")`` within rtol
  2e-4, atol 2e-5;
- a layer count the stages do not divide, and a batch the microbatches
  do not divide, raise ``ValueError``;
- bubble ticks run no layer: the body runs L x M times, not
  L x (M + P - 1) as JAX's SPMD schedule does;
- under autograd the caller's modules take their ``.grad`` when they sit
  on their stages' devices, and a module on another device (it would run
  as a copy that takes the gradient) raises ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imatch_tpu.models.clip import configs as jax_configs
from imatch_tpu.models.clip.model import _encoder as jax_encoder
from imatch_tpu.models.clip.model import init_params
from imatch_tpu.parallel import mesh as jax_mesh
from imatch_tpu.parallel.pipeline import gpipe_scan as jax_gpipe
from imatch_tpu_torch.models.clip.bridge import params_from_numpy
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.parallel import gpipe_scan, make_mesh

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual host devices of the root conftest.py")


def _stack(n_layers=8, b=16, d=32):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, d)).astype(np.float32)
    w = (rng.standard_normal((n_layers, d, d)) * 0.1).astype(np.float32)
    bias = rng.standard_normal((n_layers, d)).astype(np.float32)
    return x, {"w": w, "b": bias}


def _torch_body(h, lp):
    return torch.tanh(h @ lp["w"] + lp["b"]), None


def _jax_body(h, lp):
    return jnp.tanh(h @ lp["w"] + lp["b"]), None


@pytest.mark.parametrize("form", ["stacked", "layers"])
@pytest.mark.parametrize("stages,micro", [(2, 4), (4, 2), (8, 8)])
def test_gpipe_matches_jax_scan_and_gpipe(stages, micro, form):
    x, stacked = _stack()
    tw = {k: torch.from_numpy(v) for k, v in stacked.items()}
    if form == "layers":
        tw = [{"w": tw["w"][i], "b": tw["b"][i]} for i in range(8)]
    got = gpipe_scan(_torch_body, torch.from_numpy(x), tw, mesh=make_mesh(stages, CPU8), microbatches=micro)
    jx, jw = jnp.asarray(x), {k: jnp.asarray(v) for k, v in stacked.items()}
    scan, _ = jax.lax.scan(_jax_body, jx, jw)
    pipe = jax_gpipe(_jax_body, jx, jw, mesh=jax_mesh.make_mesh(model_parallel=stages), microbatches=micro)
    np.testing.assert_allclose(got.numpy(), np.asarray(scan), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(pipe), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stages,micro", [(2, 4), (4, 2), (8, 8)])
def test_gpipe_gradient_matches_jax_grad(stages, micro):
    x, stacked = _stack()
    tx = torch.from_numpy(x).requires_grad_()
    tw = {k: torch.from_numpy(v).requires_grad_() for k, v in stacked.items()}
    out = gpipe_scan(_torch_body, tx, tw, mesh=make_mesh(stages, CPU8), microbatches=micro)
    out.square().sum().backward()
    jx, jw = jnp.asarray(x), {k: jnp.asarray(v) for k, v in stacked.items()}
    mesh = jax_mesh.make_mesh(model_parallel=stages)

    def scan_loss(x, w):
        return jnp.sum(jax.lax.scan(_jax_body, x, w)[0] ** 2)

    def pipe_loss(x, w):
        return jnp.sum(jax_gpipe(_jax_body, x, w, mesh=mesh, microbatches=micro) ** 2)

    for loss in (scan_loss, pipe_loss):
        gx, gw = jax.grad(loss, argnums=(0, 1))(jx, jw)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-6)
        for k in tw:
            np.testing.assert_allclose(tw[k].grad.numpy(), np.asarray(gw[k]), rtol=1e-5, atol=1e-6)


def test_gpipe_clip_encoder_layers_match_jax_encoder():
    jcfg = jax_configs.TINY
    tree = jax.tree.map(np.asarray, init_params(jax.random.key(0), jcfg))
    model = params_from_numpy(tree, TINY, device="cpu", dtype=torch.float32)
    vc = jcfg.vision
    x = np.random.default_rng(1).standard_normal((8, vc.seq_len, vc.hidden_size)).astype(np.float32)
    want = jax_encoder(
        jnp.asarray(x),
        jax.tree.map(jnp.asarray, tree["vision"]["layers"]),
        num_heads=vc.num_heads,
        eps=vc.layer_norm_eps,
        act="quick_gelu",
        causal=False,
        attn_impl="xla",
    )
    with torch.no_grad():
        got = gpipe_scan(
            lambda h, layer: (layer(h, False), None),
            torch.from_numpy(x),
            model.vision.encoder.layers,
            mesh=make_mesh(2, ["cpu"] * 2),
            microbatches=4,
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_gpipe_rejects_uneven_layers():
    x, stacked = _stack(n_layers=6)
    with pytest.raises(ValueError, match="layers not divisible"):
        gpipe_scan(_torch_body, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in stacked.items()},
                   mesh=make_mesh(4, CPU8))  # fmt: skip


def test_gpipe_rejects_uneven_microbatches():
    x, stacked = _stack(b=10)
    with pytest.raises(ValueError, match="microbatches"):
        gpipe_scan(_torch_body, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in stacked.items()},
                   mesh=make_mesh(2, CPU8), microbatches=4)  # fmt: skip


@pytest.mark.parametrize("stages,micro", [(2, 4), (8, 2)])
def test_gpipe_skips_bubble_ticks(stages, micro):
    x, stacked = _stack()
    calls = []

    def body(h, lp):
        calls.append(h.shape[0])
        return _torch_body(h, lp)

    tw = {k: torch.from_numpy(v) for k, v in stacked.items()}
    gpipe_scan(body, torch.from_numpy(x), tw, mesh=make_mesh(stages, CPU8), microbatches=micro)
    assert len(calls) == 8 * micro  # JAX's schedule: 8 / stages * stages * (micro + stages - 1)
    assert set(calls) == {16 // micro}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_gpipe_gradient_reaches_the_callers_modules(device):
    torch.manual_seed(0)
    layers = torch.nn.ModuleList(torch.nn.Linear(8, 8) for _ in range(4)).to(device)
    x = torch.randn(8, 8).requires_grad_()

    def run():
        return gpipe_scan(lambda h, layer: (torch.tanh(layer(h)), None), x, layers,
                          mesh=make_mesh(2, ["cpu"] * 2), microbatches=4)  # fmt: skip

    if device == "meta":  # each stage would run a copy on the CPU
        with pytest.raises(ValueError, match="autograd cannot reach"):
            run()
        return
    run().square().sum().backward()
    want = [torch.autograd.grad(_chain(layers, x.detach()).square().sum(), lin.weight)[0] for lin in layers]
    for lin, w in zip(layers, want):
        torch.testing.assert_close(lin.weight.grad, w, rtol=1e-5, atol=1e-6)


def _chain(layers, h):
    for layer in layers:
        h = torch.tanh(layer(h))
    return h
