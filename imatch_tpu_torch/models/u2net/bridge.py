"""Weight bridge between the U²-Net param tree and the port's module.

The tree is the JAX package's layout (``imatch_tpu/models/u2net/model.py``
``init_u2_params``, or ``convert.py``'s ``convert_u2_state_dict``), as
numpy arrays: per RSU block ``{"in", "enc": [...], "bottom", "dec":
[...]}``, each ``{"w": HWIO, "b", "bn": {"scale", "bias", "mean",
"var"}}``; ``"side"`` and ``"outconv"`` as ``{"w": HWIO, "b"}``. The
module (``model.py``) holds OIHW ``nn.Conv2d`` weights under the released
checkpoint's names.

``u2_params_from_numpy`` builds the module from such a tree, so both
packages compute the same function in the tests; ``init_random`` makes
seeded weights with ``init_u2_params``'s distribution (torch's RNG cannot
reproduce ``jax.random.key(0)``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from imatch_tpu_torch.models.u2net.configs import U2NetConfig
from imatch_tpu_torch.models.u2net.model import REBNCONV, RSU, U2Net, cast_compute


def _set(param: torch.Tensor, arr) -> None:
    arr = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(arr.shape)} != parameter {tuple(param.shape)}")
    param.copy_(arr)


def _set_conv(conv, p: Dict) -> None:
    _set(conv.weight, np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1))
    _set(conv.bias, p["b"])


def _set_cbr(m: REBNCONV, p: Dict) -> None:
    _set_conv(m.conv_s1, p)
    bn = m.bn_s1
    _set(bn.weight, p["bn"]["scale"])
    _set(bn.bias, p["bn"]["bias"])
    _set(bn.running_mean, p["bn"]["mean"])
    _set(bn.running_var, p["bn"]["var"])


def _set_rsu(m: RSU, p: Dict) -> None:
    L = m.L
    _set_cbr(m.rebnconvin, p["in"])
    for i in range(1, L):
        _set_cbr(getattr(m, f"rebnconv{i}"), p["enc"][i - 1])
    _set_cbr(getattr(m, f"rebnconv{L}"), p["bottom"])
    for j, i in enumerate(range(L - 1, 0, -1)):
        _set_cbr(getattr(m, f"rebnconv{i}d"), p["dec"][j])


@torch.no_grad()
def u2_params_from_numpy(
    tree: Dict, cfg: U2NetConfig, *, device="cpu", dtype: torch.dtype = torch.float32
) -> U2Net:
    """A U2Net on ``device`` holding ``tree``'s weights, its convolutions
    in ``dtype`` and its BatchNorms in fp32."""
    model = U2Net(cfg)
    n = len(cfg.encoder)
    for i, p in enumerate(tree["encoder"]):
        _set_rsu(getattr(model, f"stage{i + 1}"), p)
    for i, p in enumerate(tree["decoder"]):
        _set_rsu(getattr(model, f"stage{n - 1 - i}d"), p)
    for i, p in enumerate(tree["side"]):
        _set_conv(getattr(model, f"side{i + 1}"), p)
    _set_conv(model.outconv, tree["outconv"])
    return cast_compute(model.to(device), dtype)


@torch.no_grad()
def init_random(
    cfg: U2NetConfig, *, seed: int, device="cpu", dtype: torch.dtype = torch.float32
) -> U2Net:
    """``init_u2_params``'s distribution from a CPU ``torch.Generator``
    seeded with ``seed``: every convolution He-normal (a normal truncated
    at two standard deviations, rescaled to variance 2 / fan_in), zero
    biases, identity BatchNorms. Drawn in fp32 on the CPU, then moved, so
    one seed gives the same weights on every device."""
    g = torch.Generator().manual_seed(seed)
    model = U2Net(cfg)
    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            fan_in = mod.weight[0].numel()
            std = (2.0 / fan_in) ** 0.5 / 0.87962566103423978
            torch.nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std, generator=g)
            mod.bias.zero_()
        elif isinstance(mod, torch.nn.BatchNorm2d):
            mod.reset_parameters()
    return cast_compute(model.to(device), dtype)
