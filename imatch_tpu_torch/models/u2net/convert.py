"""U²-Net torch checkpoint -> the param tree of the JAX layout.

A copy of ``imatch_tpu/models/u2net/convert.py``. Maps the released
u2net.pth naming (stage1..stage6, stage5d..stage1d, side1..side6,
outconv; each RSU has rebnconvin / rebnconv{i} / rebnconv{i}d with
.conv_s1/.bn_s1 submodules) onto the tree ``bridge.u2_params_from_numpy``
loads. Conv kernels transpose OIHW -> HWIO. The port's module carries the
released names itself, so such a state dict also loads into it with
``load_state_dict``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from imatch_tpu_torch.models.convert_common import to_np
from imatch_tpu_torch.models.u2net.configs import U2NetConfig


def _np(t):
    return to_np(t, dtype=np.float32)


def _cbr(sd: Mapping, prefix: str) -> Dict:
    return {
        "w": _np(sd[f"{prefix}.conv_s1.weight"]).transpose(2, 3, 1, 0).copy(),
        "b": _np(sd[f"{prefix}.conv_s1.bias"]),
        "bn": {
            "scale": _np(sd[f"{prefix}.bn_s1.weight"]),
            "bias": _np(sd[f"{prefix}.bn_s1.bias"]),
            "mean": _np(sd[f"{prefix}.bn_s1.running_mean"]),
            "var": _np(sd[f"{prefix}.bn_s1.running_var"]),
        },
    }


def _rsu(sd: Mapping, stage: str, L: int) -> Dict:
    return {
        "in": _cbr(sd, f"{stage}.rebnconvin"),
        "enc": [_cbr(sd, f"{stage}.rebnconv{i}") for i in range(1, L)],
        "bottom": _cbr(sd, f"{stage}.rebnconv{L}"),
        "dec": [_cbr(sd, f"{stage}.rebnconv{i}d") for i in range(L - 1, 0, -1)],
    }


def convert_u2_state_dict(sd: Mapping, cfg: U2NetConfig) -> Dict:
    params: Dict = {"encoder": [], "decoder": [], "side": []}
    for i, (L, *_rest) in enumerate(cfg.encoder):
        params["encoder"].append(_rsu(sd, f"stage{i + 1}", L))
    n = len(cfg.encoder)
    for i, (L, *_rest) in enumerate(cfg.decoder):
        params["decoder"].append(_rsu(sd, f"stage{n - 1 - i}d", L))
    for i in range(n):
        params["side"].append(
            {
                "w": _np(sd[f"side{i + 1}.weight"]).transpose(2, 3, 1, 0).copy(),
                "b": _np(sd[f"side{i + 1}.bias"]),
            }
        )
    params["outconv"] = {
        "w": _np(sd["outconv.weight"]).transpose(2, 3, 1, 0).copy(),
        "b": _np(sd["outconv.bias"]),
    }
    return params


def load_u2_checkpoint(path: str, cfg: U2NetConfig) -> Dict:
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_u2_state_dict(sd, cfg)
