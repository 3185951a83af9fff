"""Weight bridge between the Moondream param tree and the port's modules.

The tree is the JAX package's layout (``imatch_tpu/models/moondream/
model.py`` ``init_md_params``, or ``convert.py``'s ``convert_md_state_dict``),
as numpy arrays: per-layer weights stacked along a leading ``(L, ...)``
axis, the patch embedding an HWIO ``(P, P, 3, D)`` kernel, dense weights
``(d_in, d_out)`` applied as ``x @ w + b``. The vision layers have the CLIP
encoder's layout and load through its loader (models/clip/bridge.py).

``md_params_from_numpy`` builds the modules from such a tree, so both
packages compute the same function in the tests; ``init_random`` makes
seeded weights on the card (models/moondream/model.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from imatch_tpu_torch.models.clip.bridge import _f32, _load_encoder, _set
from imatch_tpu_torch.models.moondream.configs import MoondreamConfig
from imatch_tpu_torch.models.moondream.model import (
    MoondreamModel,
    cast_compute,
    init_random,
    pack_text_layers,
)

__all__ = ["md_params_from_numpy", "init_random"]


def _set_linear(lin, w, b) -> None:
    _set(lin.weight, _f32(w).T)
    _set(lin.bias, b)


@torch.no_grad()
def md_params_from_numpy(
    tree: Dict,
    cfg: MoondreamConfig,
    *,
    device="cpu",
    dtype: torch.dtype = torch.float32,
    param_dtype: Optional[torch.dtype] = None,
    packed: bool = True,
) -> MoondreamModel:
    """A MoondreamModel on ``device`` holding ``tree``'s weights, cast as
    ``model.cast_compute`` says, with packed decoder projections unless
    ``packed=False``."""
    with torch.device("meta"):
        model = MoondreamModel(cfg)
    model = model.to_empty(device=device).float()
    vt, pt, tt = tree["vision"], tree["projector"], tree["text"]
    vm, tm = model.vision, model.text
    _set(vm.patch_embedding.weight, _f32(vt["patch_embedding"]["w"]).transpose(3, 2, 0, 1))
    _set(vm.patch_embedding.bias, vt["patch_embedding"]["b"])
    _set(vm.position_embedding, vt["position_embedding"])
    _load_encoder(vm.encoder, vt["layers"])
    _set(vm.post_ln.weight, vt["post_ln"]["scale"])
    _set(vm.post_ln.bias, vt["post_ln"]["bias"])
    _set_linear(model.projector.fc1, pt["w1"], pt["b1"])
    _set_linear(model.projector.fc2, pt["w2"], pt["b2"])
    _set(tm.token_embedding.weight, tt["token_embedding"])
    lt = tt["layers"]
    a, m = lt["attn"], lt["mlp"]
    n = _f32(a["wq"]).shape[0]
    if n != len(tm.layers):
        raise ValueError(f"tree has {n} decoder layers, the model {len(tm.layers)}")
    for i, layer in enumerate(tm.layers):
        _set(layer.ln.weight, lt["ln"]["scale"][i])
        _set(layer.ln.bias, lt["ln"]["bias"][i])
        for name, w, b in (("q", "wq", "bq"), ("k", "wk", "bk"), ("v", "wv", "bv"), ("out", "wo", "bo")):
            _set_linear(getattr(layer, name), a[w][i], a[b][i])
        _set_linear(layer.fc1, m["w1"][i], m["b1"][i])
        _set_linear(layer.fc2, m["w2"][i], m["b2"][i])
    _set(tm.final_ln.weight, tt["final_ln"]["scale"])
    _set(tm.final_ln.bias, tt["final_ln"]["bias"])
    _set_linear(tm.lm_head, tt["lm_head"]["w"], tt["lm_head"]["b"])
    model = cast_compute(model, dtype, param_dtype)
    return pack_text_layers(model) if packed else model
