"""Weight bridge between the CLIP param tree and the port's modules.

The tree is the JAX package's layout (``imatch_tpu/models/clip/model.py``
``init_params``, or ``convert.py``'s HF loader), as numpy arrays:

- encoder layers stacked along a leading ``(L, ...)`` axis;
- the patch embedding as an HWIO ``(P, P, 3, D)`` convolution kernel;
- dense weights as ``(d_in, d_out)``, applied as ``x @ w + b``.

The modules (``model.py``) hold one ``EncoderLayer`` per layer, an OIHW
``nn.Conv2d`` weight, ``nn.Linear`` weights as ``(d_out, d_in)`` and the
q, k, v projections stacked into one ``(3 d, d)`` weight.
``params_to_numpy(params_from_numpy(tree))`` gives the tree back exactly
at fp32 (tests/test_torch_clip.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from imatch_tpu_torch.models.clip.configs import CLIPConfig
from imatch_tpu_torch.models.clip.model import CLIPModel, Encoder, quantize_and_cast


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _set(param: torch.Tensor, arr) -> None:
    arr = torch.from_numpy(np.array(_f32(arr), order="C"))
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(arr.shape)} != parameter {tuple(param.shape)}")
    param.copy_(arr)


def _load_encoder(enc: Encoder, tree: Dict) -> None:
    n = len(enc.layers)
    a, m = tree["attn"], tree["mlp"]
    if _f32(a["wq"]).shape[0] != n:
        raise ValueError(f"tree has {_f32(a['wq']).shape[0]} layers, the model {n}")
    for i, layer in enumerate(enc.layers):
        _set(layer.ln1.weight, tree["ln1"]["scale"][i])
        _set(layer.ln1.bias, tree["ln1"]["bias"][i])
        _set(
            layer.qkv.weight,
            np.concatenate([_f32(a[w][i]).T for w in ("wq", "wk", "wv")], axis=0),
        )
        _set(layer.qkv.bias, np.concatenate([_f32(a[b][i]) for b in ("bq", "bk", "bv")]))
        _set(layer.out.weight, _f32(a["wo"][i]).T)
        _set(layer.out.bias, a["bo"][i])
        _set(layer.ln2.weight, tree["ln2"]["scale"][i])
        _set(layer.ln2.bias, tree["ln2"]["bias"][i])
        _set(layer.fc1.weight, _f32(m["w1"][i]).T)
        _set(layer.fc1.bias, m["b1"][i])
        _set(layer.fc2.weight, _f32(m["w2"][i]).T)
        _set(layer.fc2.bias, m["b2"][i])


@torch.no_grad()
def params_from_numpy(
    tree: Dict,
    cfg: CLIPConfig,
    device="cpu",
    dtype: torch.dtype = torch.float32,
    quant: Optional[str] = None,
    shards: int = 1,
) -> CLIPModel:
    """A CLIPModel on ``device`` holding ``tree``'s weights in ``dtype``
    (LayerNorms in fp32). ``quant="int8"`` builds the W8A8 image encoder
    from the tree's fp32 weights before the cast (clip/quant.py), as the
    JAX package's ``quantize_vision_tower`` does from its params.
    ``shards=M``: ``tree`` is one model shard's slice of a tree by
    ``clip_param_specs`` (parallel/sharding.py), the module that shard's."""
    with torch.device("meta"):
        model = CLIPModel(cfg, shards)
    model = model.to_empty(device=device).float()
    vt, tt, vm, tm = tree["vision"], tree["text"], model.vision, model.text
    _set(vm.patch_embedding.weight, _f32(vt["patch_embedding"]).transpose(3, 2, 0, 1))
    _set(vm.class_embedding, vt["class_embedding"])
    _set(vm.position_embedding, vt["position_embedding"])
    _set(vm.pre_ln.weight, vt["pre_ln"]["scale"])
    _set(vm.pre_ln.bias, vt["pre_ln"]["bias"])
    _load_encoder(vm.encoder, vt["layers"])
    _set(vm.post_ln.weight, vt["post_ln"]["scale"])
    _set(vm.post_ln.bias, vt["post_ln"]["bias"])
    _set(vm.projection.weight, _f32(vt["projection"]).T)
    _set(tm.token_embedding.weight, tt["token_embedding"])
    _set(tm.position_embedding, tt["position_embedding"])
    _load_encoder(tm.encoder, tt["layers"])
    _set(tm.final_ln.weight, tt["final_ln"]["scale"])
    _set(tm.final_ln.bias, tt["final_ln"]["bias"])
    _set(tm.projection.weight, _f32(tt["projection"]).T)
    _set(model.logit_scale, _f32(tree["logit_scale"]).reshape(()))
    return quantize_and_cast(model, dtype, quant)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _dump_encoder(enc: Encoder) -> Dict:
    layers = list(enc.layers)
    d = layers[0].out.weight.shape[0]

    def stack(fn):
        return np.stack([fn(layer) for layer in layers])

    def qkv_w(j):
        return stack(lambda l: _np(l.qkv.weight[j * d : (j + 1) * d]).T)

    def qkv_b(j):
        return stack(lambda l: _np(l.qkv.bias[j * d : (j + 1) * d]))

    return {
        "ln1": {
            "scale": stack(lambda l: _np(l.ln1.weight)),
            "bias": stack(lambda l: _np(l.ln1.bias)),
        },
        "attn": {
            "wq": qkv_w(0),
            "wk": qkv_w(1),
            "wv": qkv_w(2),
            "wo": stack(lambda l: _np(l.out.weight).T),
            "bq": qkv_b(0),
            "bk": qkv_b(1),
            "bv": qkv_b(2),
            "bo": stack(lambda l: _np(l.out.bias)),
        },
        "ln2": {
            "scale": stack(lambda l: _np(l.ln2.weight)),
            "bias": stack(lambda l: _np(l.ln2.bias)),
        },
        "mlp": {
            "w1": stack(lambda l: _np(l.fc1.weight).T),
            "b1": stack(lambda l: _np(l.fc1.bias)),
            "w2": stack(lambda l: _np(l.fc2.weight).T),
            "b2": stack(lambda l: _np(l.fc2.bias)),
        },
    }


def params_to_numpy(model: CLIPModel) -> Dict:
    """The param tree of ``model`` as fp32 numpy arrays (the reverse of
    ``params_from_numpy``)."""
    vm, tm = model.vision, model.text
    vision = {
        "patch_embedding": _np(vm.patch_embedding.weight).transpose(2, 3, 1, 0),
        "class_embedding": _np(vm.class_embedding),
        "position_embedding": _np(vm.position_embedding),
        "pre_ln": {"scale": _np(vm.pre_ln.weight), "bias": _np(vm.pre_ln.bias)},
        "layers": _dump_encoder(vm.encoder),
        "post_ln": {"scale": _np(vm.post_ln.weight), "bias": _np(vm.post_ln.bias)},
        "projection": _np(vm.projection.weight).T,
    }
    text = {
        "token_embedding": _np(tm.token_embedding.weight),
        "position_embedding": _np(tm.position_embedding),
        "layers": _dump_encoder(tm.encoder),
        "final_ln": {"scale": _np(tm.final_ln.weight), "bias": _np(tm.final_ln.bias)},
        "projection": _np(tm.projection.weight).T,
    }
    return {"vision": vision, "text": text, "logit_scale": _np(model.logit_scale)}


def _encoder_shapes(n: int, d: int, d_mlp: int) -> Dict:
    return {
        "ln1": {"scale": (n, d), "bias": (n, d)},
        "attn": {
            **{w: (n, d, d) for w in ("wq", "wk", "wv", "wo")},
            **{b: (n, d) for b in ("bq", "bk", "bv", "bo")},
        },
        "ln2": {"scale": (n, d), "bias": (n, d)},
        "mlp": {"w1": (n, d, d_mlp), "b1": (n, d_mlp), "w2": (n, d_mlp, d), "b2": (n, d)},
    }


def tree_shapes(cfg: CLIPConfig) -> Dict:
    """The shape of every leaf of ``cfg``'s param tree, as JAX's
    ``init_params`` lays it out."""
    vc, tc, p = cfg.vision, cfg.text, cfg.projection_dim
    d, t = vc.hidden_size, tc.hidden_size
    return {
        "vision": {
            "patch_embedding": (vc.patch_size, vc.patch_size, 3, d),
            "class_embedding": (d,),
            "position_embedding": (vc.seq_len, d),
            "pre_ln": {"scale": (d,), "bias": (d,)},
            "layers": _encoder_shapes(vc.num_layers, d, vc.mlp_size),
            "post_ln": {"scale": (d,), "bias": (d,)},
            "projection": (d, p),
        },
        "text": {
            "token_embedding": (tc.vocab_size, t),
            "position_embedding": (tc.max_positions, t),
            "layers": _encoder_shapes(tc.num_layers, t, tc.mlp_size),
            "final_ln": {"scale": (t,), "bias": (t,)},
            "projection": (t, p),
        },
        "logit_scale": (),
    }


def named_to_numpy(named: Dict[str, torch.Tensor], cfg: CLIPConfig) -> Dict:
    """``params_to_numpy`` of tensors keyed by the module's parameter names
    (``CLIPModel.named_parameters()``), such as an optimizer's moments: each
    maps exactly as the parameter it belongs to."""
    with torch.device("meta"):
        shadow = CLIPModel(cfg)
    shadow.load_state_dict(named, strict=True, assign=True)
    return params_to_numpy(shadow)


def numpy_to_named(tree: Dict, cfg: CLIPConfig, device="cpu") -> Dict[str, torch.Tensor]:
    """The reverse of ``named_to_numpy``: fp32 tensors on ``device`` keyed
    by the module's parameter names."""
    model = params_from_numpy(tree, cfg, device=device, dtype=torch.float32)
    return {n: p.detach() for n, p in model.named_parameters()}
