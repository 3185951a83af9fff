"""Moondream2 HF checkpoint -> the Moondream param tree, as numpy (a copy
of imatch_tpu/models/moondream/convert.py).

Maps the vikhyatk/moondream2 state-dict layout (SigLIP vision encoder
``vision_encoder.encoder.model.visual.*`` + projector ``vision_encoder
.projection.*`` + Phi decoder ``text_model.transformer.h.N.*``) onto the
stacked-layer tree that models/moondream/bridge.py loads. Offline
environments run the same architecture from seeded random weights; this
converter is exercised in tests through a synthetic state dict with the
same naming scheme, so a real checkpoint drops in without code changes.

Linear weights are transposed ((out, in) -> (in, out)); per-layer tensors
are stacked along a leading num_layers axis.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from imatch_tpu_torch.models.moondream.configs import MoondreamConfig


def _np(t):
    # shared torch->numpy boundary (handles bf16 checkpoints)
    from imatch_tpu_torch.models.convert_common import to_np

    return to_np(t, dtype=np.float32)


def _split_qkv(wqkv, bqkv, wo, bo):
    """HF packs [q; k; v] along the output dim; the tree keeps them
    separate."""
    wq, wk, wv = np.split(wqkv, 3, axis=2)  # (L, D, 3D) -> 3x (L, D, D)
    bq, bk, bv = np.split(bqkv, 3, axis=1)
    return {
        "wq": wq, "wk": wk, "wv": wv,
        "bq": bq, "bk": bk, "bv": bv,
        "wo": wo, "bo": bo,
    }


def _stack(sd: Mapping, tmpl: str, n: int, *, transpose=False):
    ts = []
    for i in range(n):
        a = _np(sd[tmpl.format(i=i)])
        ts.append(a.T if transpose else a)
    return np.stack(ts)


def convert_md_state_dict(sd: Mapping, cfg: MoondreamConfig) -> Dict:
    v, t = cfg.vision, cfg.text
    vis = "vision_encoder.encoder.model.visual"
    proj = "vision_encoder.projection"
    txt = "text_model.transformer"

    # conv patch embed may be stored as a linear over flattened patches
    pw = _np(sd[f"{vis}.patch_embed.linear.weight"])  # (D, P*P*3)
    patch_w = (
        pw.reshape(v.hidden_size, 3, v.patch_size, v.patch_size)
        .transpose(2, 3, 1, 0)  # HWIO
        .copy()
    )
    vision = {
        "patch_embedding": {
            "w": patch_w,
            "b": _np(sd[f"{vis}.patch_embed.linear.bias"]),
        },
        "position_embedding": _np(sd[f"{vis}.pos_embed"]).reshape(
            v.num_patches, v.hidden_size
        ),
        "layers": {
            "ln1": {
                "scale": _stack(sd, vis + ".blocks.{i}.norm1.weight", v.num_layers),
                "bias": _stack(sd, vis + ".blocks.{i}.norm1.bias", v.num_layers),
            },
            "attn": _split_qkv(
                _stack(
                    sd, vis + ".blocks.{i}.attn.qkv.weight", v.num_layers,
                    transpose=True,
                ),
                _stack(sd, vis + ".blocks.{i}.attn.qkv.bias", v.num_layers),
                _stack(
                    sd, vis + ".blocks.{i}.attn.proj.weight", v.num_layers,
                    transpose=True,
                ),
                _stack(sd, vis + ".blocks.{i}.attn.proj.bias", v.num_layers),
            ),
            "ln2": {
                "scale": _stack(sd, vis + ".blocks.{i}.norm2.weight", v.num_layers),
                "bias": _stack(sd, vis + ".blocks.{i}.norm2.bias", v.num_layers),
            },
            "mlp": {
                "w1": _stack(
                    sd, vis + ".blocks.{i}.mlp.fc1.weight", v.num_layers,
                    transpose=True,
                ),
                "b1": _stack(sd, vis + ".blocks.{i}.mlp.fc1.bias", v.num_layers),
                "w2": _stack(
                    sd, vis + ".blocks.{i}.mlp.fc2.weight", v.num_layers,
                    transpose=True,
                ),
                "b2": _stack(sd, vis + ".blocks.{i}.mlp.fc2.bias", v.num_layers),
            },
        },
        "post_ln": {
            "scale": _np(sd[f"{vis}.norm.weight"]),
            "bias": _np(sd[f"{vis}.norm.bias"]),
        },
    }
    projector = {
        "w1": _np(sd[f"{proj}.mlp.fc1.weight"]).T,
        "b1": _np(sd[f"{proj}.mlp.fc1.bias"]),
        "w2": _np(sd[f"{proj}.mlp.fc2.weight"]).T,
        "b2": _np(sd[f"{proj}.mlp.fc2.bias"]),
    }
    text = {
        "token_embedding": _np(sd[f"{txt}.embd.wte.weight"]),
        "layers": {
            "ln": {
                "scale": _stack(sd, txt + ".h.{i}.ln.weight", t.num_layers),
                "bias": _stack(sd, txt + ".h.{i}.ln.bias", t.num_layers),
            },
            "attn": _split_qkv(
                _stack(
                    sd, txt + ".h.{i}.mixer.Wqkv.weight", t.num_layers,
                    transpose=True,
                ),
                _stack(sd, txt + ".h.{i}.mixer.Wqkv.bias", t.num_layers),
                _stack(
                    sd, txt + ".h.{i}.mixer.out_proj.weight", t.num_layers,
                    transpose=True,
                ),
                _stack(sd, txt + ".h.{i}.mixer.out_proj.bias", t.num_layers),
            ),
            "mlp": {
                "w1": _stack(
                    sd, txt + ".h.{i}.mlp.fc1.weight", t.num_layers, transpose=True
                ),
                "b1": _stack(sd, txt + ".h.{i}.mlp.fc1.bias", t.num_layers),
                "w2": _stack(
                    sd, txt + ".h.{i}.mlp.fc2.weight", t.num_layers, transpose=True
                ),
                "b2": _stack(sd, txt + ".h.{i}.mlp.fc2.bias", t.num_layers),
            },
        },
        "final_ln": {
            "scale": _np(sd["text_model.lm_head.ln.weight"]),
            "bias": _np(sd["text_model.lm_head.ln.bias"]),
        },
        "lm_head": {
            "w": _np(sd["text_model.lm_head.linear.weight"]).T,
            "b": _np(sd["text_model.lm_head.linear.bias"]),
        },
    }
    return {"vision": vision, "projector": projector, "text": text}


def load_md_checkpoint(path: str, cfg: MoondreamConfig) -> Dict:
    """Load a .safetensors / torch .pt moondream checkpoint from disk."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        sd = load_file(path)
    else:
        import torch

        sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_md_state_dict(sd, cfg)
