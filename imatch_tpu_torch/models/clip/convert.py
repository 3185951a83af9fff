"""HF CLIP checkpoint -> the CLIP param tree (numpy arrays).

A copy of ``imatch_tpu/models/clip/convert.py`` (the port imports nothing
of the JAX package); tests/test_torch_clip.py holds it to the original.
``models/clip/bridge.py`` turns the tree into the port's modules.


The reference loads ``zer0int/LongCLIP-GmP-ViT-L-14`` via
``transformers.CLIPModel.from_pretrained`` (reference app utils.py:41-45).
This converter maps that checkpoint's state dict onto the stacked-layer
pytree used by models/clip/model.py, so real LongCLIP weights (or any HF
CLIP) drop in. The fidelity test (tests/test_clip_parity.py) drives a
randomly initialized ``transformers.CLIPModel`` through this converter and
checks cosine >= 0.999 agreement offline.

torch Linear computes ``x @ W.T + b`` — all weight matrices transpose here
so the tree holds ``(d_in, d_out)`` dense weights, the JAX package's layout.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from imatch_tpu_torch.models.clip.configs import CLIPConfig


def _np(t) -> np.ndarray:
    # shared torch->numpy boundary (handles bf16 checkpoints)
    from imatch_tpu_torch.models.convert_common import to_np

    return to_np(t)


def _stack(sd: Mapping, fmt: str, n: int, transpose: bool = False) -> np.ndarray:
    mats = []
    for i in range(n):
        m = _np(sd[fmt.format(i)])
        mats.append(m.T if transpose else m)
    return np.stack(mats)


def _encoder_from_hf(sd: Mapping, prefix: str, n: int) -> Dict:
    p = prefix
    return {
        "ln1": {
            "scale": _stack(sd, p + ".layers.{}.layer_norm1.weight", n),
            "bias": _stack(sd, p + ".layers.{}.layer_norm1.bias", n),
        },
        "attn": {
            "wq": _stack(sd, p + ".layers.{}.self_attn.q_proj.weight", n, True),
            "wk": _stack(sd, p + ".layers.{}.self_attn.k_proj.weight", n, True),
            "wv": _stack(sd, p + ".layers.{}.self_attn.v_proj.weight", n, True),
            "wo": _stack(sd, p + ".layers.{}.self_attn.out_proj.weight", n, True),
            "bq": _stack(sd, p + ".layers.{}.self_attn.q_proj.bias", n),
            "bk": _stack(sd, p + ".layers.{}.self_attn.k_proj.bias", n),
            "bv": _stack(sd, p + ".layers.{}.self_attn.v_proj.bias", n),
            "bo": _stack(sd, p + ".layers.{}.self_attn.out_proj.bias", n),
        },
        "ln2": {
            "scale": _stack(sd, p + ".layers.{}.layer_norm2.weight", n),
            "bias": _stack(sd, p + ".layers.{}.layer_norm2.bias", n),
        },
        "mlp": {
            "w1": _stack(sd, p + ".layers.{}.mlp.fc1.weight", n, True),
            "b1": _stack(sd, p + ".layers.{}.mlp.fc1.bias", n),
            "w2": _stack(sd, p + ".layers.{}.mlp.fc2.weight", n, True),
            "b2": _stack(sd, p + ".layers.{}.mlp.fc2.bias", n),
        },
    }


def convert_hf_state_dict(sd: Mapping, cfg: CLIPConfig) -> Dict:
    """Map an HF ``CLIPModel.state_dict()`` onto the imatch_tpu pytree."""
    sd = {k: v for k, v in sd.items()}
    vision = {
        # HF conv weight (D, 3, P, P) OIHW -> HWIO for NHWC conv.
        "patch_embedding": _np(
            sd["vision_model.embeddings.patch_embedding.weight"]
        ).transpose(2, 3, 1, 0),
        "class_embedding": _np(sd["vision_model.embeddings.class_embedding"]),
        "position_embedding": _np(
            sd["vision_model.embeddings.position_embedding.weight"]
        ),
        "pre_ln": {
            # HF attribute is literally named "pre_layrnorm".
            "scale": _np(sd["vision_model.pre_layrnorm.weight"]),
            "bias": _np(sd["vision_model.pre_layrnorm.bias"]),
        },
        "layers": _encoder_from_hf(
            sd, "vision_model.encoder", cfg.vision.num_layers
        ),
        "post_ln": {
            "scale": _np(sd["vision_model.post_layernorm.weight"]),
            "bias": _np(sd["vision_model.post_layernorm.bias"]),
        },
        "projection": _np(sd["visual_projection.weight"]).T,
    }
    text = {
        "token_embedding": _np(sd["text_model.embeddings.token_embedding.weight"]),
        "position_embedding": _stretch_positions(
            _np(sd["text_model.embeddings.position_embedding.weight"]),
            cfg.text.max_positions,
        ),
        "layers": _encoder_from_hf(sd, "text_model.encoder", cfg.text.num_layers),
        "final_ln": {
            "scale": _np(sd["text_model.final_layer_norm.weight"]),
            "bias": _np(sd["text_model.final_layer_norm.bias"]),
        },
        "projection": _np(sd["text_projection.weight"]).T,
    }
    return {
        "vision": vision,
        "text": text,
        "logit_scale": _np(sd["logit_scale"]).reshape(()),
    }


def _stretch_positions(pe: "np.ndarray", target: int, keep: int = 20):
    """LongCLIP knowledge-preserving position stretching (77 -> 248).

    Loading a standard 77-position CLIP text checkpoint into a longer
    context: LongCLIP's recipe keeps the first ``keep`` trained positions
    verbatim (they carry most of the positional knowledge) and linearly
    interpolates the remainder onto the longer axis
    (reference app utils.py:40-45 relies on a checkpoint that already
    shipped this; here it's reproduced so any CLIP checkpoint loads into
    longclip-l14-248). No-op when sizes already match.
    """
    import numpy as np

    src = pe.shape[0]
    if src == target:
        return pe
    if src > target:
        return pe[:target]
    keep = min(keep, src - 1)
    head = pe[:keep]
    tail = pe[keep:]
    n_out = target - keep
    # LongCLIP's knowledge-preserving stretch uses the FIXED ratio
    # (src-keep)/(target-keep) — exactly 1/4 for 77->248 with keep=20 —
    # mapping output row keep+i to source position keep + i*ratio and
    # extrapolating flat past the last source row. An endpoint-matched
    # linspace (stride (src-keep-1)/(n_out-1) ~ 0.2467) reproduces the
    # endpoints but NOT the published initialization for every row in
    # between.
    ratio = tail.shape[0] / float(n_out)
    pos = np.minimum(np.arange(n_out) * ratio, tail.shape[0] - 1.0)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, tail.shape[0] - 1)
    frac = (pos - lo)[:, None].astype(pe.dtype)
    stretched = tail[lo] * (1.0 - frac) + tail[hi] * frac
    return np.concatenate([head, stretched], axis=0)


def load_hf_checkpoint(path: str, cfg: CLIPConfig) -> Dict:
    """Load a local HF checkpoint directory (safetensors or torch .bin)."""
    import os

    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(st_path):
        from safetensors.numpy import load_file

        return convert_hf_state_dict(load_file(st_path), cfg)
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(bin_path):
        import torch

        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        return convert_hf_state_dict(sd, cfg)
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin in {path}")
