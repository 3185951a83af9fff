"""CLIP's two towers in plain PyTorch, fp32 with TF32 off: the reference
the served query embeddings are held to.

Written from the published model (HF ``CLIPModel``): pre-LN residual
blocks with quick_gelu, LayerNorm eps from the config. The text tower:
token plus position embeddings, a causal encoder, the final LN, the
position of the first eos pooled, the projection, L2-normalized. The
image tower: the patch convolution (no bias), the class token, position
embeddings, the pre-LN, the encoder, the post-LN of the class token, the
projection, L2-normalized, on pixels from ``resize.clip_pixels``.
Weights are the benchmark's tree (``lib/data.make_weights``), upcast to
fp32.

``int8=True`` is the control: every linear layer's weight quantized per
output channel and its input per row to symmetric int8 (W8A8), the
products then exact in fp32. It stands for the precision one step below
the bf16 the configurations state.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Symmetric int8 of ``x`` along ``dim`` (one scale per slice), back
    in fp32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def _linear(x, w, b=None, int8=False):
    if int8:
        x, w = _q8(x, -1), _q8(w, 1)
    return F.linear(x, w, b)


def _ln(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def encoder(x, p, prefix, layers, heads, eps, int8, causal=True, act="quick_gelu"):
    """Pre-LN residual blocks (``{prefix}.encoder.layers.{i}``: ln1, the
    stacked q/k/v projection, out, ln2, fc1, fc2), causal or not, with
    quick_gelu or tanh-GELU in the MLP."""
    b, s, d = x.shape
    dh = d // heads
    mask = torch.full((s, s), float("-inf"), device=x.device).triu(1) if causal else None
    for i in range(layers):
        n = f"{prefix}.encoder.layers.{i}"
        y = _ln(x, p, f"{n}.ln1", eps)
        qkv = _linear(y, p[f"{n}.qkv.weight"], p[f"{n}.qkv.bias"], int8).view(b, s, 3, heads, dh)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        att = (q @ k.transpose(-1, -2)) / dh**0.5
        if mask is not None:
            att = att + mask
        o = (att.softmax(-1) @ v).transpose(1, 2).reshape(b, s, d)
        x = x + _linear(o, p[f"{n}.out.weight"], p[f"{n}.out.bias"], int8)
        y = _ln(x, p, f"{n}.ln2", eps)
        y = _linear(y, p[f"{n}.fc1.weight"], p[f"{n}.fc1.bias"], int8)
        y = y * torch.sigmoid(1.702 * y) if act == "quick_gelu" else F.gelu(y, approximate="tanh")
        x = x + _linear(y, p[f"{n}.fc2.weight"], p[f"{n}.fc2.bias"], int8)
    return x


def fp32_tree(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in weights.items()}


@torch.no_grad()
def encode_text(p: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor, eos_id: int, int8: bool = False) -> torch.Tensor:
    """(B, S) eos-padded ids -> (B, proj) unit fp32, pooled at the first
    eos."""
    t = cfg["text_config"]
    eps = t["layer_norm_eps"]
    s = ids.shape[1]
    x = p["text.token_embedding.weight"][ids] + p["text.position_embedding"][:s]
    x = encoder(x, p, "text", t["num_hidden_layers"], t["num_attention_heads"], eps, int8)
    x = _ln(x, p, "text.final_ln", eps)
    pos = (ids == eos_id).int().argmax(-1)
    pooled = x[torch.arange(ids.shape[0], device=ids.device), pos]
    return F.normalize(_linear(pooled, p["text.projection.weight"], None, int8), dim=-1)


@torch.no_grad()
def encode_image(p: Dict[str, torch.Tensor], cfg: dict, pixels: torch.Tensor, int8: bool = False) -> torch.Tensor:
    """(B, S, S, 3) CLIP-normalized pixels -> (B, proj) unit fp32."""
    v = cfg["vision_config"]
    eps, ps = v["layer_norm_eps"], v["patch_size"]
    w = p["vision.patch_embedding.weight"]
    x = pixels.permute(0, 3, 1, 2)
    if int8:  # the patch convolution as the linear map of each patch it is
        b, _, hh, ww = x.shape
        patches = x.unfold(2, ps, ps).unfold(3, ps, ps).permute(0, 2, 3, 1, 4, 5).reshape(b, -1, 3 * ps * ps)
        x = _linear(patches, w.reshape(w.shape[0], -1), None, True)
    else:
        x = F.conv2d(x, w, stride=ps).flatten(2).transpose(1, 2)
    cls = p["vision.class_embedding"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + p["vision.position_embedding"]
    x = _ln(x, p, "vision.pre_ln", eps)
    x = encoder(x, p, "vision", v["num_hidden_layers"], v["num_attention_heads"], eps, int8, causal=False)
    x = _ln(x[:, 0], p, "vision.post_ln", eps)
    return F.normalize(_linear(x, p["vision.projection.weight"], None, int8), dim=-1)
