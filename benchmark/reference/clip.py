"""CLIP's text tower in plain PyTorch, fp32 with TF32 off: the reference
the served query embeddings are held to.

Written from the published model (HF ``CLIPModel``): pre-LN residual
blocks with quick_gelu, LayerNorm eps from the config; token plus
position embeddings, a causal encoder, the final LN, the position of the
first eos pooled, the projection, L2-normalized. Weights are the
benchmark's tree (``lib/data.make_weights``), upcast to fp32.

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


def _causal_encoder(x, p, prefix, layers, heads, eps, int8):
    b, s, d = x.shape
    dh = d // heads
    mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
    for i in range(layers):
        n = f"{prefix}.encoder.layers.{i}"
        y = _ln(x, p, f"{n}.ln1", eps)
        qkv = _linear(y, p[f"{n}.qkv.weight"], p[f"{n}.qkv.bias"], int8).view(b, s, 3, heads, dh)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        att = (q @ k.transpose(-1, -2)) / dh**0.5 + mask
        o = (att.softmax(-1) @ v).transpose(1, 2).reshape(b, s, d)
        x = x + _linear(o, p[f"{n}.out.weight"], p[f"{n}.out.bias"], int8)
        y = _ln(x, p, f"{n}.ln2", eps)
        y = _linear(y, p[f"{n}.fc1.weight"], p[f"{n}.fc1.bias"], int8)
        y = y * torch.sigmoid(1.702 * y)
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
    x = _causal_encoder(x, p, "text", t["num_hidden_layers"], t["num_attention_heads"], eps, int8)
    x = _ln(x, p, "text.final_ln", eps)
    pos = (ids == eos_id).int().argmax(-1)
    pooled = x[torch.arange(ids.shape[0], device=ids.device), pos]
    return F.normalize(_linear(pooled, p["text.projection.weight"], None, int8), dim=-1)
