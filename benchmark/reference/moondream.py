"""Moondream2 in plain PyTorch, fp32 with TF32 off, with no KV cache: the
reference the captioner's prefill logits and greedy tokens are held to.

Written from the published model (vikhyatk/moondream2, its early
single-crop revisions: a SigLIP so400m vision tower at 378 px, an MLP
projector, the Phi-1.5 decoder):

- vision: the stride-P patch convolution with bias, learned position
  embeddings (no class token, no pre-LN), pre-LN residual blocks with
  tanh-GELU, the post-LN; every patch kept;
- projector: fc1, tanh-GELU, fc2, into the decoder's width;
- decoder: [BOS; image patches; prompt ids after BOS; generated ids], one
  causal forward over the whole sequence; Phi parallel blocks (one
  LayerNorm feeds attention and the MLP, x + attn + mlp), partial rotary
  (GPT-NeoX halves) on the first ``rotary_dim`` dims of each head at base
  ``rope_theta``, tanh-GELU MLP; the final LN and the LM head with bias.

Departures from the published model: the weights are the benchmark's
seeded tree (``captioners/moondream.py``), not the checkpoint; the
projector reads one crop's 1152-wide features (later revisions
concatenate a global and a local crop into 2304). Pixels come from
``resize.squash_pixels``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from .clip import _ln, encoder


def _gelu(x):
    return F.gelu(x, approximate="tanh")


@torch.no_grad()
def encode_image(p: Dict[str, torch.Tensor], cc: dict, pixels: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) pixels in [-1, 1] -> (B, patches, text width) projected
    image features."""
    v = cc["vision_config"]
    ps, eps = v["patch_size"], v["layer_norm_eps"]
    w, b = p["vision.patch_embedding.weight"], p["vision.patch_embedding.bias"]
    x = pixels.permute(0, 3, 1, 2)
    n = x.shape[0]
    patches = x.unfold(2, ps, ps).unfold(3, ps, ps).permute(0, 2, 3, 1, 4, 5).reshape(n, -1, 3 * ps * ps)
    x = F.linear(patches, w.reshape(w.shape[0], -1), b)
    x = x + p["vision.position_embedding"]
    x = encoder(x, p, "vision", v["num_hidden_layers"], v["num_attention_heads"], eps, False, causal=False, act="gelu_tanh")
    x = _ln(x, p, "vision.post_ln", eps)
    x = _gelu(F.linear(x, p["projector.fc1.weight"], p["projector.fc1.bias"]))
    return F.linear(x, p["projector.fc2.weight"], p["projector.fc2.bias"])


def _rotary(x: torch.Tensor, rotary_dim: int, theta: float) -> torch.Tensor:
    """x (B, H, S, Dh) at positions 0 .. S-1: the first ``rotary_dim`` dims
    rotated in two halves."""
    half = rotary_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half))
    ang = torch.arange(x.shape[2], dtype=torch.float64, device=x.device)[:, None] * freqs[None]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2, rest = x[..., :half], x[..., half:rotary_dim], x[..., rotary_dim:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], dim=-1)


@torch.no_grad()
def logits(p: Dict[str, torch.Tensor], cc: dict, image: torch.Tensor, ids: Sequence[int], last: int) -> torch.Tensor:
    """The decoder's fp32 logits (last, V) at the sequence's ``last``
    positions, for [ids[0]; image (P, D); ids[1:]]: ``ids`` is BOS, the
    prompt and the tokens fed after it."""
    t = cc["text_config"]
    d, heads, eps = t["hidden_size"], t["num_attention_heads"], t["layer_norm_eps"]
    dh = d // heads
    rot = int(round(t["partial_rotary_factor"] * dh))
    emb = p["text.token_embedding.weight"][torch.as_tensor(list(ids), device=image.device)]
    x = torch.cat([emb[:1], image, emb[1:]])[None]
    s = x.shape[1]
    mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
    for i in range(t["num_hidden_layers"]):
        n = f"text.layers.{i}"
        y = _ln(x, p, f"{n}.ln", eps)
        q, k, v = (F.linear(y, p[f"{n}.{c}.weight"], p[f"{n}.{c}.bias"]).view(1, s, heads, dh).transpose(1, 2)
                   for c in ("q", "k", "v"))
        q, k = _rotary(q, rot, t["rope_theta"]), _rotary(k, rot, t["rope_theta"])
        att = ((q @ k.transpose(-1, -2)) / dh**0.5 + mask).softmax(-1)
        o = (att @ v).transpose(1, 2).reshape(1, s, d)
        mlp = F.linear(_gelu(F.linear(y, p[f"{n}.fc1.weight"], p[f"{n}.fc1.bias"])),
                       p[f"{n}.fc2.weight"], p[f"{n}.fc2.bias"])
        x = x + F.linear(o, p[f"{n}.out.weight"], p[f"{n}.out.bias"]) + mlp
    h = _ln(x[0, s - last:], p, "text.final_ln", eps)
    return F.linear(h, p["text.lm_head.weight"], p["text.lm_head.bias"])
