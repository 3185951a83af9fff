"""CLIP image and text towers as PyTorch modules.

Counterpart of ``imatch_tpu/models/clip/model.py`` (``_vision_stem``,
``_encoder``, ``encode_image``, ``encode_text``), and like it numerically
the HF ``transformers.CLIPModel`` forward:

- quick_gelu, LayerNorm eps 1e-5 computed in fp32, pre-LN residual blocks;
- vision: stride-P patch convolution (no bias) + CLS token + learned
  positions, pre-LN, encoder, post-LN on the CLS token, projection;
- text: token + position embeddings, causal encoder, final LN, pooled at
  the FIRST eos token, projection;
- L2-normalised fp32 embeddings.

Weights live in the module in the compute dtype (bf16 on the card, fp32
on the CPU) except the LayerNorms, which stay fp32. Attention goes through
``ops/attention.py``: K2 for CUDA tensors. The public functions keep the
JAX package's layouts: ``encode_image`` takes NHWC pixels, ``encode_text``
eos-padded int token ids. ``models/clip/bridge.py`` converts the JAX
param tree to these modules and back.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from imatch_tpu_torch.models.clip.configs import CLIPConfig, TextConfig, VisionConfig
from imatch_tpu_torch.ops.attention import mha


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in fp32 on any input dtype; returns the input's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        ).to(x.dtype)


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x)
    if name == "gelu_tanh":  # the Moondream vision tower's (models/moondream)
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name}")


class EncoderLayer(nn.Module):
    """One pre-LN residual block: attention then MLP."""

    def __init__(self, d: int, d_mlp: int, num_heads: int, eps: float, act: str):
        super().__init__()
        self.num_heads = num_heads
        self.act = act
        self.ln1 = LayerNorm32(d, eps=eps)
        self.qkv = nn.Linear(d, 3 * d)  # q, k, v stacked along the output
        self.out = nn.Linear(d, d)
        self.ln2 = LayerNorm32(d, eps=eps)
        self.fc1 = nn.Linear(d, d_mlp)
        self.fc2 = nn.Linear(d_mlp, d)

    def forward(self, h: torch.Tensor, causal: bool) -> torch.Tensor:
        b, s, d = h.shape
        nh = self.num_heads
        qkv = self.qkv(self.ln1(h)).view(b, s, 3, nh, d // nh)
        # (B, H, S, Dh) views of the fused projection; K2 reads them in place
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = mha(q, k, v, causal=causal)
        h = h + self.out(o.transpose(1, 2).reshape(b, s, d))
        y = _act(self.fc1(self.ln2(h)), self.act)
        return h + self.fc2(y)


class Encoder(nn.Module):
    def __init__(self, num_layers, d, d_mlp, num_heads, eps, act):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d, d_mlp, num_heads, eps, act) for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, causal)
        return x


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig, projection_dim: int):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.patch_embedding = nn.Conv2d(
            3, d, cfg.patch_size, stride=cfg.patch_size, bias=False
        )
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.position_embedding = nn.Parameter(torch.empty(cfg.seq_len, d))
        self.pre_ln = LayerNorm32(d, eps=cfg.layer_norm_eps)
        self.encoder = Encoder(
            cfg.num_layers, d, cfg.mlp_size, cfg.num_heads, cfg.layer_norm_eps, cfg.hidden_act
        )
        self.post_ln = LayerNorm32(d, eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(d, projection_dim, bias=False)

    def stem(self, pixels: torch.Tensor) -> torch.Tensor:
        """Patch conv + CLS + positions + pre-LN: (B, H, W, 3) -> (B, S, D).
        One definition for the bf16 and the W8A8 encoder (clip/quant.py)."""
        w = self.patch_embedding.weight
        x = self.patch_embedding(pixels.to(w.dtype).permute(0, 3, 1, 2))
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # (B, patches, D), row-major patches
        cls = self.class_embedding.to(x.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embedding.to(x.dtype)
        return self.pre_ln(x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Post-LN of the CLS token and projection -> (B, proj) fp32."""
        return self.projection(self.post_ln(x[:, 0, :])).float()

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) preprocessed pixels -> (B, proj) unnormalised fp32.
        ``self.encoder`` is the bf16 ``Encoder`` or, once
        ``quantize_vision_tower`` ran, the W8A8 one."""
        return self.head(self.encoder(self.stem(pixels), causal=False))


class TextTower(nn.Module):
    def __init__(self, cfg: TextConfig, projection_dim: int):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, d)
        self.position_embedding = nn.Parameter(torch.empty(cfg.max_positions, d))
        self.encoder = Encoder(
            cfg.num_layers, d, cfg.mlp_size, cfg.num_heads, cfg.layer_norm_eps, cfg.hidden_act
        )
        self.final_ln = LayerNorm32(d, eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(d, projection_dim, bias=False)

    def forward(self, token_ids: torch.Tensor, eos_id: int) -> torch.Tensor:
        """(B, S) eos-padded ids -> (B, proj) unnormalised fp32, pooled at
        the first eos (HF's argmax pooling under eos padding)."""
        b, s = token_ids.shape
        x = self.token_embedding(token_ids) + self.position_embedding[:s].to(
            self.token_embedding.weight.dtype
        )
        x = self.final_ln(self.encoder(x, causal=True))
        eos_pos = (token_ids == eos_id).int().argmax(dim=-1)
        pooled = x[torch.arange(b, device=x.device), eos_pos]
        return self.projection(pooled).float()


class CLIPModel(nn.Module):
    """Both towers; LayerNorm parameters fp32, everything else in the
    compute dtype the bridge or ``init_random`` gives it."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.vision = VisionTower(cfg.vision, cfg.projection_dim)
        self.text = TextTower(cfg.text, cfg.projection_dim)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.logit_scale_init))


def init_random(
    cfg: CLIPConfig,
    *,
    device: torch.device,
    dtype: torch.dtype,
    generator: torch.Generator,
    quant: Optional[str] = None,
) -> CLIPModel:
    """The JAX init's distribution (normal(0.02) weights, zero biases, unit
    LayerNorms) from a torch Generator. Its numbers differ from
    ``init_params(jax.random.key(0))``: torch cannot reproduce JAX's RNG,
    so parity runs carry the JAX tree across with the bridge instead.
    The weights are drawn in fp32 whatever ``dtype``, so one seed gives
    the same master weights at every dtype; ``quant="int8"`` quantizes
    the image encoder from them before the cast (clip/quant.py)."""
    with torch.device("meta"):
        model = CLIPModel(cfg)
    model = model.to_empty(device=device)
    with torch.no_grad():
        for mod in model.modules():
            for leaf, p in mod.named_parameters(recurse=False):
                if isinstance(mod, LayerNorm32):
                    p.fill_(1.0 if leaf == "weight" else 0.0)
                elif leaf == "logit_scale":
                    p.fill_(cfg.logit_scale_init)
                elif leaf == "bias":
                    p.zero_()
                else:
                    p.normal_(0.0, 0.02, generator=generator)
    return quantize_and_cast(model, dtype, quant)


def quantize_and_cast(
    model: CLIPModel, dtype: torch.dtype, quant: Optional[str] = None
) -> CLIPModel:
    """``cast_compute`` after an optional ``quant="int8"`` of the image
    encoder, which reads the fp32 master weights: quantizing bf16-rounded
    ones would give other codes than the JAX package's."""
    if quant == "int8":
        # clip/quant.py builds on this module, so it is imported here
        from imatch_tpu_torch.models.clip.quant import quantize_vision_tower

        quantize_vision_tower(model.vision)
    elif quant not in (None, "", "none"):
        raise ValueError(f"quant={quant!r}: expected 'int8' or None")
    return cast_compute(model, dtype)


def cast_compute(model: CLIPModel, dtype: torch.dtype) -> CLIPModel:
    """Everything to ``dtype`` except the LayerNorms and logit scale."""
    for mod in model.modules():
        if isinstance(mod, LayerNorm32):
            continue
        for name, p in mod.named_parameters(recurse=False):
            if name != "logit_scale":
                p.data = p.data.to(dtype)
    return model.eval().requires_grad_(False)


def _normalize(feats: torch.Tensor) -> torch.Tensor:
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


@torch.no_grad()
def encode_image(model: CLIPModel, pixels: torch.Tensor) -> torch.Tensor:
    """Image tower: (B, H, W, 3) preprocessed NHWC floats -> (B, proj)
    L2-normalised fp32."""
    return _normalize(model.vision(pixels))


@torch.no_grad()
def encode_text(
    model: CLIPModel,
    token_ids: torch.Tensor,
    *,
    eos_token_id: Optional[int] = None,
) -> torch.Tensor:
    """Text tower: (B, S) eos-padded ids -> (B, proj) L2-normalised fp32.
    ``eos_token_id`` overrides the config's (alternate vocabularies)."""
    eos = model.cfg.text.eos_token_id if eos_token_id is None else eos_token_id
    return _normalize(model.text(token_ids, eos))
