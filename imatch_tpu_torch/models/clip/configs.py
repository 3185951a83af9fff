"""CLIP model family configurations (a copy of imatch_tpu/models/clip/configs.py).

Capability parity with the reference's model layer
(reference app utils.py:16-17,40-45): the reference loads LongCLIP
``zer0int/LongCLIP-GmP-ViT-L-14`` and patches
``text_config.max_position_embeddings`` from 77 to 248. Here the context
length is just a config field; the same architecture serves ViT-B/32
(the BASELINE.json benchmark config), ViT-L/14, and LongCLIP-L/14-248.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS token

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_size(self) -> int:
        return self.hidden_size * self.mlp_ratio


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    max_positions: int = 77
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    eos_token_id: int = 49407

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_size(self) -> int:
        return self.hidden_size * self.mlp_ratio


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    vision: VisionConfig
    text: TextConfig
    projection_dim: int = 512
    logit_scale_init: float = 4.6052  # ln(100), OpenAI CLIP default


# ViT-B/32 — the BASELINE.json benchmark config.
VIT_B32 = CLIPConfig(
    name="vit-b32",
    vision=VisionConfig(
        image_size=224, patch_size=32, hidden_size=768, num_layers=12, num_heads=12
    ),
    text=TextConfig(
        vocab_size=49408, max_positions=77, hidden_size=512, num_layers=12, num_heads=8
    ),
    projection_dim=512,
)

# ViT-L/14 — openai/clip-vit-large-patch14 geometry.
VIT_L14 = CLIPConfig(
    name="vit-l14",
    vision=VisionConfig(
        image_size=224, patch_size=14, hidden_size=1024, num_layers=24, num_heads=16
    ),
    text=TextConfig(
        vocab_size=49408, max_positions=77, hidden_size=768, num_layers=12, num_heads=12
    ),
    projection_dim=768,
)

# LongCLIP L/14 with 248-token text context — the reference's flagship
# (reference app utils.py:16-17 patches max_position_embeddings to 248).
LONGCLIP_L14_248 = CLIPConfig(
    name="longclip-l14-248",
    vision=VisionConfig(
        image_size=224, patch_size=14, hidden_size=1024, num_layers=24, num_heads=16
    ),
    text=TextConfig(
        vocab_size=49408, max_positions=248, hidden_size=768, num_layers=12, num_heads=12
    ),
    projection_dim=768,
)

# Tiny config for fast unit tests (still exercises every code path).
TINY = CLIPConfig(
    name="tiny",
    vision=VisionConfig(
        image_size=32, patch_size=8, hidden_size=64, num_layers=2, num_heads=4
    ),
    text=TextConfig(
        vocab_size=99,
        max_positions=16,
        hidden_size=32,
        num_layers=2,
        num_heads=4,
        eos_token_id=98,
    ),
    projection_dim=48,
)

CONFIGS = {c.name: c for c in [VIT_B32, VIT_L14, LONGCLIP_L14_248, TINY]}


def get_config(name: str) -> CLIPConfig:
    return CONFIGS[name]
