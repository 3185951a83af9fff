"""Moondream-class VLM configurations (a copy of
imatch_tpu/models/moondream/configs.py).

A SigLIP-style vision tower whose patch embeddings are projected into the
token space of a Phi-style decoder-only LM (parallel attention + MLP
blocks, partial rotary): the moondream2 architecture family.
``moondream2`` is the published geometry, so a converted checkpoint drops
in (models/moondream/convert.py); ``tiny-md`` exercises every code path
in the tests.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MDVisionConfig:
    image_size: int = 378
    patch_size: int = 14
    hidden_size: int = 1152
    num_layers: int = 27
    num_heads: int = 16
    mlp_size: int = 4304
    layer_norm_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class MDTextConfig:
    vocab_size: int = 51200
    hidden_size: int = 2048
    num_layers: int = 24
    num_heads: int = 32
    rotary_dim: int = 32  # partial rotary, phi-style
    mlp_size: int = 8192
    max_seq: int = 2048
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 50256
    bos_token_id: int = 50256

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class MoondreamConfig:
    name: str
    vision: MDVisionConfig
    text: MDTextConfig
    proj_hidden: int = 8192  # vision->LM projector MLP width


MOONDREAM2 = MoondreamConfig(
    name="moondream2", vision=MDVisionConfig(), text=MDTextConfig()
)

TINY_MD = MoondreamConfig(
    name="tiny-md",
    vision=MDVisionConfig(
        image_size=28,
        patch_size=7,
        hidden_size=32,
        num_layers=2,
        num_heads=4,
        mlp_size=64,
    ),
    text=MDTextConfig(
        vocab_size=300,
        hidden_size=32,
        num_layers=2,
        num_heads=4,
        rotary_dim=4,
        mlp_size=64,
        max_seq=128,
        eos_token_id=257,
        bos_token_id=256,
    ),
    proj_hidden=64,
)

MD_CONFIGS = {c.name: c for c in [MOONDREAM2, TINY_MD]}


def get_md_config(name: str) -> MoondreamConfig:
    return MD_CONFIGS[name]
