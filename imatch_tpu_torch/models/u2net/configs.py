"""U²-Net configurations (a copy of imatch_tpu/models/u2net/configs.py).

The reference removes backgrounds with rembg -> U²-Net on onnxruntime.
Geometry follows the U²-Net paper's two published variants: ``u2net``
(full, rembg's default, ~44M params) and ``u2netp`` (lite, all mid/out
channels 16/64); ``tiny-u2`` keeps the exact topology at toy widths for
tests.

Each encoder/decoder stage is an RSU-L block described by
(L, C_in, C_mid, C_out, dilated): L conv levels; ``dilated`` marks the
RSU-4F variant (dilation pyramid instead of pooling).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

Stage = Tuple[int, int, int, int, bool]  # (L, c_in, c_mid, c_out, dilated)


@dataclasses.dataclass(frozen=True)
class U2NetConfig:
    name: str
    input_size: int
    encoder: Tuple[Stage, ...]
    decoder: Tuple[Stage, ...]  # stage5d .. stage1d order
    bn_eps: float = 1e-5


U2NET = U2NetConfig(
    name="u2net",
    input_size=320,
    encoder=(
        (7, 3, 32, 64, False),
        (6, 64, 32, 128, False),
        (5, 128, 64, 256, False),
        (4, 256, 128, 512, False),
        (4, 512, 256, 512, True),
        (4, 512, 256, 512, True),
    ),
    decoder=(
        (4, 1024, 256, 512, True),
        (4, 1024, 128, 256, False),
        (5, 512, 64, 128, False),
        (6, 256, 32, 64, False),
        (7, 128, 16, 64, False),
    ),
)

U2NETP = U2NetConfig(
    name="u2netp",
    input_size=320,
    encoder=(
        (7, 3, 16, 64, False),
        (6, 64, 16, 64, False),
        (5, 64, 16, 64, False),
        (4, 64, 16, 64, False),
        (4, 64, 16, 64, True),
        (4, 64, 16, 64, True),
    ),
    decoder=(
        (4, 128, 16, 64, True),
        (4, 128, 16, 64, False),
        (5, 128, 16, 64, False),
        (6, 128, 16, 64, False),
        (7, 128, 16, 64, False),
    ),
)

TINY_U2 = U2NetConfig(
    name="tiny-u2",
    input_size=64,
    encoder=(
        (3, 3, 4, 8, False),
        (3, 8, 4, 8, False),
        (3, 8, 4, 8, False),
        (3, 8, 4, 8, False),
        (3, 8, 4, 8, True),
        (3, 8, 4, 8, True),
    ),
    decoder=(
        (3, 16, 4, 8, True),
        (3, 16, 4, 8, False),
        (3, 16, 4, 8, False),
        (3, 16, 4, 8, False),
        (3, 16, 4, 8, False),
    ),
)

U2_CONFIGS = {c.name: c for c in [U2NET, U2NETP, TINY_U2]}


def get_u2_config(name: str) -> U2NetConfig:
    return U2_CONFIGS[name]
