"""CLIP image preprocessing on the device (resize + crop + normalize).

Counterpart of ``imatch_tpu/ops/preprocess.py`` (``preprocess_core``,
``preprocess_images``), the ``CLIPProcessor`` path of the reference app:
PIL bicubic shortest-edge resize, center crop, rescale, normalize. Decode
stays on the host; the rest is two sampling matmuls per geometry
(``ops/resize.py``): horizontal then vertical, PIL's pass order, with
PIL's round-and-clip to uint8 after each pass, then the CLIP mean/std.

The matmuls run in full fp32 (TF32 is off on the card, device.py), which
is the JAX package's ``IMATCH_RESIZE_PRECISION=highest``: pixels within
one uint8 level of PIL bicubic.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from imatch_tpu_torch.ops.resize import resize_crop_matrices

# OpenAI CLIP normalization constants (transformers OPENAI_CLIP_MEAN/STD).
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def preprocess_core(
    imgs_u8: torch.Tensor,
    a_v: torch.Tensor,
    a_h: torch.Tensor,
    quantize: bool = True,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, out, out, 3) normalized, in ``dtype``;
    ``a_v`` (out, H) and ``a_h`` (out, W) fp32 on the frames' device."""
    x = imgs_u8.float()
    x = torch.einsum("xw,bhwc->bhxc", a_h, x)
    if quantize:
        x = torch.clamp(torch.round(x), 0.0, 255.0)
    x = torch.einsum("yh,bhxc->byxc", a_v, x)
    if quantize:
        x = torch.clamp(torch.round(x), 0.0, 255.0)
    x = x * (1.0 / 255.0)
    mean = torch.from_numpy(CLIP_MEAN).to(x.device)
    std = torch.from_numpy(CLIP_STD).to(x.device)
    return ((x - mean) / std).to(dtype)


def preprocess_images(
    images: Sequence[np.ndarray],
    *,
    device: torch.device,
    out_size: int = 224,
    quantize: bool = True,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Mixed-geometry host API: bucket by (H, W), one device batch per
    bucket, reassembled in input order. Returns (N, out, out, 3)."""
    buckets = {}
    for i, im in enumerate(images):
        if im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"expected HWC RGB uint8 frames, got shape {im.shape}")
        buckets.setdefault(im.shape[:2], []).append(i)
    out = torch.empty(
        (len(images), out_size, out_size, 3), dtype=dtype, device=device
    )
    for (h, w), idxs in buckets.items():
        a_v, a_h = resize_crop_matrices(h, w, out_size)
        frames = torch.from_numpy(np.stack([images[i] for i in idxs])).to(device)
        out[torch.as_tensor(idxs, device=device)] = preprocess_core(
            frames,
            torch.from_numpy(a_v).to(device),
            torch.from_numpy(a_h).to(device),
            quantize=quantize,
            dtype=dtype,
        )
    return out
