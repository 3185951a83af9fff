"""U2NetSegmenter — the rembg.remove equivalent.

Counterpart of ``imatch_tpu/models/u2net/runtime.py``, with its interface:
``predict_mask`` (an (H, W) fp32 alpha in [0, 1]), ``remove_background``
(RGB(A) uint8 -> RGBA uint8 cutout) and ``remove_background_batch``. The
mask is rembg's default post-processing: the saliency min-max normalised,
resized back to the frame (``jax.image.resize``'s bilinear weights,
antialiased when the frame is smaller than the net's input, as sampling
matrices), clipped, then ``* 255 + 0.5`` truncated to uint8.

Inputs (``_model_inputs_batch``): uint8 frames cross to the device and are
cast there, an aspect-squash Lanczos resize to ``input_size`` (the port's
ops/resize.py matrices), a per-image max normalise and ImageNet mean/std.

The batch path makes one forward per geometry chunk of IMATCH_U2_CHUNK
(default 8) frames, padded with zero frames to a power of two, and parks
at ``GATE.checkpoint()`` before each chunk; its alpha is quantized on the
device. Compute is bf16 on the card and fp32 on the CPU (device.py); the
saliency, its sigmoid and the min-max run in fp32.

Weights: IMATCH_U2_CHECKPOINT (a released torch state dict, convert.py)
with IMATCH_U2_CONFIG selecting the geometry (default ``u2net`` with a
checkpoint, ``tiny-u2`` without); ``params=``, a numpy tree in the JAX
layout; else seeded random weights (``bridge.init_random``).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from imatch_tpu_torch.device import DeviceLike, default_compute_dtype, resolve_device
from imatch_tpu_torch.models.u2net.bridge import init_random, u2_params_from_numpy
from imatch_tpu_torch.models.u2net.configs import get_u2_config
from imatch_tpu_torch.ops.resize import resample_matrix
from imatch_tpu_torch.runtime.scheduler import GATE
from imatch_tpu_torch.utils.batching import pow2_bucket, to_rgb

# ImageNet normalization used by the released U²-Net / rembg pipeline.
U2_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
U2_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
SEED = 0  # the random init's, so masks are stable across restarts
_CACHE_GEOMETRIES = 64


def linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) fp32 weights of ``jax.image.resize``'s
    "bilinear" along one axis (``compute_weight_mat``: half-pixel centres,
    the triangle kernel widened by in/out when downsampling, weights
    renormalised over the input, in fp32)."""
    inv = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv, np.float32(1.0))
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32).T.copy()


class U2NetSegmenter:
    available = True

    def __init__(
        self,
        config: Optional[str] = None,
        checkpoint: Optional[str] = None,
        params: Optional[Dict] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.dtype = default_compute_dtype(self.device)
        checkpoint = checkpoint or os.environ.get("IMATCH_U2_CHECKPOINT")
        config = config or os.environ.get("IMATCH_U2_CONFIG", "u2net" if checkpoint else "tiny-u2")
        self.cfg = get_u2_config(config)
        if checkpoint and params is None:
            from imatch_tpu_torch.models.u2net.convert import load_u2_checkpoint

            params = load_u2_checkpoint(checkpoint, self.cfg)
        if params is not None:
            self.model = u2_params_from_numpy(params, self.cfg, device=self.device, dtype=self.dtype)
        else:
            self.model = init_random(self.cfg, seed=SEED, device=self.device, dtype=self.dtype)
        self._mean = torch.from_numpy(U2_MEAN).to(self.device)
        self._std = torch.from_numpy(U2_STD).to(self.device)
        self._lock = threading.Lock()
        self._in_cache: Dict[tuple, tuple] = {}
        self._out_cache: Dict[tuple, tuple] = {}

    @staticmethod
    def _cached(cache: Dict, key: tuple, build):
        if key not in cache:
            if len(cache) >= _CACHE_GEOMETRIES:  # bound the device matrices kept
                cache.pop(next(iter(cache)))
            cache[key] = build()
        return cache[key]

    @torch.no_grad()
    def _mask(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) normalized -> (B, S, S) fp32 saliency, min-max
        normalised per image."""
        m = self.model(x)
        lo = m.amin(dim=(1, 2), keepdim=True)
        hi = m.amax(dim=(1, 2), keepdim=True)
        return (m - lo) / torch.clamp(hi - lo, min=1e-8)

    def _resize_mask(self, m: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """(B, S, S) -> (B, h, w), the axes that change only."""
        s = m.shape[-1]
        a_v, a_h = self._cached(
            self._out_cache,
            (h, w),
            lambda: tuple(
                None if n == s else torch.from_numpy(linear_resize_matrix(s, n)).to(self.device)
                for n in (h, w)
            ),
        )
        if a_v is not None:
            m = torch.einsum("ys,bsx->byx", a_v, m)
        if a_h is not None:
            m = torch.einsum("xs,bys->byx", a_h, m)
        return m

    @torch.no_grad()
    def _model_inputs_batch(self, arrs) -> torch.Tensor:
        """Same-geometry RGB(A) arrays -> (B, 3, S, S) normalized batch:
        aspect-squash Lanczos resize (the mask must map back onto the full
        frame, so no crop), per-image max normalize (rembg divides by the
        image max, not 255), ImageNet mean/std."""
        h, w = arrs[0].shape[:2]
        size = self.cfg.input_size
        a_v, a_h = self._cached(
            self._in_cache,
            (h, w),
            lambda: tuple(
                torch.from_numpy(resample_matrix(n, size, "lanczos")).to(self.device) for n in (h, w)
            ),
        )
        # the native dtype (uint8) crosses to the device, the cast happens there
        x = torch.from_numpy(np.stack([a[..., :3] for a in arrs])).to(self.device)
        x = x.float()
        x = torch.einsum("xw,bhwc->bhxc", a_h, x)
        x = torch.einsum("yh,bhxc->byxc", a_v, x)
        m = x.amax(dim=(1, 2, 3), keepdim=True)
        x = x / torch.clamp(m, min=1e-6)
        x = (x - self._mean) / self._std
        return x.permute(0, 3, 1, 2)

    def predict_mask(self, image) -> np.ndarray:
        """(H, W, 3|4) uint8 -> (H, W) float32 alpha in [0, 1]."""
        arr = to_rgb(image)
        with self._lock:
            m = self._mask(self._model_inputs_batch([arr]))
            m = self._resize_mask(m, arr.shape[0], arr.shape[1])[0]
            return torch.clamp(m, 0.0, 1.0).cpu().numpy()

    def remove_background(self, image) -> np.ndarray:
        """RGB(A) uint8 -> RGBA uint8 cutout (rembg.remove equivalent)."""
        arr = to_rgb(image)
        alpha = (self.predict_mask(arr) * 255.0 + 0.5).astype(np.uint8)
        return np.dstack([arr, alpha])

    def remove_background_batch(self, images) -> list:
        """One forward per (H, W) geometry chunk of IMATCH_U2_CHUNK frames
        (padded with zero frames to a power of two) and one batched resize
        of its masks; the alpha is quantized on the device, so uint8
        crosses back. Results in input order."""
        arrs = [to_rgb(im) for im in images]
        out: list = [None] * len(arrs)
        buckets: Dict[tuple, list] = {}
        for i, a in enumerate(arrs):
            buckets.setdefault(a.shape[:2], []).append(i)
        chunk = int(os.environ.get("IMATCH_U2_CHUNK", "8"))
        with self._lock, torch.no_grad():
            for (h, w), idxs in buckets.items():
                for s0 in range(0, len(idxs), chunk):
                    GATE.checkpoint()  # bulk segmentation yields to searches
                    part = idxs[s0 : s0 + chunk]
                    b = len(part)
                    x = self._model_inputs_batch([arrs[i] for i in part])
                    b_pad = pow2_bucket(b, chunk)
                    if b_pad > b:
                        x = torch.cat([x, x.new_zeros((b_pad - b, *x.shape[1:]))])
                    up = self._resize_mask(self._mask(x)[:b], h, w)
                    alpha8 = (torch.clamp(up, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
                    for j, i in enumerate(part):
                        out[i] = np.dstack([arrs[i], alpha8[j]])
        return out


def get_segmenter(device: DeviceLike = None):
    """Factory from IMATCH_SEGMENTER.

    auto (default): a segmenter only when a checkpoint is configured
    (IMATCH_U2_CHECKPOINT): random-init masks would corrupt uploads, so no
    checkpoint means no segmenter and ``remove_bg`` keeps the original
    frame, as the reference does without rembg. ``u2net`` forces
    construction (the tests use it with the tiny config); ``null``
    disables."""
    choice = os.environ.get("IMATCH_SEGMENTER", "auto")
    if choice == "null":
        return None
    if choice == "auto" and not os.environ.get("IMATCH_U2_CHECKPOINT"):
        return None
    return U2NetSegmenter(device=device)
