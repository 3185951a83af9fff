"""PIL's separable resampling as dense sampling matrices (NumPy) applied
by two products over the frame's axes (PyTorch): a
frozen copy of PIL's ``precompute_coeffs`` (bicubic a = -0.5, support 2,
the support scaled by the factor when shrinking, the antialiasing that
PIL and HF's image processors apply), and the two preprocessings the
served models take:

- CLIP's (HF ``CLIPImageProcessor``): the shortest edge resized to the
  tower's size, a centre crop, each pass rounded to uint8 as PIL does,
  then CLIP's mean and std;
- Moondream's: the whole frame squashed to the tower's square size
  (bicubic, no crop, no rounding), then mapped to [-1, 1].

Weights and products in float64 (on the device the caller names); the
result is fp32.
"""

from __future__ import annotations

import numpy as np
import torch

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073])
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711])


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    near = (a + 2) * ax**3 - (a + 3) * ax**2 + 1
    far = a * ax**3 - 5 * a * ax**2 + 8 * a * ax - 4 * a
    return np.where(ax <= 1, near, np.where(ax < 2, far, 0.0))


def matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) bicubic sampling matrix, each row summing to 1."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    a = np.zeros((out_size, in_size))
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        w = _bicubic((np.arange(lo, hi) + 0.5 - center) / fscale)
        a[i, lo:hi] = w / w.sum()
    return a


def clip_pixels(frame: np.ndarray, size: int, device="cpu") -> torch.Tensor:
    """(H, W, 3) uint8 -> (size, size, 3) CLIP-normalized fp32."""
    h, w = frame.shape[:2]
    if h <= w:
        rh, rw = size, int(size * w / h)
    else:
        rh, rw = int(size * h / w), size
    top, left = (rh - size) // 2, (rw - size) // 2
    av = matrix(h, rh)[top : top + size]
    ah = matrix(w, rw)[left : left + size]
    x = torch.clamp(torch.round(_resample(frame, av, ah, True, device)), 0, 255)
    mean, std = (torch.from_numpy(a).to(device) for a in (CLIP_MEAN, CLIP_STD))
    return ((x / 255.0 - mean) / std).float()


def squash_pixels(frame: np.ndarray, size: int, device="cpu") -> torch.Tensor:
    """(H, W, 3) uint8 -> (size, size, 3) fp32 in [-1, 1], the whole frame
    resized to the square."""
    h, w = frame.shape[:2]
    x = _resample(frame, matrix(h, size), matrix(w, size), False, device)
    return (x * (2.0 / 255.0) - 1.0).float()


def _resample(frame: np.ndarray, av: np.ndarray, ah: np.ndarray, rounded: bool, device) -> torch.Tensor:
    """(H, W, 3) -> (out_h, out_w, 3) float64: the horizontal pass, then
    the vertical one (PIL's order), each a product over one axis; with
    ``rounded`` each pass is rounded to uint8 levels as PIL's are."""
    x = torch.from_numpy(frame).to(device=device, dtype=torch.float64)
    av, ah = (torch.from_numpy(a).to(device) for a in (av, ah))
    x = torch.tensordot(ah, x, dims=([1], [1])).transpose(0, 1)  # (H, out_w, 3)
    if rounded:
        x = torch.clamp(torch.round(x), 0, 255)
    return torch.tensordot(av, x, dims=([1], [0]))
