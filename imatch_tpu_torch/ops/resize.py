"""PIL-compatible separable resampling as dense sampling matrices.

The reference preprocesses every image with HF ``CLIPProcessor``
(reference app utils.py:76), whose resize path is PIL bicubic
(shortest edge -> 224) followed by a 224x224 center crop, formulated as
two matmuls: ``out = A_v @ img @ A_h.T`` with sampling matrices built on
the host once per input geometry and cached; the center crop is a
row/column slice of the sampling matrices (free). A copy of
``imatch_tpu/ops/resize.py`` (numpy only).

Weights replicate PIL's ``precompute_coeffs`` (bicubic a=-0.5, support 2,
antialias scaling on downsample), so the float output matches PIL up to
its internal uint8 rounding.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1,
        (a + 2) * ax**3 - (a + 3) * ax**2 + 1,
        np.where(ax < 2, a * ax**3 - 5 * a * ax**2 + 8 * a * ax - 4 * a, 0.0),
    )


def _bilinear(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return np.clip(1 - ax, 0.0, None)


def _lanczos(x: np.ndarray, a: float = 3.0) -> np.ndarray:
    return np.where(np.abs(x) < a, np.sinc(x) * np.sinc(x / a), 0.0)


_FILTERS = {
    "bicubic": (_bicubic, 2.0),
    "bilinear": (_bilinear, 1.0),
    "lanczos": (_lanczos, 3.0),
}


def resample_matrix(
    in_size: int,
    out_size: int,
    filter: str = "bicubic",
    box: Tuple[float, float] = None,
    quantize_8bpc: bool = False,
) -> np.ndarray:
    """(out_size, in_size) row-stochastic sampling matrix, PIL semantics.

    ``quantize_8bpc``: snap each weight to PIL's 8-bit-path fixed point
    (round(w * 2^22) / 2^22, ImagingResampleHorizontal_8bpc's
    normalize_coeffs) — required when emulating PIL's uint8 resample
    bit-for-bit (the pHash grid); the CLIP float path leaves weights
    unquantized. The quantized values are exact in fp32 (<= 24
    significant bits)."""
    fn, support0 = _FILTERS[filter]
    box0, box1 = box if box is not None else (0.0, float(in_size))
    scale = (box1 - box0) / out_size
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    A = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = box0 + (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        xs = np.arange(xmin, xmax)
        w = fn((xs + 0.5 - center) / filterscale)
        s = w.sum()
        if s != 0:
            w = w / s
        A[i, xmin:xmax] = w
    if quantize_8bpc:
        # PIL's normalize_coeffs_8bpc rounds HALF AWAY FROM ZERO
        # (int(x + 0.5) / int(-0.5 + x) truncation), not numpy's
        # half-to-even — an exact .5 tie (reachable: the doubles are
        # finite-precision quotients) would otherwise quantize to a
        # different fixed-point weight than PIL's
        s22 = A * (1 << 22)
        A = np.where(
            s22 >= 0, np.floor(s22 + 0.5), np.ceil(s22 - 0.5)
        ) / (1 << 22)
    return A.astype(np.float32)


def shortest_edge_resize_dims(h: int, w: int, size: int) -> Tuple[int, int]:
    """transformers.get_resize_output_image_size for {"shortest_edge": size}."""
    short, long = (h, w) if h <= w else (w, h)
    new_short = size
    new_long = int(size * long / short)
    return (new_short, new_long) if h <= w else (new_long, new_short)


@functools.lru_cache(maxsize=1024)
def resize_crop_matrices(
    h: int, w: int, out: int = 224, filter: str = "bicubic"
) -> Tuple[np.ndarray, np.ndarray]:
    """Sampling matrices implementing resize(shortest-edge=out) + center crop.

    Returns (A_v (out, h), A_h (out, w)); rows mapping outside the resized
    image are zero (transformers center_crop zero-pads when the resized
    image is smaller than the crop, which cannot happen for shortest-edge
    resize but keeps the contract total).
    """
    rh, rw = shortest_edge_resize_dims(h, w, out)
    top = (rh - out) // 2
    left = (rw - out) // 2
    A_v_full = resample_matrix(h, rh, filter)
    A_h_full = resample_matrix(w, rw, filter)

    def crop_rows(A_full, offset, out_n):
        n_resized = A_full.shape[0]
        A = np.zeros((out_n, A_full.shape[1]), dtype=np.float32)
        for i in range(out_n):
            src = i + offset
            if 0 <= src < n_resized:
                A[i] = A_full[src]
        return A

    return crop_rows(A_v_full, top, out), crop_rows(A_h_full, left, out)
