"""Shared batching policy: power-of-two buckets, repeat-last-row padding,
and the one frame normalization every model entry point shares.

A copy of ``imatch_tpu/utils/batching.py`` for tensors and numpy arrays.
Work is split into chunks of at most ``cap`` rows, each padded up to the
next power of two by repeating its last row, and the padding is sliced
off the results: a few stable shapes a path instead of one per batch size.
"""

from __future__ import annotations

import numpy as np
import torch


def pow2_bucket(n: int, cap: int, multiple: int = 1) -> int:
    """Padded size of an ``n``-row chunk: the next power of two, at most
    ``cap``, rounded up to a multiple of ``multiple``."""
    b = min(cap, 1 << max(0, n - 1).bit_length())
    b = max(b, multiple)
    return -(-b // multiple) * multiple


def pad_rows(x, n: int):
    """Pad a (rows, ...) tensor or numpy array up to ``n`` rows by
    repeating the last row."""
    if x.shape[0] >= n:
        return x
    if isinstance(x, np.ndarray):
        reps = np.repeat(x[-1:], n - x.shape[0], axis=0)
        return np.concatenate([x, reps], axis=0)
    return torch.cat([x, x[-1:].expand(n - x.shape[0], *x.shape[1:])], dim=0)


def to_rgb(arr: np.ndarray) -> np.ndarray:
    """Any decoded frame -> HWC RGB: grayscale and single-channel frames
    stack to three channels, RGBA drops alpha."""
    a = np.asarray(arr)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    elif a.ndim == 3 and a.shape[-1] == 1:
        a = np.repeat(a, 3, axis=-1)
    if a.shape[-1] == 4:
        a = a[..., :3]
    return a
