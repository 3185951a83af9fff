"""Shared torch-checkpoint -> numpy boundary for the model converters.

A copy of ``imatch_tpu/models/convert_common.py``; the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def to_np(t, dtype=None) -> np.ndarray:
    """torch tensor or array-like -> numpy, without importing torch at
    module scope. bfloat16 tensors upcast through ``.float()``:
    torch's ``.numpy()`` raises TypeError on bf16 (numpy has no such
    dtype), and bf16-saved checkpoints are the norm for VLM-era
    models — the converters exist precisely to load them."""
    if isinstance(t, np.ndarray):
        return t if dtype is None else np.asarray(t, dtype=dtype)
    if hasattr(t, "detach"):
        t = t.detach().cpu()
        try:
            t = t.numpy()
        except TypeError:  # bfloat16 / other numpy-incompatible dtype
            t = t.float().numpy()
    return np.asarray(t) if dtype is None else np.asarray(t, dtype=dtype)
