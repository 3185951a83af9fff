"""Device and dtype policy shared by the port's entry points.

Entry points (``ClipEmbedder``, ``VectorStore``, ``AppState``,
``create_app``, the launcher) run on ``cuda`` unless the caller asks for
the CPU. With no GPU and no such request they raise: they never move to
the CPU on their own.

Compute runs in bfloat16 on the card and float32 on the CPU, as
``imatch_tpu/pipeline/embedder.py`` does on the TPU and the CPU. Paths that
run in float32 on the card must be full float32: ``torch.backends.cuda.
matmul.allow_tf32`` and ``torch.backends.cudnn.allow_tf32`` are both set to
False when a CUDA device is resolved. The first is already PyTorch's
default; the second is not, and it is the one that would silently run the
CLIP patch-embedding convolution in TF32.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` by default; ``cpu`` only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' (IMATCH_DEVICE=cpu "
                "for the launcher) to run on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device} requested but no CUDA device is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}: expected cuda or cpu")
    return device


def default_compute_dtype(device: torch.device) -> torch.dtype:
    """bfloat16 on the card, float32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
