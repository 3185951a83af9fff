"""Helpers shared by the experiment scripts: streamed results, the card's
name and power limit, CUDA-event timing and seeded unit rows."""

from __future__ import annotations

import subprocess
import sys

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3: the floors below are this card's


class StreamDict(dict):
    """Streams each measurement to stderr as it lands, so a run that is
    cut keeps its partial results."""

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        print(f"[exp] {k} = {v}", file=sys.stderr, flush=True)


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or 'cpu'."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def unit_rows(g: torch.Generator, shape, device) -> torch.Tensor:
    x = torch.randn(shape, generator=g, device=device)
    return x / x.norm(dim=1, keepdim=True)
