"""Time K2, K1 and the bf16 image tower on the card, with calls that every
version of the port has, so that two checkouts compare in one call on one
card: run this from each, alternating (parent, change, change, parent).

    python -m imatch_tpu_torch.scripts.kernel_ab [--repeats 5] [--iters 20]

prints one JSON line:

- the image tower of LongCLIP-L/14-248 (the reference app's model) at
  full width and depth with seeded random weights, bf16. At B = 1 a call
  is bound by the host's launch rate (about 400 device operations, most
  of the card idle), so its host time measures launch overhead in the
  kernels' wrappers and C entry points: ``b1_host_ms``, each repeat the
  mean of ``iters`` calls that end in a synchronize. At B = 64 (the
  bulk-ingest chunk) ``b64_device_ms`` (CUDA events) and ``b64_k2_ms``
  (K2's share) measure the kernels;
- K2 at one upload's image-tower shape, (1, 16, 257, 64) bf16, and K1
  bf16 at 16 queries over 2^20 x 768 rows, tile 512: CUDA-event ms of
  back-to-back calls (``*_event_ms``; for K2 at this size that is the
  host's launch time) and, for K2, the device ms of its kernel; and the
  host-clock microseconds a K2 call and an SDPA call take to return
  (``*_launch_us``, the mean over 2000 calls enqueued back to back);
- the device busy ms and K2 ms of the tower calls and K2's device ms come
  from torch.profiler traces taken after every clock reading, since a
  profiler session slows the host's later launches.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from imatch_tpu_torch.models.clip.configs import get_config
from imatch_tpu_torch.models.clip.model import encode_image, init_random
from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
from imatch_tpu_torch.ops.kernels.topk import tile_max
from imatch_tpu_torch.scripts._common import card, cuda_ms, unit_rows

CONFIG = "longclip-l14-248"
SEED = 0
K1_ROWS, K1_DIM, K1_QUERIES, K1_TILE = 1 << 20, 768, 16, 512


def host_ms(fn, iters: int) -> float:
    """Mean host-clock ms of one call that ends in a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def launch_us(fn, n: int = 2000) -> float:
    """Host-clock microseconds one call takes to return (enqueue only)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def traced_ms(fn, iters: int = 5):
    """(device busy ms, K2 ms) a call, from the trace's kernel intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = k2 = 0.0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        busy += us
        if "flash_fwd" in evt.name:
            k2 += us
    return busy / iters / 1e3, k2 / iters / 1e3


def main(repeats: int = 5, iters: int = 20) -> dict:
    dev = torch.device("cuda")
    cfg = get_config(CONFIG)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = init_random(cfg, device=dev, dtype=torch.bfloat16, generator=gen)
    size = cfg.vision.image_size
    out = {"card": card(dev), "config": CONFIG}
    towers = {}
    for b in (1, 64):
        pixels = torch.randn((b, size, size, 3), generator=gen, device=dev).bfloat16()
        towers[b] = lambda p=pixels: encode_image(model, p)
    for b, fn in towers.items():
        host = [host_ms(fn, iters) for _ in range(repeats)]
        out[f"b{b}_host_ms"] = host
        out[f"b{b}_host_ms_median"] = statistics.median(host)
        out[f"b{b}_device_ms"] = cuda_ms(fn, iters)

    q, k, v = (torch.randn((1, 16, 257, 64), generator=gen, device=dev).bfloat16() for _ in range(3))
    k2 = lambda: flash_mha(q, k, v)  # noqa: E731
    out["k2_1x16x257x64_event_ms"] = cuda_ms(k2, iters)
    out["k2_1x16x257x64_launch_us"] = launch_us(k2)
    out["sdpa_1x16x257x64_launch_us"] = launch_us(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)
    )
    corpus = unit_rows(gen, (K1_ROWS, K1_DIM), dev).bfloat16()
    valid = torch.ones((K1_ROWS,), dtype=torch.bool, device=dev)
    queries = corpus[:K1_QUERIES].clone()
    out["k1_q16_event_ms"] = cuda_ms(lambda: tile_max(queries, corpus, valid, K1_TILE), iters)

    for b, fn in towers.items():
        out[f"b{b}_device_busy_ms"], out[f"b{b}_k2_ms"] = traced_ms(fn)
    out["k2_1x16x257x64_device_ms"] = traced_ms(k2, iters)[1]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    main(args.repeats, args.iters)
