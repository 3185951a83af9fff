"""Time every kernel of the port and the image towers on the card, with
calls that every version of the port has, so that two checkouts compare in
one call on one card: run this from each, alternating (parent, change,
change, parent).

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
- the W8A8 image tower (``quant="int8"``) at B = 64: ``b64_w8a8_device_ms``
  (CUDA events), and from a trace its device busy ms and K3's and K4's
  shares (``b64_w8a8_device_busy_ms``, ``b64_w8a8_k3_ms``,
  ``b64_w8a8_k4_ms``);
- every kernel at the shape of chip_smoke.py's kernels line (``SHAPES``):
  ``<name>_event_ms``, CUDA-event ms of back-to-back calls (for K2 at this
  size the host's launch time), and ``<name>_device_ms``, the kernel's own
  intervals a call in a torch.profiler trace; plus the host-clock
  microseconds a K2 call and an SDPA call take to return
  (``*_launch_us``, the mean over 2000 calls enqueued back to back);
- every trace is taken after every clock reading, since a profiler
  session slows the host's later launches; ``trace`` says how a trace is
  guarded against the events it can lose.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from imatch_tpu_torch.models.clip.configs import get_config
from imatch_tpu_torch.models.clip.model import encode_image, init_random
from imatch_tpu_torch.ops.kernels import _build
from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
from imatch_tpu_torch.ops.kernels.int4_topk import int4_tile_max, pack_int4
from imatch_tpu_torch.ops.kernels.quantize import ln_quant_rows, quant_rows
from imatch_tpu_torch.ops.kernels.topk import tile_max, tile_max_int8
from imatch_tpu_torch.ops.kernels.topk_t import tile_max_t
from imatch_tpu_torch.scripts._common import card, cuda_ms, unit_rows

CONFIG = "longclip-l14-248"
SEED = 0
K1_ROWS, K1_DIM, K1_TILE = 1 << 20, 768, 512
INGEST_ROWS = 64 * 257  # the bulk-ingest chunk's tokens
# name in the output -> (kernel key, shape), chip_smoke.py's kernels line
SHAPES = {
    "k1_q1": ("K1", "Q=1 x 2^20x768 bf16, tile 512"),
    "k1_q16": ("K1", "Q=16 x 2^20x768 bf16, tile 512 (tensor cores)"),
    "k1_int8_q1": ("K1_int8", "Q=1 x 2^20x768 int8, tile 512"),
    "k2_1x16x257x64": ("K2", "(1, 16, 257, 64) bf16"),
    "k3_16448x4096": ("K3", "(16448, 4096) bf16"),
    "k4_16448x1024": ("K4", "(16448, 1024) bf16"),
    "k5_q8_t2048": ("K5", "Q=8 x 2^20x512 int4, tile 2048"),
    "k6_q8_640_t2048": ("K6", "Q=8 x (640, 2^20) bf16, tile 2048"),
}


def kernel_key(name: str):
    """The port's kernel a profiler event belongs to, by its symbol."""
    if "int4_tile_max" in name:
        return "K5"
    if "tile_max_t_kernel" in name:
        return "K6"
    if "tile_max_int8_kernel" in name:
        return "K1_int8"
    if "tile_max_kernel" in name or "tile_max_mma_kernel" in name:
        return "K1"
    if "flash_fwd_kernel" in name or "flash_fwd_mma_kernel" in name:
        return "K2"
    if "quant_rows" in name:  # template <T, NV, LN> or <T, LN>: LN true is K4
        return "K4" if "true>" in name else "K3"
    return None


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


SPIN_CYCLES = 100_000  # torch.cuda._sleep's spin_kernel, about 50 us: the trace's markers


def trace(fn, iters: int = 5, key=None) -> dict:
    """One torch.profiler trace of ``iters`` calls of ``fn``: a call's
    device busy ms (kernel and copy intervals) and kernel count, ms a call
    by kernel key and by kernel name, and each key's mean ms a launch
    (``mean_ms``).

    A trace can lose events: on an H100 one long process's late traces
    read every kernel at 0.76-0.79x its CUDA-event time, as a trace that
    holds 16 of 20 launches does, and some traces lost the first launches
    of their window. So a kernel's time is its mean over the launches the
    trace holds (every kernel of the port launches once a call), and the
    window opens with a spin kernel, 5 ms on the host's clock and a second
    spin, the marker: only what the trace holds after the marker is
    summed. A trace without the marker, or with no event after it (no
    launch of the kernel ``key`` where one is named), is taken again, up
    to three times, and the last one is kept with ``guarded`` false."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            time.sleep(0.005)
            torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        device = sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda e: e.time_range.start,
        )
        spins = [i for i, e in enumerate(device) if "spin_kernel" in e.name]
        device = device[spins[-1] + 1 :] if spins else device
        guarded = bool(spins) and any(key is None or kernel_key(e.name) == key for e in device)
        if guarded:
            break
    busy, by_key, by_name, launches = 0.0, {}, {}, {}
    for evt in device:
        ms = evt.time_range.elapsed_us() / 1e3
        busy += ms
        k = kernel_key(evt.name)
        if k:
            by_key[k] = by_key.get(k, 0.0) + ms
            launches[k] = launches.get(k, 0) + 1
        by_name[evt.name] = by_name.get(evt.name, 0.0) + ms / iters
    return {
        "busy_ms": busy / iters,
        "ops": len(device) / iters,
        "by_key": {k: ms / iters for k, ms in by_key.items()},
        "mean_ms": {k: ms / launches[k] for k, ms in by_key.items()},
        "by_name": by_name,
        "guarded": guarded,
    }


def kernel_calls(gen: torch.Generator, dev: torch.device) -> dict:
    """One call a kernels-line entry, on seeded inputs at its shape."""
    corpus = unit_rows(gen, (K1_ROWS, K1_DIM), dev).bfloat16()
    valid = torch.ones((K1_ROWS,), dtype=torch.bool, device=dev)
    q1, q16 = corpus[:1].clone(), corpus[:16].clone()
    codes = torch.randint(-127, 128, (K1_ROWS, K1_DIM), generator=gen, device=dev, dtype=torch.int8)
    qi, qscale = codes[:1].clone(), torch.rand((1,), generator=gen, device=dev)
    scale = torch.rand((K1_ROWS,), generator=gen, device=dev)
    qkv = [torch.randn((1, 16, 257, 64), generator=gen, device=dev).bfloat16() for _ in range(3)]
    x3 = torch.randn((INGEST_ROWS, 4096), generator=gen, device=dev).bfloat16()
    x4 = torch.randn((INGEST_ROWS, 1024), generator=gen, device=dev).bfloat16()
    gamma = torch.randn(1024, generator=gen, device=dev) * 0.5 + 1
    beta = torch.randn(1024, generator=gen, device=dev) * 0.1
    c4 = unit_rows(gen, (K1_ROWS, 512), dev)
    packed, side, _, _ = pack_int4(c4, torch.ones((K1_ROWS,), dtype=torch.bool, device=dev))
    del c4
    q8 = unit_rows(gen, (8, 512), dev).bfloat16()
    st = torch.randn((640, K1_ROWS), generator=gen, device=dev).bfloat16()
    q640 = torch.randn((8, 640), generator=gen, device=dev).bfloat16()
    return {
        "k1_q1": lambda: tile_max(q1, corpus, valid, K1_TILE),
        "k1_q16": lambda: tile_max(q16, corpus, valid, K1_TILE),
        "k1_int8_q1": lambda: tile_max_int8(qi, codes, qscale, scale, valid, K1_TILE),
        "k2_1x16x257x64": lambda: flash_mha(*qkv),
        "k3_16448x4096": lambda: quant_rows(x3),
        "k4_16448x1024": lambda: ln_quant_rows(x4, gamma, beta, 1e-5),
        "k5_q8_t2048": lambda: int4_tile_max(q8, packed, side, 2048),
        "k6_q8_640_t2048": lambda: tile_max_t(q640, st, 2048),
        "sdpa_1x16x257x64": lambda: torch.nn.functional.scaled_dot_product_attention(*qkv),
    }


def main(repeats: int = 5, iters: int = 20) -> dict:
    dev = torch.device("cuda")
    _build.build()  # every source at once, before any clock
    cfg = get_config(CONFIG)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = init_random(cfg, device=dev, dtype=torch.bfloat16, generator=gen)
    w8a8 = init_random(cfg, device=dev, dtype=torch.bfloat16, generator=gen, quant="int8")
    size = cfg.vision.image_size
    out = {"card": card(dev), "config": CONFIG, "shapes": {k: s for k, (_, s) in SHAPES.items()}}
    pixels = {b: torch.randn((b, size, size, 3), generator=gen, device=dev).bfloat16() for b in (1, 64)}
    towers = {b: (lambda p=p: encode_image(model, p)) for b, p in pixels.items()}
    w8a8_b64 = lambda: encode_image(w8a8, pixels[64])  # noqa: E731
    for b, fn in towers.items():
        host = [host_ms(fn, iters) for _ in range(repeats)]
        out[f"b{b}_host_ms"] = host
        out[f"b{b}_host_ms_median"] = statistics.median(host)
        out[f"b{b}_device_ms"] = cuda_ms(fn, iters)
    out["b64_w8a8_device_ms"] = cuda_ms(w8a8_b64, 5)

    calls = kernel_calls(gen, dev)
    for name, fn in calls.items():
        if name in SHAPES:
            out[f"{name}_event_ms"] = cuda_ms(fn, iters)
    out["k2_1x16x257x64_launch_us"] = launch_us(calls["k2_1x16x257x64"])
    out["sdpa_1x16x257x64_launch_us"] = launch_us(calls["sdpa_1x16x257x64"])

    for b, fn in towers.items():
        t = trace(fn)
        out[f"b{b}_device_busy_ms"], out[f"b{b}_k2_ms"] = t["busy_ms"], t["by_key"].get("K2", 0.0)
    t = trace(w8a8_b64, 3)
    out["b64_w8a8_device_busy_ms"] = t["busy_ms"]
    out["b64_w8a8_k3_ms"], out["b64_w8a8_k4_ms"] = t["by_key"].get("K3", 0.0), t["by_key"].get("K4", 0.0)
    for name, (key, _) in SHAPES.items():
        out[f"{name}_device_ms"] = trace(calls[name], iters, key)["mean_ms"][key]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    main(args.repeats, args.iters)
