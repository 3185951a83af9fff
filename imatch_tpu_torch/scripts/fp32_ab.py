"""Time the fp32 kernels (K1's fidelity tier, K2's fp32 towers) on the card
with calls that every version of the port has, so that two checkouts
compare in one call on one card: run this from each, alternating (parent,
change, change, parent).

    python -m imatch_tpu_torch.scripts.fp32_ab [--iters 20] [--only k1|k2]

prints one JSON line with, for every case:

- K1 ``tile_max`` on fp32 queries over a 2^20 x 768 fp32 corpus (unit rows
  from a seed, 1% of rows invalid) at Q = 1, 16, 17, 64 and 256, tile 512,
  and Q = 17 and 256 at tile 2048: the counts that
  ``IMATCH_SCORE_DTYPE=fp32`` sees from single searches, batches,
  coalesced groups and ``/api/search/batch``;
- K2 ``flash_mha`` in fp32 at chip_smoke.py's ``K2_CASES`` shapes (the
  fp32 CLIP towers, the bulk-ingest chunk, the Moondream vision tower);

``event_ms`` (CUDA events round back-to-back calls), ``device_ms`` (the
call's kernel intervals in a torch.profiler trace, kernel_ab.py's
``trace``), ``library_ms`` and ``library_device_ms`` (one PyTorch call of
the same function: matmul + where + amax for K1, SDPA in fp32 for K2),
``bound_ms`` and ``bound_by`` (bytes at 3.35 TB/s against operations at
67 TFLOP/s fp32, each input read once and each output written once), and
the kernel symbols the trace holds. Every trace runs after every clock
reading: a profiler session slows the host's later launches.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from imatch_tpu_torch.ops.kernels import _build
from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
from imatch_tpu_torch.ops.kernels.topk import NEG_INF, tile_max
from imatch_tpu_torch.scripts._common import HBM_BYTES_PER_S, card, cuda_ms, unit_rows
from imatch_tpu_torch.scripts.kernel_ab import trace

FP32_OPS_PER_S = 67e12  # H100 SXM fp32 on the CUDA cores
SEED = 0
K1_ROWS, K1_DIM = 1 << 20, 768
K1_CASES = [(1, 512), (16, 512), (17, 512), (17, 2048), (64, 512), (256, 512), (256, 2048)]
# (B, H, S, Dh), causal, kv_len: chip_smoke.py's K2_CASES
K2_CASES = [
    ((32, 16, 257, 64), False, None),
    ((32, 12, 248, 64), True, None),
    ((32, 12, 50, 64), False, None),
    ((32, 8, 77, 64), True, None),
    ((4, 4, 77, 64), False, 0),
    ((4, 4, 130, 64), False, 70),
    ((1, 16, 257, 64), False, None),
    ((1, 12, 248, 64), True, None),
    ((64, 16, 257, 64), False, None),
    ((1, 16, 729, 72), False, None),
    ((16, 16, 729, 72), False, None),
]


def bound(n_bytes: float, n_ops: float) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k1_bound(q: int, n: int, d: int, tile_n: int) -> tuple:
    return bound(n * d * 4 + n + q * d * 4 + q * (n // tile_n) * 4, 2 * q * n * d)


def k2_bound(b, h, s, dh, causal, kv_len) -> tuple:
    pairs = sum(min(i + 1, kv_len) for i in range(s)) if causal else s * kv_len
    return bound(4 * b * h * s * dh * 4, 4 * b * h * dh * pairs)


def k1_calls(gen, dev) -> dict:
    corpus = unit_rows(gen, (K1_ROWS, K1_DIM), dev)
    valid = torch.rand((K1_ROWS,), generator=gen, device=dev) >= 0.01
    out = {}
    for q, tile_n in K1_CASES:
        qs = corpus[:q].clone()

        def library(qs=qs, tile_n=tile_n):
            s = torch.where(valid[None, :], qs @ corpus.T, NEG_INF)
            return s.view(qs.shape[0], -1, tile_n).amax(2)

        out[f"k1_q{q}_t{tile_n}"] = (
            lambda qs=qs, tile_n=tile_n: tile_max(qs, corpus, valid, tile_n),
            library,
            k1_bound(q, K1_ROWS, K1_DIM, tile_n),
        )
    return out


def k2_calls(gen, dev) -> dict:
    out = {}
    for shape, causal, kv_len in K2_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev) for _ in range(3))
        kv = shape[2] if kv_len is None else kv_len
        name = "k2_" + "x".join(map(str, shape)) + ("_causal" if causal else "") + ("" if kv_len is None else f"_kv{kv_len}")
        library = None
        if kv_len is None:  # SDPA rejects a mask whose rows are all False
            library = lambda q=q, k=k, v=v, c=causal: F.scaled_dot_product_attention(q, k, v, is_causal=c)  # noqa: E731
        out[name] = (
            lambda q=q, k=k, v=v, c=causal, kv=kv: flash_mha(q, k, v, causal=c, kv_len=kv),
            library,
            k2_bound(*shape, causal, kv),
        )
    return out


def main(iters: int = 20, only=None) -> dict:
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 is the fidelity path
    _build.build(("flash_attention", "tile_max"))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    calls = {}
    if only in (None, "k1"):
        calls.update(k1_calls(gen, dev))
    if only in (None, "k2"):
        calls.update(k2_calls(gen, dev))
    out = {"card": card(dev), "torch": torch.__version__, "cases": {}}
    for name, (fn, library, (bms, by)) in calls.items():
        row = {"bound_ms": bms, "bound_by": by, "event_ms": cuda_ms(fn, iters)}
        row["library_ms"] = None if library is None else cuda_ms(library, max(5, iters // 4))
        out["cases"][name] = row
    for name, (fn, library, _) in calls.items():
        row = out["cases"][name]
        t = trace(fn, iters)
        row["device_ms"] = t["busy_ms"] if t["guarded"] else None
        row["kernels"] = sorted(t["by_name"])
        row["device_pct_of_bound"] = None if not row["device_ms"] else 100 * row["bound_ms"] / row["device_ms"]
        row["library_device_ms"] = None
        if library is not None:
            t = trace(library, 5)
            row["library_device_ms"] = t["busy_ms"] if t["guarded"] else None
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("k1", "k2"))
    args = ap.parse_args()
    main(args.iters, args.only)
