#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (imatch_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. Identify the card (nvidia-smi name and power limit, torch and CUDA
   versions, whether PIL is installed).
2. Build the CUDA kernels from imatch_tpu_torch/csrc/ with nvcc, one
   process a source, all started together.
3. K2 (flash attention) against its plain PyTorch version at the CLIP
   towers' shapes, bf16 and fp32, with a fully masked case, at the
   bulk-ingest chunk (64, 16, 257, 64), and at the Moondream vision
   tower's (1, 16, 729, 72) and (16, 16, 729, 72). bf16 runs the
   tensor-core kernel (flash_fwd_mma_kernel), fp32 the CUDA-core one
   (flash_fwd_kernel).
4. K1 (tile max) against its plain version, and the K1 engine against a
   full fp32 brute-force top-k, on a 2^20 x 768 corpus with tombstones and
   duplicate rows, at Q = 1 and 16 (bf16 at Q = 16 runs the tensor-core
   kernel, tile_max_mma_kernel); then K1's int8 variant, bit-identical to
   its plain version, and the int8 engine against the brute force, on the
   same corpus at Q = 1, 8, 16.
5. K3 (row quantize) and K4 (LayerNorm + quantize) against their plain
   versions at the W8A8 image tower's shapes (rows B x 257 for B = 1, 32,
   64; D 1024 and 4096), bf16 and fp32, and at the W8A8 Moondream
   prefill's (rows B x 760 for B = 1 and 16; K3 at D 2048 and 8192, K4 at
   D 2048), bf16, each with a zero row.
5b. K5 (int4 tile max, on the tensor cores) and K6 (tile max over a
   transposed corpus) against their plain versions at their scripts'
   shapes: 8 queries over 2^20 rows of 512 int4 codes, timed at tiles 512,
   1024 and 2048; 8 queries over a (640, 2^20) and a (528, 2^20) bf16
   corpus.
6. The first slice end to end: the port's app at longclip-l14-248 (random
   weights from a seed) served over HTTP by the port's server, holding a
   2^20-row store that reaches it through the restart path (saved by a
   store that keeps no journal, then loaded by the app's state): a first
   search that builds the device index, 16 uploads that patch it, a
   duplicate, and text, image and multimodal searches, with the K1 and K2
   launch counts read around them. Then, on the store that wrote the
   snapshot: the first query after an add, patched and rebuilt
   (IMATCH_INCREMENTAL=0), with an add from a second thread during the
   rebuild; 64 deletes and 64 updates, patched, whose K1 tile maxima must
   equal a fresh build's bit for bit; two restarts of the app's state (a
   journal replay, a fresh snapshot), each answering as before; and PUT
   /api/metadata and POST /api/reset, each persisting across a restart.
6b. The eighth slice, the rest of the serving surface, on the same app,
   store and embedder, between the searches and the rebuild of phase 6 (the
   store is filled so that its adds end it at 2^20 rows): the app's warmup
   and ``warm`` at every Q bucket, after which the first request builds and
   loads no kernel; /api/search/batch with 16 texts (ids equal to an fp32
   brute force, the store's 16-row query equal to 16 single queries in ids
   and scores) beside the 16 single searches, and with 256 texts at limit 0
   (k 1000); /api/search/image-batch with 24 frames of four sizes in three
   or more pixel-budget chunks (brute-force ids, cosine >= 0.9999 to the
   unchunked embeddings); 32 concurrent pre-embedded queries, direct and
   coalesced (equal results, fewer engine calls); a folder of 64 with
   IMATCH_DEVICE_INGEST=1 (one patch, no rebuild, 64 journal entries, the
   host mirror equal to the card's rows bit for bit, the patched index
   equal to a fresh build) beside a host-path folder of 64; /search in its
   three modes; /upload-samples; /api/metrics with the index, embed and
   ingest timers. K1 (Q = 1 and the tensor-core kernel) and K2 launches
   are held to the engine and tower calls that module hooks count. The
   device-resident folder is repeated on the int8 tier in phase 8.
7. The second slice end to end: the app at longclip-l14-248 with the W8A8
   image tower (IMATCH_EMBED_QUANT=int8) ingesting a folder through
   /api/upload-folder (a fused chunk of 42 frames padded to 64, a host
   tail of 5, duplicates, an empty and an undecodable file), then an image
   and a text search, with the K1-K4 launch counts read around them, and
   the fused chunk's stages timed (W8A8 beside the bf16 tower at B = 64).
8. The third slice end to end: the app at longclip-l14-248 over a store of
   2^20 rows, once with IMATCH_SCORE_DTYPE=int8 and once with
   IMATCH_INDEX_ENGINE=tilemax-host; uploads that patch the built index,
   then text, image and multimodal searches over HTTP whose ids must equal
   a full fp32 brute force and the bf16 engine on the same rows, with the
   K1 and K1-int8 launch counts read around them; 64 deletes and 64
   updates (patched, or on the host tier one rebuild for the updates)
   checked as in phase 6 with K1-int8; then an IMATCH_INDEX_ENGINE=auto
   store whose device budget makes its build escalate to tilemax-host.
8b. The fourth slice end to end: the Moondream captioner and the yes/no
   filters at moondream2 (full width and depth, seeded random weights,
   bf16; IMATCH_CAPTIONER=moondream, a synthetic GPT-2-layout vocab of
   51200 ids) with slice 1's embedder: the vision tower with K2 against
   the same seed's fp32 weights with the plain attention (per-row
   cosine), cache-free against cached prefill logits, segmented against
   monolithic decode, each stage timed; then over HTTP 4 uploads with
   captions and cached encodings, a filter back-filled to progress 100,
   searches with filters= that return exactly the Yes images, an upload
   and a folder of 20 after it (their answers at ingest), DELETE, reset
   and a restart that keeps the saved filters, with K2's launches held to
   27 a Moondream encode plus CLIP's tower calls (counted by hooks); then
   8 text searches while a filter back-fills 100 images, against the same
   searches idle (the priority gate's reading), and /search with
   enhance_with_caption, whose results are /api/search/multimodal's on
   the query extended by the image's caption. The CLIP slices before it
   run with IMATCH_CAPTIONER=null.
8c. The ninth slice's background removal: U2-Net at u2net (full width,
   seeded random weights, bf16): one frame's alpha from the fp32 module on
   the card against the CPU's (within 1 level) and from the bf16 module
   against the fp32 one (``U2_BF16_ALPHA_BOUND``); predict_mask and an
   8-frame remove_background_batch chunk timed; then over HTTP with
   IMATCH_SEGMENTER=u2net and slice 1's embedder: /api/upload and
   /api/upload-folder (20 frames in two geometries) with remove_bg (RGBA
   files, one forward a geometry chunk, host pHash ids), and
   /api/search/image, /api/search/multimodal and /api/search/image-batch
   with remove_bg, equal to the same searches on the cutouts' RGB; every
   cutout must succeed, and the K1 and K2 launches are held to the engine
   and tower calls that hooks count.
8d. The int8 Moondream modes at moondream2 (full width and depth, phase
   8b's seeded weights), each built from its environment beside a bf16
   service: IMATCH_MD_QUANT=int8 (prefill logits cosine against bf16),
   + IMATCH_MD_CACHE=int8 (the first decode step against the bf16 cache,
   segmented decode equal to one loop), + IMATCH_MD_ACT=int8 (the W8A8
   prefill against weight-only int8, cache-free equal to cache-building, a
   64-image yes/no chunk's answers beside weight-only int8's), captions and
   yes/no answers served in each mode, the prefill at B = 1 and 16, a
   decode step and the yes/no chunk timed in each mode and in bf16; the
   W8A8 service's caption and yes/no chunk hold K4 to one launch and K3 to
   two a layer a prefill.
8e. The tenth slice, the IVF tier and the sharded engines, on 2^20 rows
   of clustered unit vectors at LongCLIP's width (4096 centres plus noise,
   tombstones, duplicate rows); it runs after 8c, on slice 1's embedder.
   (a) ``build_ivf`` timed whole and by stage (train, assign, pack; C by
   the default rule); at n_probe = C the ids equal a full fp32 brute force
   under phase 4's near-tie rule; at n_probe 8 recall@10 over 64 queries
   is at least 0.95 and each row's self-match comes first; host and device
   busy ms at Q = 1 and 16 for n_probe 8 and 64 beside the exact bf16
   engine. (b) An IMATCH_INDEX_ENGINE=ivf store: 16 single adds patched
   without a k-means run (the port's ``train_centroids`` counted), the
   patched member lists equal to a repack's, 64 deletes, growth past a
   lowered IMATCH_IVF_REBUILD_FRAC retraining exactly once, ``save`` with
   its ``ivf-<gen>.npz`` sidecar and a ``load`` answering the same without
   a k-means run. (c) Slice 1's app on that store over HTTP: uploads, an
   image search whose first result is the upload, a text search; K2 held
   to the tower calls that hooks count, K1 to none. (d) ``sharded`` at P =
   1 and at 4 logical shards on the card, bf16 and fp32, at Q = 1 and 16:
   ids and distances bit for bit the ``tilemax`` engine's, K1 launched P
   times an engine call; patched adds, deletes and updates equal to a
   fresh build; ``ivf-sharded`` at a full probe bit for bit ``sharded``,
   across a sidecar restart at 4 shards. Where more than one card is
   visible the sharded checks run over every card; otherwise a line says
   that no multi-card run took place.
9. A cut-depth vit-b32 tower on the card against the same weights on the
   CPU, and the W8A8 longclip tower against the fp32 tower on the card.
10. The two experiment entry points, python -m imatch_tpu_torch.scripts.
   exp_int4_kernel (K5) and exp_pallas_search (K6 beside K1), run to the
   end with the K5, K6 and tensor-core K1 launch counts read around them
   (exp_pallas_search's row-major phase runs K1 bf16 at Q = 8).
11. Every kernel's device time from torch.profiler traces (``device_ms``
   and ``device_pct_of_bound``): K2 and SDPA at each phase-3 case
   (``library_device_ms``), and every other kernels-line entry at its own
   shape (K1 Q = 1 and 16, K1 int8, K3 and K4 at 16448 bf16 rows and at
   the Moondream prefill's 760 and 12160, K5 at each tile, K6). Events of back-to-back calls time the host where it
   launches more slowly than the card runs (K2 at B = 1). Late, because a
   profiler session slows the host's later launches. A reading the traces
   lost (a long process's late traces drop events) is null: not measured.
12. POST /api/profile/start and /stop on a small app (vit-b32): 409s on
   misuse, and a trace file that holds K1's and K2's kernels. It runs in a
   process of its own (``chip_smoke.py --phase profile``), whose first
   trace is whole, on the kernels phase 2 built.

The device breakdowns attribute profiler events to K1-K6 by kernel
symbol (``kernel_key`` in imatch_tpu_torch/scripts/kernel_ab.py):
flash_fwd_kernel and flash_fwd_mma_kernel are K2, tile_max_kernel and
tile_max_mma_kernel are K1, int4_tile_max_mma_kernel is K5.

The apps run with IMATCH_WARMUP=0: phase 6b runs the warmup itself,
timed, and a background warmup would launch kernels inside the other
phases' counted windows.

The last four lines are the two scripts' JSON lines, {"kernels": [...]}
with each kernel's measured and bound times, and the device JSON. It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# dense bf16 tensor-core, fp32 CUDA-core and dense int8 tensor-core rates
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

# bf16 tolerance: 2 bf16 ulps at magnitude 1 (2 * 2^-7) absolute, plus half
# an ulp relative for outputs above 1, against fp32 math on the same inputs.
BF16_ATOL = 2 * 2.0**-7
BF16_RTOL = 2.0**-8
FP32_TOL = 2e-5  # tests/test_pallas.py's bar for the Pallas kernel


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    from imatch_tpu_torch.scripts._common import cuda_ms

    return cuda_ms(fn, iters, warmup)


def device_ms(fn, key=None, iters: int = 20):
    """Device time of one call from a torch.profiler trace (kernel_ab.py's
    ``trace``): the mean launch of its one kernel named ``key``
    (kernel_ab.py's ``kernel_key``), or all of its kernels. CUDA events around
    back-to-back calls (``time_ms``) time the host instead where the host
    takes longer to launch a call than the card to run it.

    None, logged, where the traces lost the call: no launch of ``key`` in
    any of them, or (``key`` None) no event after the marker. A long
    process's late traces drop events (kernel_ab.py's ``trace``); a reading
    from what is left of the window would understate the call."""
    from imatch_tpu_torch.scripts.kernel_ab import trace

    t = trace(fn, iters, key)
    if key is not None and key in t["mean_ms"]:
        return t["mean_ms"][key]
    if key is None and t["guarded"]:
        return t["busy_ms"]
    lost = {k: t[k] for k in ("events", "markers", "ops", "guarded")}
    log(f"device time not measured: the traces lost {key or 'the call'}'s kernels " + json.dumps(lost))
    return None


def bound_ms(n_bytes: float, n_ops: float, dtype_name: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 1 -----------------------------------------------------------------


def phase_identify() -> None:
    import torch

    from imatch_tpu_torch.scripts._common import card

    log(card(torch.device("cuda")))  # nvidia-smi's name and power limit
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}"
    )
    try:
        import PIL

        log(f"PIL {PIL.__version__} installed")
    except ImportError:
        log("PIL not installed")


# -- phase 2 -----------------------------------------------------------------


def phase_build() -> None:
    from imatch_tpu_torch.ops.kernels import _build

    version = subprocess.run(
        [_build._nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    log(f"nvcc: {version}")
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(reports) or 'nothing (cached)'}")
    for name, text in reports.items():
        used = [ln.strip() for ln in text.splitlines() if "Used" in ln]
        log(f"ptxas {name}: {len(used)} kernels; first: {used[0] if used else '-'}")
        with open(_build.BUILD_DIR / f"ptxas_{name}.txt", "w") as f:
            f.write(text)  # registers and shared memory of every kernel


# -- phase 3 -----------------------------------------------------------------


def _k2_bound(b, h, s, dh, causal, kv_len, dtype_name):
    itemsize = 2 if dtype_name == "bfloat16" else 4
    pairs = sum(min(i + 1, kv_len) for i in range(s)) if causal else s * kv_len
    return bound_ms(4 * b * h * s * dh * itemsize, 4 * b * h * dh * pairs, dtype_name)


def _k2_inputs(shape, dtype, seed=0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3)]


def k2_case(shape, causal, dtype, kv_len=None) -> dict:
    import torch
    import torch.nn.functional as F

    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha, flash_mha_plain

    b, h, s, dh = shape
    kv_len = s if kv_len is None else kv_len
    q, k, v = _k2_inputs(shape, dtype)
    out = flash_mha(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    ref = flash_mha_plain(q.float(), k.float(), v.float(), causal=causal, kv_len=kv_len)
    err = (out.float() - ref).abs()
    if dtype == torch.bfloat16:
        ok = bool((err <= BF16_ATOL + BF16_RTOL * ref.abs()).all())
    else:
        ok = bool((err <= FP32_TOL + FP32_TOL * ref.abs()).all())
    if not bool(torch.isfinite(out.float()).all()):
        ok = False
    if kv_len == 0 and bool(out.float().abs().max() != 0):
        ok = False
    kernel_ms = time_ms(lambda: flash_mha(q, k, v, causal=causal, kv_len=kv_len))
    plain_ms = time_ms(lambda: flash_mha_plain(q, k, v, causal=causal, kv_len=kv_len))
    if kv_len == s:
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        )
    else:
        library_ms = None  # SDPA rejects a mask whose rows are all False
    dname = str(dtype).replace("torch.", "")
    bms, bound_by = _k2_bound(b, h, s, dh, causal, kv_len, dname)
    row = {
        "shape": list(shape),
        "causal": causal,
        "kv_len": kv_len,
        "dtype": dname,
        "max_abs_err": float(err.max()),
        "ok": ok,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bms,
        "bound_by": bound_by,
    }
    log("K2 " + json.dumps(row))
    return row


def phase_k2() -> list:
    import torch

    cases = [
        ((32, 16, 257, 64), False, None),  # ViT-L/14 image tower, 32 images
        ((32, 12, 248, 64), True, None),  # LongCLIP text tower, 32 texts
        ((32, 12, 50, 64), False, None),  # ViT-B/32 image tower
        ((32, 8, 77, 64), True, None),  # ViT-B/32 text tower
        ((4, 4, 77, 64), False, 0),  # every key masked: rows write 0
        ((4, 4, 130, 64), False, 70),  # keys past kv_len masked
        ((1, 16, 257, 64), False, None),  # one upload's image tower call
        ((1, 12, 248, 64), True, None),  # one text query's tower call
        ((64, 16, 257, 64), False, None),  # the bulk-ingest chunk's image tower
        ((1, 16, 729, 72), False, None),  # the Moondream vision tower, one upload
        ((16, 16, 729, 72), False, None),  # the Moondream vision tower, a folder's chunk
    ]
    rows = []
    for shape, causal, kv_len in cases:
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(k2_case(shape, causal, dtype, kv_len))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"K2 disagrees with its plain version in {len(bad)} cases")
    return rows


def phase_device(k2_rows, traced_rows) -> None:
    """Phase 11: each kernel's device time (``device_ms``, its own kernel
    intervals a call in a torch.profiler trace) and its share of its bound
    (``device_pct_of_bound``): K2 and SDPA at each phase-3 case, and every
    other kernels-line case at its own shape (the rows that kept a
    ``_trace`` call). It runs last: after a profiler session the host
    launches more slowly on the card's machine (CUDA events read K2 at
    B = 1 about twice as slow), so every CUDA-event time is taken before
    it. A reading the traces lost is None (``device_ms``)."""
    import torch
    import torch.nn.functional as F

    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha

    def timed(row, fn, key):
        row["device_ms"] = device_ms(fn, key)
        row["device_pct_of_bound"] = (
            None if row["device_ms"] is None else 100 * row["bound_ms"] / row["device_ms"]
        )

    for row in k2_rows:
        q, k, v = _k2_inputs(tuple(row["shape"]), getattr(torch, row["dtype"]))
        causal, kv_len = row["causal"], row["kv_len"]
        timed(row, lambda: flash_mha(q, k, v, causal=causal, kv_len=kv_len), "K2")
        row["library_device_ms"] = (
            device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
            if row["library_ms"] is not None
            else None
        )
        keys = ("shape", "causal", "kv_len", "dtype", "kernel_ms", "device_ms", "library_ms",
                "library_device_ms", "bound_ms", "device_pct_of_bound")
        log("K2 device " + json.dumps({k: row[k] for k in keys}))
    for row in traced_rows:
        fn, key = row.pop("_trace")
        timed(row, fn, key)
        shape = {k: row[k] for k in ("kernel", "rows", "n", "d", "dp", "q", "tile_n", "dtype") if k in row}
        keys = ("kernel_ms", "device_ms", "bound_ms", "device_pct_of_bound")
        log(f"{key} device " + json.dumps({**shape, **{k: row[k] for k in keys}}))


# -- phase 4 -----------------------------------------------------------------


def _k1_bound(q, n, dp, dtype_name, tile_n):
    itemsize = 2 if dtype_name == "bfloat16" else 4
    n_bytes = n * dp * itemsize + n + q * dp * itemsize + q * (n // tile_n) * 4
    return bound_ms(n_bytes, 2 * q * n * dp, dtype_name)


def make_corpus(n: int, d: int, seed: int = 0):
    """Unit rows from a seed, rows [n-64, n) duplicating rows [0, 64),
    about 1% tombstones."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    corpus = torch.randn((n, d), generator=g, device="cuda")
    corpus /= corpus.norm(dim=1, keepdim=True)
    corpus[n - 64 :] = corpus[:64]
    valid = torch.rand((n,), generator=g, device="cuda") >= 0.01
    return corpus, valid


def brute_force_topk(queries, corpus, valid, k):
    """Full fp32 scores, ties to the lower index."""
    import torch

    from imatch_tpu_torch.ops.kernels.topk import NEG_INF

    s = torch.where(valid[None, :], queries @ corpus.T, NEG_INF)
    s, i = torch.sort(s, dim=1, descending=True, stable=True)
    return s[:, :k], i[:, :k]


def k1_case(corpus, valid, nq, dtype, tile_n, k=10, trace=False) -> dict:
    import torch

    from imatch_tpu_torch.index.search import prepare_device_corpus, tilemax_topk
    from imatch_tpu_torch.ops.kernels.topk import NEG_INF, tile_max, tile_max_plain

    n, d = corpus.shape
    dc = prepare_device_corpus(corpus, valid, tile_n=tile_n, score_dtype=dtype, device="cuda")
    queries = corpus[:nq].clone()
    qs = queries.to(dtype)
    tm = tile_max(qs, dc.scoring, dc.valid, tile_n)
    torch.cuda.synchronize()
    tm_ref = tile_max_plain(qs, dc.scoring, dc.valid, tile_n)
    err = float((tm - tm_ref).abs().max())
    s, i = tilemax_topk(queries, dc, k=k)
    bs, bi = brute_force_topk(queries, corpus, valid, k)
    ids_equal = bool(torch.equal(i, bi))
    score_err = float((s - bs).abs().max())
    # The engine's rescore and the full product sum in different orders,
    # up to about 1e-6 apart: over 256 rows x 10 ranks a few fp32
    # near-ties swap. Past 16 queries, ids must equal brute force up to
    # such ties: each returned id a valid row, once a row, whose full
    # product is within the score tolerance of brute force's at its rank.
    full = torch.where(valid[None, :], queries @ corpus.T, NEG_INF).gather(1, i)
    distinct = bool((torch.sort(i, dim=1).values.diff(dim=1) != 0).all())
    ids_tie_equal = bool(valid[i].all()) and distinct and float((full - bs).abs().max()) <= 1e-5
    del full
    kernel_ms = time_ms(lambda: tile_max(qs, dc.scoring, dc.valid, tile_n))
    plain_ms = time_ms(lambda: tile_max_plain(qs, dc.scoring, dc.valid, tile_n), iters=5)

    def library():
        sc = torch.matmul(qs, dc.scoring.T)
        return torch.where(dc.valid[None, :], sc, -3.0e38).view(nq, -1, tile_n).amax(2)

    library_ms = time_ms(library, iters=5)
    engine_ms = time_ms(lambda: tilemax_topk(queries, dc, k=k), iters=5)
    dname = str(dtype).replace("torch.", "")
    bms, bound_by = _k1_bound(nq, n, dc.scoring.shape[1], dname, tile_n)
    row = {
        "n": n,
        "d": d,
        "q": nq,
        "k": k,
        "tile_n": tile_n,
        "dtype": dname,
        "max_abs_err": err,
        "ids_equal_brute_force": ids_equal,
        "ids_equal_brute_force_up_to_ties": ids_tie_equal,
        "max_score_err": score_err,
        "ok": err <= 1e-5 and (ids_equal if nq <= 16 else ids_tie_equal) and score_err <= 1e-5,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "engine_ms": engine_ms,
        "bound_ms": bms,
        "bound_by": bound_by,
    }
    log("K1 " + json.dumps(row))
    if trace:  # a kernels-line entry: the last phase takes its device time
        row["_trace"] = (lambda: tile_max(qs, dc.scoring, dc.valid, tile_n), "K1")
    return row


def phase_k1() -> list:
    import torch

    corpus, valid = make_corpus(1 << 20, 768)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for nq in (1, 16):
            for tile_n in (512, 2048):  # the tilemax and pallas engines
                trace = dtype == torch.bfloat16 and tile_n == 512
                rows.append(k1_case(corpus, valid, nq, dtype, tile_n, trace=trace))
    # the tensor-core kernel's later 16-query blocks (grid.y = ceil(Q/16)):
    # a partial second block, and the batch route's 256 queries
    for nq in (17, N_BIG_BATCH):
        for tile_n in (512, 2048):
            rows.append(k1_case(corpus, valid, nq, torch.bfloat16, tile_n))
    del corpus, valid
    torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"K1 or its engine disagrees in {len(bad)} cases")
    return rows


# -- phase 5 -----------------------------------------------------------------

# fp32 operations an element: K3 abs, max, multiply, round; K4 adds the
# two sums, the centring, the square, the scale by rstd, gamma and beta.
_QUANT_OPS = {"K3": 4, "K4": 11}


def _k34_bound(kernel, rows, d, itemsize):
    n_bytes = rows * d * (itemsize + 1) + 4 * rows + (8 * d if kernel == "K4" else 0)
    return bound_ms(n_bytes, _QUANT_OPS[kernel] * rows * d, "float32")


def k34_case(kernel, rows, d, dtype, seed=0) -> dict:
    """One K3 or K4 case against its plain version on the same inputs:
    codes within 1 LSB with under 1e-3 (K3) or 2e-3 (K4) of them
    differing, scales within rtol 1e-6 (tests/test_quant_kernel.py)."""
    import torch

    from imatch_tpu_torch.ops.kernels.quantize import (
        ln_quant_rows,
        ln_quant_rows_plain,
        quant_rows,
        quant_rows_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((rows, d), generator=g, device="cuda") * 3).to(dtype)
    x[rows // 2] = 0  # a zero row
    gamma = torch.randn(d, generator=g, device="cuda") * 0.5 + 1
    beta = torch.randn(d, generator=g, device="cuda") * 0.1
    if kernel == "K3":
        run, plain, frac_bar = (lambda: quant_rows(x)), (lambda: quant_rows_plain(x)), 1e-3
    else:
        run = lambda: ln_quant_rows(x, gamma, beta, 1e-5)  # noqa: E731
        plain = lambda: ln_quant_rows_plain(x, gamma, beta, 1e-5)  # noqa: E731
        frac_bar = 2e-3
    q, s = run()
    torch.cuda.synchronize()
    qr, sr = plain()
    diff = (q.int() - qr.int()).abs()
    max_code = int(diff.max())
    frac = float((diff != 0).float().mean())
    scale_rel = float(((s - sr).abs() / sr.abs()).max())
    ok = max_code <= 1 and frac < frac_bar and scale_rel <= 1e-6
    if kernel == "K3":  # a zero row: scale 1, codes 0 (K4 normalises it to beta)
        ok = ok and float(s[rows // 2]) == 1.0 and not bool(q[rows // 2].any())
    dname = str(dtype).replace("torch.", "")
    bms, bound_by = _k34_bound(kernel, rows, d, x.element_size())
    row = {
        "kernel": kernel,
        "rows": rows,
        "d": d,
        "dtype": dname,
        "max_abs_err": max_code,
        "codes_differing": frac,
        "scale_max_rel_err": scale_rel,
        "ok": ok,
        "kernel_ms": time_ms(run),
        "plain_ms": time_ms(plain),
        "library_ms": None,  # no single PyTorch call quantizes per row
        "bound_ms": bms,
        "bound_by": bound_by,
    }
    log(f"{kernel} " + json.dumps(row))
    if rows in (64 * 257, *MD_PREFILL_ROWS) and dtype == torch.bfloat16:
        row["_trace"] = (run, kernel)
    return row


# the Moondream W8A8 prefill's rows, B x (1 + 729 + prompt), at B = 1 and 16
MD_PREFILL_ROWS = (760, 16 * 760)


def phase_k34() -> list:
    """K3 at D 1024 (attention output) and 4096 (MLP activation), K4 at
    D 1024 (ln1, ln2), at B x 257 rows for one upload (B = 1), a tower
    call of 32 and the bulk-ingest chunk of 64; then the Moondream W8A8
    prefill's, bf16 at B = 1 and 16: K3 at D 2048 (the attention output)
    and 8192 (gelu(fc1)), K4 at D 2048 (the residual stream)."""
    import torch

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for r in (257, 32 * 257, 64 * 257):
            for kernel, d in (("K3", 1024), ("K3", 4096), ("K4", 1024)):
                rows.append(k34_case(kernel, r, d, dtype, seed=r + d))
    for r in MD_PREFILL_ROWS:
        for kernel, d in (("K3", 2048), ("K3", 8192), ("K4", 2048)):
            rows.append(k34_case(kernel, r, d, torch.bfloat16, seed=r + d + 1))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"K3/K4 disagree with their plain versions in {len(bad)} cases")
    return rows


# -- phase 4, int8 --------------------------------------------------------------


def _k1_int8_bound(q, n, dp, tile_n):
    n_bytes = n * dp + 4 * n + n + q * dp + 4 * q + q * (n // tile_n) * 4
    return bound_ms(n_bytes, 2 * q * n * dp, "int8")


def k1_int8_case(dc, corpus, valid, nq, k=10) -> dict:
    """K1's int8 variant against its plain version (bit for bit), and the
    int8 engine against the fp32 brute force, at Q = nq."""
    import torch

    from imatch_tpu_torch.index.search import _int8_queries, tilemax_topk
    from imatch_tpu_torch.ops.kernels.topk import NEG_INF, tile_max_int8, tile_max_int8_plain

    n, d = corpus.shape
    tile_n = dc.tile_n
    queries = corpus[:nq].clone()
    qi, qscale = _int8_queries(queries, dc.scoring.shape[1])
    args = (qi, dc.scoring, qscale, dc.scale, dc.valid, tile_n)
    tm = tile_max_int8(*args)
    torch.cuda.synchronize()
    tm_ref = tile_max_int8_plain(*args)
    identical = bool(torch.equal(tm, tm_ref))
    s, i = tilemax_topk(queries, dc, k=k)
    bs, bi = brute_force_topk(queries, corpus, valid, k)
    ids_equal = bool(torch.equal(i, bi))
    score_err = float((s - bs).abs().max())
    qpad = torch.zeros((32, qi.shape[1]), dtype=torch.int8, device=qi.device)
    qpad[:nq] = qi

    def library():
        # torch._int_mm takes a first dimension above 16: 32 padded rows
        acc = torch._int_mm(qpad, dc.scoring.T)[:nq]
        sc = acc.float() * qscale[:, None] * dc.scale[None, :]
        return torch.where(dc.valid[None, :], sc, NEG_INF).view(nq, -1, tile_n).amax(2)

    try:
        library_ms = time_ms(library, iters=5)
        note = "torch._int_mm (queries padded to 32 rows), then dequantize, mask and amax"
    except RuntimeError as e:
        library_ms, note = None, f"torch._int_mm refused: {e}"[:200]
    bms, bound_by = _k1_int8_bound(nq, n, dc.scoring.shape[1], tile_n)
    row = {
        "n": n,
        "d": d,
        "q": nq,
        "k": k,
        "tile_n": tile_n,
        "dtype": "int8",
        "bit_identical": identical,
        "max_abs_err": float((tm - tm_ref).abs().max()),
        "ids_equal_brute_force": ids_equal,
        "max_score_err": score_err,
        "ok": identical and ids_equal and score_err <= 1e-5,
        "kernel_ms": time_ms(lambda: tile_max_int8(*args)),
        "plain_ms": time_ms(lambda: tile_max_int8_plain(*args), iters=5),
        "library_ms": library_ms,
        "library_note": note,
        "engine_ms": time_ms(lambda: tilemax_topk(queries, dc, k=k), iters=5),
        "bound_ms": bms,
        "bound_by": bound_by,
    }
    log("K1 int8 " + json.dumps(row))
    if nq == 1:
        row["_trace"] = (lambda: tile_max_int8(*args), "K1_int8")
    return row


def phase_k1_int8() -> list:
    """The int8 tier's phase 1 at the store's shapes: 2^20 x 768, tile 512,
    margin 16, for one query, a batch of 8 and a chunk of 16."""
    import torch

    from imatch_tpu_torch.index.search import prepare_device_corpus

    corpus, valid = make_corpus(1 << 20, 768)
    dc = prepare_device_corpus(
        corpus, valid, tile_n=512, score_dtype=torch.int8, margin=16, device="cuda"
    )
    rows = [k1_int8_case(dc, corpus, valid, nq) for nq in (1, 8, 16)]
    del corpus, valid, dc
    torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"K1's int8 variant or the int8 engine disagrees in {len(bad)} cases")
    return rows


# -- phase 5b ----------------------------------------------------------------


def phase_k5() -> list:
    """K5 at scripts/exp_int4_kernel.py's shapes: 8 bf16 queries of 512 over
    2^20 rows packed (N, 256), a tombstone every 97th row, tile_n 512, 1024
    and 2048; atol 1e-5 against the plain version (exact products, fp32
    sums in another order). Timed at every tile; tile 2048 is the kernels
    line's shape."""
    import torch

    from imatch_tpu_torch.ops.kernels.int4_topk import int4_tile_max, int4_tile_max_plain, pack_int4

    n, d, q = 1 << 20, 512, 8
    corpus, _ = make_corpus(n, d, seed=5)
    valid = torch.arange(n, device="cuda") % 97 != 0
    packed, side, _, _ = pack_int4(corpus, valid)
    del corpus
    g = torch.Generator(device="cuda").manual_seed(6)
    qbf = torch.randn((q, d), generator=g, device="cuda")
    qbf = (qbf / qbf.norm(dim=1, keepdim=True)).bfloat16()
    rows = []
    for tile_n in (512, 1024, 2048):
        got = int4_tile_max(qbf, packed, side, tile_n)
        torch.cuda.synchronize()
        err = float((got - int4_tile_max_plain(qbf, packed, side, tile_n)).abs().max())
        # the bytes the function reads: the codes and side rows 0 (scale)
        # and 1 (validity); rows 2-7 of the side array are padding neither
        # the kernel nor the plain version touches
        n_bytes = n * (d // 2) + 2 * n * 2 + q * d * 2 + q * (n // tile_n) * 4
        bms, bound_by = bound_ms(n_bytes, 2 * q * n * d, "bfloat16")
        call = lambda tile_n=tile_n: int4_tile_max(qbf, packed, side, tile_n)  # noqa: E731
        row = {
            "n": n,
            "d": d,
            "q": q,
            "tile_n": tile_n,
            "max_abs_err": err,
            "ok": err <= 1e-5 and bool(torch.isfinite(got).all()),
            "kernel_ms": time_ms(call),
            "plain_ms": time_ms(lambda: int4_tile_max_plain(qbf, packed, side, tile_n), iters=3),
            "library_ms": None,
            "library_note": "no PyTorch call multiplies int4 codes (torch has no int4 matmul)",
            "bound_ms": bms,
            "bound_by": bound_by,
        }
        log("K5 " + json.dumps(row))
        row["_trace"] = (call, "K5")
        rows.append(row)
    if not all(r["ok"] for r in rows):
        raise AssertionError("K5 disagrees with its plain version")
    return rows


def phase_k6() -> list:
    """K6 at scripts/exp_pallas_search.py's shapes: 8 bf16 queries over the
    transposed 2^20-row corpus with the penalty feature, padded to 640
    (tile_n 1024, 2048, 4096) and 528 (2048, 4096); atol 1e-5 against the
    plain version (fp32 sums of exact products in another order). Timed at
    640, tile 2048 only, the kernels line's shape: the script times the
    others in phase 10."""
    import torch

    from imatch_tpu_torch.ops.kernels.topk_t import tile_max_t, tile_max_t_plain
    from imatch_tpu_torch.scripts.exp_pallas_search import make_data

    n, q = 1 << 20, 8
    rows = []
    for dp, tiles in ((640, (1024, 2048, 4096)), (528, (2048, 4096))):
        scoring, qs = make_data(n, dp, "cuda")
        st = scoring.T.contiguous()
        del scoring
        for tile_n in tiles:
            got = tile_max_t(qs, st, tile_n)
            torch.cuda.synchronize()
            err = float((got - tile_max_t_plain(qs, st, tile_n)).abs().max())
            row = {"n": n, "dp": dp, "q": q, "tile_n": tile_n, "max_abs_err": err, "ok": err <= 1e-5}
            if (dp, tile_n) == (640, 2048):
                n_bytes = dp * n * 2 + q * dp * 2 + q * (n // tile_n) * 4
                bms, bound_by = bound_ms(n_bytes, 2 * q * n * dp, "bfloat16")
                row.update(
                    kernel_ms=time_ms(lambda: tile_max_t(qs, st, tile_n)),
                    plain_ms=time_ms(lambda: tile_max_t_plain(qs, st, tile_n), iters=5),
                    library_ms=time_ms(
                        lambda: torch.matmul(qs, st).view(q, n // tile_n, tile_n).amax(2), iters=5
                    ),
                    library_note="torch.matmul (bf16 out) + amax on the transposed corpus",
                    bound_ms=bms,
                    bound_by=bound_by,
                )
            log("K6 " + json.dumps(row))
            if "bound_ms" in row:
                row["_trace"] = (lambda qs=qs, st=st, t=tile_n: tile_max_t(qs, st, t), "K6")
            rows.append(row)
        del st
        torch.cuda.empty_cache()
    if not all(r["ok"] for r in rows):
        raise AssertionError("K6 disagrees with its plain version")
    return rows


# -- phase 6 -----------------------------------------------------------------

SLICE_CONFIG = "longclip-l14-248"
N_UPLOADS = 16
STORE_ROWS = 1 << 20  # rows in the store once slice 1's and phase 6b's uploads are in
TEXT_QUERY = "a red drill on a wooden table"
MULTIMODAL_QUERY = "blue sky over the sea"
BUILD_QUERY = "shelves in a storage room"
WARM_QUERY = "a bicycle leaning on a wall"


def synthetic_png(seed: int, h: int = 240, w: int = 320) -> bytes:
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = rng.uniform(3.0, 15.0, 3)
    img = np.stack(
        [
            np.sin(xx / f[0] + seed) * 120 + 128,
            np.cos(yy / f[1] - seed) * 120 + 128,
            ((xx * (seed + 1) + yy * f[2]) % 256),
        ],
        -1,
    )
    img = np.clip(img + rng.integers(-25, 26, img.shape), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


class HttpClient:
    """Multipart POSTs and GETs over urllib, with no proxy."""

    def __init__(self, port: int):
        import urllib.request

        self.base = f"http://127.0.0.1:{port}"
        self.opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def request(self, method, path, fields=(), files=()):
        import urllib.request

        boundary = "chipsmoke7d2f9a"
        parts = []
        for name, value in fields:
            parts.append(
                f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"'
                f"\r\n\r\n{value}\r\n".encode()
            )
        for name, filename, content in files:
            parts.append(
                f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; '
                f'filename="{filename}"\r\nContent-Type: image/png\r\n\r\n'.encode()
                + content
                + b"\r\n"
            )
        data = None
        headers = {}
        if method in ("POST", "PUT"):
            data = b"".join(parts) + f"--{boundary}--\r\n".encode()
            headers["Content-Type"] = f"multipart/form-data; boundary={boundary}"
        return self._send(urllib.request.Request(self.base + path, data=data, headers=headers, method=method))

    def request_json(self, path, payload):
        """POST a JSON body."""
        import urllib.request

        headers = {"Content-Type": "application/json"}
        return self._send(
            urllib.request.Request(self.base + path, data=json.dumps(payload).encode(), headers=headers, method="POST")
        )

    def _send(self, req):
        import urllib.error

        t0 = time.perf_counter()
        try:
            with self.opener.open(req, timeout=600) as resp:
                status, body = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            status, body = e.code, e.read()
        ms = (time.perf_counter() - t0) * 1e3
        return status, json.loads(body), ms


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ServerThread:
    """The port's asyncio server on its own loop in a thread, for a
    ``with`` block: leaving it cancels the server and joins the thread."""

    def __init__(self, app, port: int):
        import asyncio

        from imatch_tpu_torch.serving.server import serve_async

        self.loop = asyncio.new_event_loop()
        self.ready = threading.Event()
        self.task = self.loop.create_task(serve_async(app, "127.0.0.1", port, self.ready))
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        import asyncio

        asyncio.set_event_loop(self.loop)
        try:
            self.loop.run_until_complete(self.task)
        except asyncio.CancelledError:
            pass

    def __enter__(self):
        self.thread.start()
        if not self.ready.wait(60):
            raise RuntimeError("server did not start")
        return self

    def __exit__(self, *exc):
        self.loop.call_soon_threadsafe(self.task.cancel)
        self.thread.join(30)
        if not self.thread.is_alive():
            self.loop.close()


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def recorded_queries(store):
    """``store.query`` wrapped for a ``with`` block: the fp32 query vectors
    the app hands the store are appended to the yielded list."""
    import numpy as np
    import torch

    seen = []
    query = store.query

    def recording(query_embeddings, *args, **kw):
        q = query_embeddings
        seen.append(q.float() if isinstance(q, torch.Tensor) else torch.as_tensor(np.asarray(q, np.float32)))
        return query(query_embeddings, *args, **kw)

    store.query = recording
    try:
        yield seen
    finally:
        del store.query  # the class's method again


def k1_calls(state, q32):
    """Zero-argument calls of K1 (K1-int8 for int8 codes) and of its plain
    version, on fp32 queries against a store's prepared state."""
    import torch

    from imatch_tpu_torch.index.search import _int8_queries
    from imatch_tpu_torch.ops.kernels.topk import tile_max, tile_max_int8, tile_max_int8_plain, tile_max_plain

    q32 = q32.to(device=state.scoring.device, dtype=torch.float32)
    if state.scoring.dtype == torch.int8:
        qi, qscale = _int8_queries(q32, state.scoring.shape[1])
        args = (qi, state.scoring, qscale, state.scale, state.valid, state.tile_n)
        return (lambda: tile_max_int8(*args)), (lambda: tile_max_int8_plain(*args))
    qs = torch.zeros((q32.shape[0], state.scoring.shape[1]), dtype=state.scoring.dtype, device=q32.device)
    qs[:, : q32.shape[1]] = q32
    args = (qs, state.scoring, state.valid, state.tile_n)
    return (lambda: tile_max(*args)), (lambda: tile_max_plain(*args))


def check_patched(store, queries, device, k=10) -> dict:
    """A patched store against a fresh build of its own host buffers (the
    same slots, so tile for tile): K1's or K1-int8's tile maxima on the
    patched state equal those on the fresh build bit for bit, and the plain
    version's within K1's bar (1e-5; int8: bit for bit); the store's answers
    equal the fp32 brute force over its rows. On the card the kernel is
    timed on both states (CUDA events, patched, fresh, patched)."""
    import torch

    eng, patched = store._device_corpus
    fresh = store._build_device(store._emb.copy(), store._alive.copy())[0][1]
    k1_patched, plain = k1_calls(patched, queries)
    k1_fresh, _ = k1_calls(fresh, queries)
    got, want, ref = k1_patched(), k1_fresh(), plain()
    err = float(torch.where(got == ref, 0.0, (got - ref).abs()).max())
    out = {
        "engine": eng,
        "k1_equals_fresh_build": bool(torch.equal(got, want)),
        "k1_plain_max_abs_err": err,
    }
    if patched.scoring.is_cuda:
        out["k1_ms_patched_fresh_patched"] = [time_ms(f, iters=50) for f in (k1_patched, k1_fresh, k1_patched)]
    del fresh, k1_fresh
    brute, _ = _references(store, queries, device, k)
    out["ids_equal_brute_force"] = store.query(queries, n_results=k)["ids"] == brute
    bar = 0.0 if patched.scoring.dtype == torch.int8 else 1e-5
    out["ok"] = out["k1_equals_fresh_build"] and err <= bar and out["ids_equal_brute_force"]
    return out


def _disk_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _unit_rows(n: int, dim: int, seed: int, device):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, dim), generator=g, device=device)
    return (x / x.norm(dim=1, keepdim=True)).cpu().numpy()


def phase_slice(device="cuda", config=SLICE_CONFIG, store_rows=STORE_ROWS):
    """The app at longclip-l14-248 over HTTP, its store prefilled through
    the restart path (a saved snapshot that the app loads); uploads that
    patch the device index, a rebuild beside them with a writer during it,
    patches at full size against a fresh build, two restarts, and the
    metadata and reset routes. Returns the launch counts of the HTTP
    requests and the embedder. (A small config on the CPU rehearses the
    same control flow.)"""
    import shutil

    import torch

    from imatch_tpu_torch.index.store import VectorStore
    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
    from imatch_tpu_torch.ops.kernels.topk import tile_max
    from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
    from imatch_tpu_torch.pipeline.state import AppState
    from imatch_tpu_torch.serving.app import create_app

    root = os.path.join("build", "chip_smoke_app")
    data_dir = os.path.join(root, "index_data")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    embedder = ClipEmbedder(config, device=device)
    cfg = embedder.cfg
    # A store at a real size: earlier images as random unit rows, so the
    # searches below score 2^20 rows through K1. It reaches the app through
    # the restart path: saved by a store that keeps no journal (a journal
    # of 2^20 fsynced base64 lines would be 4.3 GB), then loaded.
    n_pre = store_rows - N_UPLOADS - SURFACE_ROWS
    seed_store = VectorStore(device=device)
    seed_store.add(
        ids=[f"pre_{i}" for i in range(n_pre)],
        embeddings=_unit_rows(n_pre, cfg.projection_dim, 1, device),
        metadatas=[{"id": f"pre_{i}"} for i in range(n_pre)],
    )
    persist = {}
    t = time.perf_counter()
    seed_store.save(data_dir)
    persist["save_s"] = time.perf_counter() - t
    persist["bytes_on_disk"] = _disk_bytes(data_dir)
    t = time.perf_counter()
    state = AppState(root=root, embedder=embedder, device=device)
    persist["load_s"] = time.perf_counter() - t
    persist["last_load"] = state.store.stats()["last_load"]
    persist["count"] = state.store.count()
    assert persist["count"] == n_pre, persist
    app = create_app(state)
    log(f"slice: {cfg.name} app loaded a {n_pre}-row store in {time.perf_counter() - t0:.1f} s")
    log("slice persistence: " + json.dumps(persist))

    pngs = [synthetic_png(i) for i in range(N_UPLOADS)]
    port = _free_port()
    with ServerThread(app, port), recorded_queries(state.store) as seen:
        http = HttpClient(port)
        _sync(device)
        tile_max.launches = 0
        flash_mha.launches = 0
        times = {}
        ids = []
        # the first search builds the device index over the capacity buffer;
        # its own text, since the embedder caches a text's embedding
        status, body, times["first_search_ms"] = http.request(
            "POST", "/api/search/text", [("query", BUILD_QUERY), ("limit", "5")]
        )
        assert status == 200 and len(body["results"]) == 5, body
        first_build = state.store.stats()["last_build"]
        for i, png in enumerate(pngs):
            status, body, ms = http.request(
                "POST", "/api/upload", [("description", f"synthetic {i}")], [("file", f"s{i}.png", png)]
            )
            assert status == 200 and body["success"], body
            ids.append(body["metadata"]["id"])
            times.setdefault("upload_ms", []).append(ms)
        assert len(set(ids)) == N_UPLOADS, ids
        status, body, times["duplicate_ms"] = http.request(
            "POST", "/api/upload", files=[("file", "again.png", pngs[0])]
        )
        assert status == 409 and body["metadata"]["id"] == ids[0], (status, body)
        # the uploads patched the index: this search reads it as it stands
        status, body, times["first_search_after_upload_ms"] = http.request(
            "POST", "/api/search/text", [("query", TEXT_QUERY), ("limit", "5")]
        )
        assert status == 200 and len(body["results"]) == 5, body
        text_top = [r["id"] for r in body["results"]]
        # a warm search of another new text, to hold the reading above against
        status, body, times["warm_text_search_ms"] = http.request(
            "POST", "/api/search/text", [("query", WARM_QUERY), ("limit", "5")]
        )
        assert status == 200 and len(body["results"]) == 5, body
        status, body, times["image_ms"] = http.request(
            "POST", "/api/search/image", [("limit", "5")], [("file", "q.png", pngs[3])]
        )
        assert status == 200, body
        top = body["results"][0]
        assert top["id"] == ids[3] and top["similarity_score"] >= 0.999, top
        self_score = top["similarity_score"]
        status, body, times["multimodal_ms"] = http.request(
            "POST",
            "/api/search/multimodal",
            [("query", MULTIMODAL_QUERY), ("weight_image", "0.7"), ("limit", "5")],
            [("file", "q.png", pngs[5])],
        )
        assert status == 200 and len(body["results"]) == 5, body
        scores = [r["similarity_score"] for r in body["results"]]
        assert scores == sorted(scores, reverse=True) and all(map(math.isfinite, scores))
        multimodal_top = [r["id"] for r in body["results"]]
        _sync(device)
        launches = {"K1": tile_max.launches, "K2": flash_mha.launches}
        status, health, _ = http.request("GET", "/api/health")
        assert status == 200 and health["images"] == n_pre + N_UPLOADS, health
    stats = state.store.stats()
    patches = {k: stats[k] for k in ("patched_mutations", "rebuild_mutations", "journal_ops")}
    # seen: the first search's text, the two texts, the image, the multimodal
    queries = torch.cat([seen[i].to(device) for i in (1, 3, 4)])
    surface = phase_surface(state, app, device)
    breakdown(state, pngs[7], device)

    image_calls = N_UPLOADS + 2  # each upload, the image search, the multimodal search
    text_calls = 4  # the three text searches, the multimodal search (four texts)
    expected = {
        "K1": 5,  # one phase-1 launch a search
        "K2": image_calls * cfg.vision.num_layers + text_calls * cfg.text.num_layers,
    }
    if torch.device(device).type != "cuda":  # the CPU runs the plain versions
        expected = {"K1": 0, "K2": 0}
    log(
        "slice: "
        + json.dumps(
            {
                "config": cfg.name,
                "store_rows": store_rows,
                "first_search_ms": times["first_search_ms"],
                "first_build": first_build,
                "upload_ms": times["upload_ms"],
                "duplicate_ms": times["duplicate_ms"],
                "first_search_after_upload_ms": times["first_search_after_upload_ms"],
                "warm_text_search_ms": times["warm_text_search_ms"],
                "image_ms": times["image_ms"],
                "multimodal_ms": times["multimodal_ms"],
                "self_match_similarity": self_score,
                "text_top5": text_top,
                "multimodal_top5": multimodal_top,
                **patches,
                "launches": launches,
                "expected_launches": expected,
            }
        )
    )
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != what the requests imply {expected}")
    if patches != {"patched_mutations": N_UPLOADS, "rebuild_mutations": 0, "journal_ops": N_UPLOADS}:
        raise AssertionError(f"the uploads did not patch the device index: {patches}")

    rebuild_and_patch(seed_store, queries, cfg.projection_dim, device)
    want = state.store.query(queries, n_results=10)["ids"]
    del seed_store, state, app
    gc.collect()
    restarts(root, embedder, queries, want, ids, device, N_UPLOADS + surface["journal_ops"])
    shutil.rmtree(root, ignore_errors=True)
    return launches, embedder, surface["launches"]


def rebuild_and_patch(store, queries, dim, device) -> None:
    """On a store of the app's content before the uploads (the one that
    wrote the snapshot): the first query after one add, patched and then
    rebuilt (IMATCH_INCREMENTAL=0), with an add from a second thread during
    that rebuild; then 64 deletes and 64 updates, patched, against a fresh
    build and against a fresh store over ``get(include=embeddings)``."""
    import torch

    from imatch_tpu_torch.index.store import VectorStore

    q = queries[:1]
    extra = _unit_rows(3, dim, 5, device)
    out = {}
    t = time.perf_counter()
    store.query(q, n_results=10)
    out["build_query_ms"] = (time.perf_counter() - t) * 1e3
    store.add(["extra_0"], extra[:1])
    t = time.perf_counter()
    store.query(q, n_results=10)
    out["first_query_after_add_patched_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    store._emb.copy(), store._alive.copy()
    out["copy_under_lock_ms"] = (time.perf_counter() - t) * 1e3  # what a writer can wait for

    building, marks = threading.Event(), {}
    build = store._build_device

    def marked_build(*args):
        building.set()
        dc = build(*args)
        marks["build_end"] = time.perf_counter()
        return dc

    store._build_device = marked_build
    got = []
    with environment(IMATCH_INCREMENTAL="0"):
        store.add(["extra_1"], extra[1:2])  # drops the index: the next query rebuilds
        t = time.perf_counter()
        reader = threading.Thread(target=lambda: got.append(store.query(q, n_results=10)))
        reader.start()
        assert building.wait(600), "the rebuild did not start"
        t_w = time.perf_counter()
        store.add(["extra_2"], extra[2:3])  # a writer during the rebuild
        t_w_end = time.perf_counter()
        reader.join(600)
        t_end = time.perf_counter()
    del store._build_device
    assert not reader.is_alive() and got, "the rebuilding query did not finish"
    out["first_query_after_add_rebuilt_ms"] = (t_end - t) * 1e3
    out["rebuild_s"] = store.stats()["last_build"]["seconds"]
    out["writer_during_rebuild_ms"] = (t_w_end - t_w) * 1e3
    out["writer_returned_before_build_end_ms"] = (marks["build_end"] - t_w_end) * 1e3
    log("slice rebuild: " + json.dumps(out))
    if t_w_end >= marks["build_end"]:
        raise AssertionError(f"the writer waited for the rebuild: {out}")

    # patches at full size: the index is rebuilt, then 64 deletes and 64
    # updates patch it
    store.query(q, n_results=10)
    ids = store.get(include=[])["ids"]
    store.delete(ids[:64])
    store.update(ids[100:164], embeddings=_unit_rows(64, dim, 6, device))
    stats = store.stats()
    row = check_patched(store, queries, device)
    row.update({k: stats[k] for k in ("patched_mutations", "rebuild_mutations", "live")})
    fresh = VectorStore(device=device)
    got = store.get(include=["embeddings"])
    fresh.add(got["ids"], got["embeddings"])
    del got
    row["ids_equal_fresh_store"] = store.query(queries, n_results=10)["ids"] == fresh.query(queries, n_results=10)["ids"]
    del fresh
    log("slice patches: " + json.dumps(row))
    # the patched add, the two deletes and updates; the kill-switch adds rebuilt
    if not (row["ok"] and row["ids_equal_fresh_store"]) or (stats["patched_mutations"], stats["rebuild_mutations"]) != (3, 1):
        raise AssertionError(f"the patched store disagrees with a fresh build: {row}")
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def restarts(root, embedder, queries, want, ids, device, journal_ops) -> None:
    """Restart twice (a journal replay of ``journal_ops`` ops, then a fresh
    snapshot with no journal), each answering ``queries`` with the ids
    ``want`` as before;
    then PUT /api/metadata persists across a restart and POST /api/reset
    leaves an empty store after one."""
    from imatch_tpu_torch.pipeline.state import AppState
    from imatch_tpu_torch.serving.app import create_app

    out = {}
    t = time.perf_counter()
    state = AppState(root=root, embedder=embedder, device=device)
    out["restart_s"] = time.perf_counter() - t
    out["last_load"] = state.store.stats()["last_load"]
    out["replay_s"] = out["last_load"]["replay_s"]
    out["journal_ops"] = state.store.stats()["journal_ops"]
    out["answers_equal_after_replay"] = state.store.query(queries, n_results=10)["ids"] == want
    t = time.perf_counter()
    state.snapshot(force=True)
    out["snapshot_s"] = time.perf_counter() - t
    out["journal_after_snapshot"] = os.path.exists(os.path.join(state.data_dir, "journal.jsonl"))
    del state
    gc.collect()
    t = time.perf_counter()
    state = AppState(root=root, embedder=embedder, device=device)
    out["restart_from_snapshot_s"] = time.perf_counter() - t
    out["last_load_from_snapshot"] = state.store.stats()["last_load"]
    out["answers_equal_after_snapshot"] = state.store.query(queries, n_results=10)["ids"] == want
    log("slice restarts: " + json.dumps(out))
    if not (
        out["answers_equal_after_replay"]
        and out["answers_equal_after_snapshot"]
        and out["journal_ops"] == journal_ops
        and out["last_load"]["replayed_ops"] == journal_ops
        and not out["journal_after_snapshot"]
        and out["last_load_from_snapshot"]["replayed_ops"] == 0
    ):
        raise AssertionError(f"a restart lost state: {out}")

    routes = {}
    with ServerThread(create_app(state), port := _free_port()):
        http = HttpClient(port)
        status, body, routes["put_metadata_ms"] = http.request(
            "PUT", f"/api/metadata/{ids[0]}", [("description", "edited on the card")]
        )
        assert status == 200 and body["metadata"]["description"] == "edited on the card", body
        assert http.request("PUT", "/api/metadata/img_nope", [("description", "x")])[0] == 404
        assert http.request("PUT", f"/api/metadata/{ids[0]}", [("custom_metadata", "x")])[0] == 422
    del state
    gc.collect()
    state = AppState(root=root, embedder=embedder, device=device)
    routes["metadata_after_restart"] = state.image_metadata[ids[0]]["description"]
    assert routes["metadata_after_restart"] == "edited on the card", routes
    with ServerThread(create_app(state), port := _free_port()):
        http = HttpClient(port)
        status, body, routes["reset_ms"] = http.request("POST", "/api/reset")
        assert status == 200 and body == {"success": True}, body
        status, body, _ = http.request("GET", "/api/images")
        assert status == 200 and body == {"images": []}, body
    del state
    gc.collect()
    state = AppState(root=root, embedder=embedder, device=device)
    routes["count_after_reset_and_restart"] = state.store.count()
    log("slice routes: " + json.dumps(routes))
    if routes["count_after_reset_and_restart"] != 0:
        raise AssertionError(f"the reset did not persist: {routes}")


# -- phase 6b ----------------------------------------------------------------

BATCH_TEXTS = [
    f"{thing} {where}"
    for thing in ("a red drill", "a blue kettle", "two cats", "an old bicycle")
    for where in ("on a table", "in a garden", "at night", "on a white background")
]  # 16 texts
N_BIG_BATCH = 256  # /api/search/batch's limit, at limit 0 (k 1000 -> 1024)
N_ODD_BATCH = 129  # a count that is no power of two, at limit 0
INGEST_GATE_CHUNK = 64  # the ingest-stream gate reading's chunk: 512 frames, 8 chunks
INGEST_GATE_SEARCHES = 8
INGEST_GATE_STAGGER_S = 0.05  # the searches' start times, apart
IMAGE_BATCH_SIZES = [(240, 320), (480, 640), (600, 800), (320, 240)]  # x 6: 24 frames
IMAGE_BATCH_BUDGET = 1 << 21  # source pixels a chunk: the 24 frames take 3 or more chunks
N_COALESCE = 32
INGEST_FOLDER = 64  # one geometry: one fused chunk of 64
N_SAMPLES = 8
# phase 6b's adds: four folders (device-resident, host, host,
# device-resident: the two paths in turns), the samples. The store is filled
# to STORE_ROWS with them, so it never outgrows its 2^20 slots (a capacity
# growth would drop the device index for a rebuild).
SURFACE_ROWS = 4 * INGEST_FOLDER + N_SAMPLES


@contextlib.contextmanager
def counted_builds():
    """Kernel builds and library loads in a ``with`` block: nvcc runs
    (``_build.build``'s compiled sources) and libraries newly loaded."""
    from imatch_tpu_torch.ops.kernels import _build

    build = _build.build
    libs0 = len(_build._libs)
    out = {"nvcc": 0}

    def counting(names=_build.SOURCES):
        reports = build(names)
        out["nvcc"] += len(reports)
        return reports

    _build.build = counting
    try:
        yield out
    finally:
        _build.build = build
        out["libraries_loaded"] = len(_build._libs) - libs0


@contextlib.contextmanager
def engine_calls(store):
    """The query counts of ``store``'s engine calls in a ``with`` block."""
    calls = []
    run = store._run_engine

    def recording(q, dc, k):
        calls.append(int(q.shape[0]))
        return run(q, dc, k)

    store._run_engine = recording
    try:
        yield calls
    finally:
        del store._run_engine


@contextlib.contextmanager
def warnings_of(name):
    """WARNING records of logger ``name`` in a ``with`` block."""
    import logging

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep(logging.WARNING)
    logger = logging.getLogger(name)
    logger.addHandler(handler)
    try:
        yield records
    finally:
        logger.removeHandler(handler)


def _ids_of(body):
    return [[r["id"] for r in row] for row in body["results"]]


def _p50(values):
    return sorted(values)[len(values) // 2]


def _concurrent_queries(store, rows, k=10):
    """One thread a row, all started together: (results, per-request ms)."""
    results, ms = [None] * len(rows), [None] * len(rows)
    go = threading.Barrier(len(rows))

    def one(i):
        go.wait()
        t = time.perf_counter()
        results[i] = store.query(rows[i : i + 1], n_results=k)
        ms[i] = (time.perf_counter() - t) * 1e3

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(rows))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive(), "a concurrent query hung"
    return results, ms


@contextlib.contextmanager
def stage_ms():
    """The METRICS stages a ``with`` block ran (``ingest.*``, ``embed.*``,
    ``index.*``): milliseconds the block added to each."""
    from imatch_tpu_torch.utils.metrics import METRICS

    before = METRICS.snapshot()["timings"]
    out = {}
    yield out
    for name, t in sorted(METRICS.snapshot()["timings"].items()):
        was = before.get(name, {"count": 0, "total_s": 0.0})
        if t["count"] != was["count"]:
            out[name] = round((t["total_s"] - was["total_s"]) * 1e3, 3)


def _journal_lines(state) -> int:
    path = os.path.join(state.data_dir, "journal.jsonl")
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as f:
        return sum(1 for line in f if line.strip())


def device_ingest_check(state, http, frames, device, tag) -> dict:
    """A folder of same-size frames through /api/upload-folder with
    IMATCH_DEVICE_INGEST=1: every file a success, one patch of the device
    index and no rebuild, nothing pending after the request's flush, the
    host mirror's rows equal to the card's bit for bit, and a journal
    entry a file (where the store journals). The caller holds the patched
    index against a fresh build (``check_patched``)."""
    import numpy as np

    store = state.store
    before = store.stats()
    lines0 = _journal_lines(state)
    files = [("files", f"{tag}{i}.png", _png_bytes(f)) for i, f in enumerate(frames)]
    with environment(IMATCH_DEVICE_INGEST="1"), stage_ms() as stages:
        status, body, ms = http.request("POST", "/api/upload-folder", files=files)
    assert status == 200 and body["successful"] == len(frames), body
    after = store.stats()
    slots = [store._slot[r["id"]] for r in body["results"]]
    dc = store._device_corpus[1]
    out = {
        "folder_ms": ms,
        "patched": after["patched_mutations"] - before["patched_mutations"],
        "rebuilt": after["rebuild_mutations"] - before["rebuild_mutations"],
        "pending_after_request": after["pending_host_syncs"],
        "journal_ops_added": after["journal_ops"] - before["journal_ops"],
        "journal_lines_added": _journal_lines(state) - lines0,
        "stages_ms": stages,
    }
    # the device engines' fp32 rows are on the card; the host tier's on the host
    rows = dc.exact[slots].cpu().numpy() if hasattr(dc, "exact") else dc.host_exact[slots]
    out["mirror_equals_card_rows"] = bool(np.array_equal(store._emb[slots], rows))
    return out


def staggered_searches(http, tag, n, stagger_s, busy):
    """``n`` text searches over HTTP on threads started ``stagger_s``
    apart, each a new text: each one's ms, and whether ``busy()`` held at
    its start."""
    ms, busy_at = [None] * n, [None] * n

    def one(j):
        time.sleep(j * stagger_s)
        busy_at[j] = busy()
        status, body, ms[j] = http.request(
            "POST", "/api/search/text", [("query", f"{tag} search number {j}"), ("limit", "10")]
        )
        assert status == 200 and len(body["results"]) == 10, body

    threads = [threading.Thread(target=one, args=(j,)) for j in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        assert not t.is_alive(), "a search hung"
    return ms, busy_at


def ingest_gate_reading(emb, http, frames) -> dict:
    """Text searches during the fused ingest stream (the device half of a
    folder upload, driven directly: no decode, no saves, nothing added to
    the store) of ``frames`` in chunks of ``INGEST_GATE_CHUNK``, against the
    same searches with the card idle: ``INGEST_GATE_SEARCHES`` threads
    started ``INGEST_GATE_STAGGER_S`` apart once the first chunk is
    dispatched. The stream parks at GATE.checkpoint() before a dispatch
    while a search's store query runs, but up to its ``max_in_flight`` (4)
    chunks are already on the card ahead of the search, and its text tower
    runs outside the priority section. A reading, not a bar."""
    dispatched, done = threading.Event(), threading.Event()
    fused = emb._fused_step
    emb._fused_step = lambda *a: dispatched.set() or fused(*a)
    stream = {}

    def ingest():
        try:
            t = time.perf_counter()
            stream["yields"] = sum(1 for _ in emb.ids_and_embed_images_stream(frames))
            stream["ms"] = (time.perf_counter() - t) * 1e3
        finally:
            dispatched.set()
            done.set()

    def searches(tag, busy=lambda: False):
        return staggered_searches(http, tag, INGEST_GATE_SEARCHES, INGEST_GATE_STAGGER_S, busy)

    try:
        idle_ms, _ = searches("ingest idle")
        with environment(IMATCH_EMBED_CHUNK=str(INGEST_GATE_CHUNK)):
            worker = threading.Thread(target=ingest)
            worker.start()
            assert dispatched.wait(300), "the ingest stream did not start"
            during_ms, during_busy = searches("ingest busy", lambda: not done.is_set())
            worker.join(300)
            assert not worker.is_alive(), "the ingest stream hung"
    finally:
        del emb._fused_step
    assert stream.get("yields") == -(-len(frames) // INGEST_GATE_CHUNK), stream
    return {
        "frames": len(frames),
        "chunk": INGEST_GATE_CHUNK,
        "stream_ms": stream["ms"],
        "idle_search_ms": idle_ms,
        "search_ms_during_stream": during_ms,
        "started_while_streaming": during_busy,
        "p50_idle_ms": _p50(idle_ms),
        "p50_during_ms": _p50([m for m, b in zip(during_ms, during_busy) if b] or during_ms),
    }


def _brute_ids(store, queries, device, n, k=10):
    """Ids of the full fp32 brute force over the store's first ``n`` slots
    (the rows a request saw: later adds only append), for each query."""
    import torch

    rows = torch.from_numpy(store._emb[:n]).to(device)
    alive = torch.from_numpy(store._alive[:n]).to(device)
    out = []
    for q0 in range(0, queries.shape[0], 16):  # bounded (16, n) score blocks
        _, idx = brute_force_topk(queries[q0 : q0 + 16].to(device).float(), rows, alive, k)
        out += [[store._ids[i] for i in r] for r in idx.tolist()]
    return out


def phase_surface(state, app, device) -> dict:
    """The rest of the serving surface on slice 1's loaded 2^20-row store
    and its embedder: the app's warmup and ``warm`` at the batch shapes, a
    16-query /api/search/batch beside 16 single searches, 256 queries at
    limit 0, a 24-frame /api/search/image-batch in pixel-budget chunks,
    coalesced concurrent queries, folders of 64 ingested device-resident
    and on the host path in turns, /search in its three modes, /upload-samples and
    /api/metrics. The launches of K1 and K2 are counted over the phase's
    requests (warm included); the checks that run kernels themselves come
    after. Returns the launch counts, the journal ops the phase added, and
    the query rows for later phases."""
    import shutil

    import numpy as np
    import torch

    from imatch_tpu_torch.index.store import VectorStore
    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
    from imatch_tpu_torch.ops.kernels.topk import tile_max
    from imatch_tpu_torch.serving import app as app_mod
    from imatch_tpu_torch.utils.metrics import METRICS

    store, emb = state.store, state.get_embedder()
    dim = emb.cfg.projection_dim
    journal0 = store.stats()["journal_ops"]
    out, times = {}, {}
    samples_dir = os.path.join("build", "chip_smoke_samples")
    shutil.rmtree(samples_dir, ignore_errors=True)
    os.makedirs(samples_dir)
    for i in range(N_SAMPLES):
        with open(os.path.join(samples_dir, f"sample{i}.png"), "wb") as f:
            f.write(_png_bytes(photo_frame(9900 + i, 240, 320)))
    img_frames = [
        photo_frame(9100 + i, *IMAGE_BATCH_SIZES[i % len(IMAGE_BATCH_SIZES)]) for i in range(24)
    ]
    folders = [[photo_frame(9200 + 100 * j + i, 240, 320) for i in range(INGEST_FOLDER)] for j in range(4)]
    coalesce_rows = emb.embed_texts_device([f"coalesced query {i}" for i in range(N_COALESCE)])
    with environment(IMATCH_COALESCE="1"):  # the env gate: on for a card's store only
        assert VectorStore(device=device).coalescing == (torch.device(device).type == "cuda")
    METRICS.reset()
    _sync(device)

    counts_of = dict(clip_vision=emb.model.vision, clip_text=emb.model.text)
    port = _free_port()
    with ServerThread(app, port), recorded_queries(store) as seen, engine_calls(store) as calls, call_counts(
        **counts_of
    ) as towers:
        http = HttpClient(port)
        tile_max.launches = tile_max.mma_launches = flash_mha.launches = 0
        # the app's warmup (app start) and warm at the batch route's shapes
        with counted_builds() as warm_builds, warnings_of("imatch.api") as warned:
            t = time.perf_counter()
            app_mod._warmup(state)
            store.warm(n_results_list=(10,), q_counts=(2, 4, 8, 16, 32, 64, 128, N_BIG_BATCH))
            _sync(device)
            times["warm_s"] = time.perf_counter() - t
        assert not warned, warned
        # 16 texts in one request, then the same 16 one at a time
        with counted_builds() as first_builds, stage_ms() as stages:
            status, body, times["batch16_ms"] = http.request_json(
                "/api/search/batch", {"queries": BATCH_TEXTS, "limit": 10}
            )
        times["batch16_stages_ms"] = stages
        assert status == 200 and len(body["results"]) == 16, body
        batch_ids = _ids_of(body)
        batch_q = seen[-1]
        batch_n = store._n
        singles = []
        for text in BATCH_TEXTS:
            status, sb, ms = http.request("POST", "/api/search/text", [("query", text), ("limit", "10")])
            assert status == 200, sb
            singles.append(ms)
        times["single16_ms"] = singles
        # 256 texts at limit 0: k 1000 (1024 in the engine)
        big = [f"query {i} {BATCH_TEXTS[i % 16]}" for i in range(N_BIG_BATCH)]
        with stage_ms() as stages:
            status, body, times["batch256_limit0_ms"] = http.request_json(
                "/api/search/batch", {"queries": big, "limit": 0}
            )
        times["batch256_stages_ms"] = stages
        assert status == 200 and len(body["results"]) == N_BIG_BATCH, status
        assert all(len(row) == 1000 for row in body["results"])
        big_top = [row[0]["id"] for row in body["results"]]
        big_q = seen[-1]
        big_n = store._n
        # a count that is no power of two: the store pads no rows
        status, body, times["batch129_limit0_ms"] = http.request_json(
            "/api/search/batch", {"queries": big[:N_ODD_BATCH], "limit": 0}
        )
        assert status == 200 and len(body["results"]) == N_ODD_BATCH, status
        odd_top = [row[0]["id"] for row in body["results"]]
        odd_q = seen[-1]
        del body
        # 24 frames of four sizes in pixel-budget chunks
        chunks = []
        embed_frames = emb._embed_frames
        emb._embed_frames = lambda images: chunks.append(len(images)) or embed_frames(images)
        try:
            with environment(IMATCH_QUERY_PIXEL_BUDGET=str(IMAGE_BATCH_BUDGET)), stage_ms() as stages:
                status, body, times["image_batch24_ms"] = http.request(
                    "POST",
                    "/api/search/image-batch",
                    [("limit", "10")],
                    [("files", f"q{i}.png", _png_bytes(f)) for i, f in enumerate(img_frames)],
                )
        finally:
            del emb._embed_frames
        times["image_batch24_stages_ms"] = stages
        assert status == 200 and len(body["results"]) == 24, body
        image_ids = _ids_of(body)
        image_q = seen[-1]
        image_n = store._n
        # coalescing: 32 threads, one pre-embedded query each, direct then coalesced
        direct, direct_ms = _concurrent_queries(store, coalesce_rows)
        store.set_coalescing(True)
        groups = []
        coal = store._coalescer
        run_group = coal._run_group
        coal._run_group = lambda k, inc, members: groups.append(len(members)) or run_group(k, inc, members)
        try:
            coalesced, coalesced_ms = _concurrent_queries(store, coalesce_rows)
        finally:
            store.set_coalescing(False)
        # folders of 64 in turns: device-resident, host, host, device-resident
        ingests = [device_ingest_check(state, http, folders[0], device, "d0_")]
        for j in (1, 2):
            with stage_ms() as stages:
                status, body, ms = http.request(
                    "POST", "/api/upload-folder", files=[("files", f"h{j}_{i}.png", _png_bytes(f)) for i, f in enumerate(folders[j])]
                )
            assert status == 200 and body["successful"] == INGEST_FOLDER, body
            times.setdefault("host_ingest_folder64_ms", []).append(ms)
            times.setdefault("host_ingest_stages_ms", []).append(stages)
        ingests.append(device_ingest_check(state, http, folders[3], device, "d3_"))
        times["device_ingest_folder64_ms"] = [ingests[0]["folder_ms"], ingests[1]["folder_ms"]]
        ingest_gate = ingest_gate_reading(emb, http, [f for folder in folders for f in folder] * 2)
        # /search in its three modes
        png = _png_bytes(img_frames[0])
        modes = {}
        for mode, fields, files in (
            ("text", [("query", "a lamp on a desk")], []),
            ("image", [], [("file", "s.png", png)]),
            ("multimodal", [("query", "a lamp on a desk"), ("weight_image", "0.6")], [("file", "s.png", png)]),
        ):
            status, body, times[f"search_{mode}_ms"] = http.request("POST", "/search", fields + [("limit", "5")], files)
            assert status == 200 and body["mode"] == mode and len(body["results"]) == 5, body
            modes[mode] = [r["id"] for r in body["results"]]
        with environment(IMATCH_SAMPLES_DIR=samples_dir):
            status, body, times["upload_samples_ms"] = http.request("POST", "/upload-samples")
        assert status == 200 and body["successful"] == N_SAMPLES, body
        _sync(device)
        launches = {
            "K1": tile_max.launches - tile_max.mma_launches,
            "K1_mma": tile_max.mma_launches,
            "K2": flash_mha.launches,
        }
        tower_calls = dict(towers)
        engine_qs = list(calls)
        status, metrics, _ = http.request("GET", "/api/metrics")
        assert status == 200, metrics
    shutil.rmtree(samples_dir, ignore_errors=True)

    # -- checks that launch kernels of their own --------------------------------
    cfg = emb.cfg
    expected = {
        "K1": sum(q == 1 for q in engine_qs),
        "K1_mma": sum(q >= 2 for q in engine_qs),
        "K2": cfg.vision.num_layers * tower_calls["clip_vision"] + cfg.text.num_layers * tower_calls["clip_text"],
    }
    if torch.device(device).type != "cuda":  # the CPU runs the plain versions
        expected = dict.fromkeys(expected, 0)
    # store level: the 16 rows at once against 16 single queries, ids and scores
    b = store.query(batch_q, n_results=10, include=["distances"])
    one = [store.query(batch_q[i : i + 1], n_results=10, include=["distances"]) for i in range(16)]
    store_equal = all(b["ids"][i] == one[i]["ids"][0] for i in range(16))
    score_diff = max(
        float(np.abs(np.asarray(b["distances"][i]) - np.asarray(one[i]["distances"][0])).max()) for i in range(16)
    )
    brute16 = _brute_ids(store, batch_q, device, batch_n)
    bruteimg = _brute_ids(store, image_q, device, image_n)
    brute_big = [r[0] for r in _brute_ids(store, big_q, device, big_n, k=1)]
    brute_odd = [r[0] for r in _brute_ids(store, odd_q, device, big_n, k=1)]
    unchunked = emb.embed_images_device(img_frames)
    pngs24 = [_png_bytes(f) for f in img_frames]
    t = time.perf_counter()
    app_mod._decode_all(pngs24)
    times["image_batch24_decode_ms"] = (time.perf_counter() - t) * 1e3
    with environment(IMATCH_QUERY_PIXEL_BUDGET=str(IMAGE_BATCH_BUDGET)):
        times["image_batch24_embed_ms"] = _host_ms(lambda: emb.embed_images_device(img_frames), device, iters=3)
    cos = torch.nn.functional.cosine_similarity(unchunked.float(), image_q.to(unchunked.device).float(), dim=1)
    coalesced_equal = [c["ids"] for c in coalesced] == [d["ids"] for d in direct]
    coalesced_score_diff = max(
        float(np.abs(np.asarray(c["distances"]) - np.asarray(d["distances"])).max())
        for c, d in zip(coalesced, direct)
    )
    # the card's phase 2 is batch-invariant (scripts/rescore_ab.py): equal
    # bit for bit there; the CPU's batched product only to its last bits
    # (a rehearsal of this phase on the CPU)
    score_tol = 0.0 if torch.device(device).type == "cuda" else 1e-6
    patched = check_patched(store, batch_q.to(device), device)
    metric_counts = {
        name: metrics["timings"][name]["count"]
        for name in sorted(metrics["timings"])
        if name.startswith(("index.", "embed.", "ingest."))
    }
    out = {
        **times,
        "per_query_batch16_ms": times["batch16_ms"] / 16,
        "builds": {"warm": warm_builds, "first_request_after_warm": first_builds},
        "batch16_ids_equal_brute_force": batch_ids == brute16,
        "batch16_store_equals_single": store_equal,
        "batch16_store_max_score_diff": score_diff,
        "batch256_top1_equal_brute_force": big_top == brute_big,
        "batch129_top1_equal_brute_force": odd_top == brute_odd,
        "batch129_engine_ran_at_129": N_ODD_BATCH in engine_qs,
        "image_batch_chunks": chunks,
        "image_batch_ids_equal_brute_force": image_ids == bruteimg,
        "image_batch_min_cosine_to_unchunked": float(cos.min()),
        "coalesce_groups": groups,
        "coalesced_equal_direct": coalesced_equal,
        "coalesced_max_score_diff": coalesced_score_diff,
        "direct_p50_ms": _p50(direct_ms),
        "coalesced_p50_ms": _p50(coalesced_ms),
        "device_ingest": ingests,
        "ingest_gate": ingest_gate,
        "device_ingest_patch_check": patched,
        "search_modes": modes,
        "metrics_counts": metric_counts,
        "engine_query_counts": engine_qs,
        "tower_calls": tower_calls,
        "launches": launches,
        "expected_launches": expected,
    }
    log("surface: " + json.dumps(out))
    failures = [
        name
        for name, ok in (
            ("no kernel build after warm", first_builds["nvcc"] == 0 and first_builds["libraries_loaded"] == 0),
            ("batch ids equal brute force", out["batch16_ids_equal_brute_force"]),
            ("batch equals single queries", store_equal and score_diff <= score_tol),
            ("256 queries at limit 0", out["batch256_top1_equal_brute_force"]),
            ("129 queries at limit 0", out["batch129_top1_equal_brute_force"] and N_ODD_BATCH in engine_qs),
            ("image batch in 3+ chunks", len(chunks) >= 3 and sum(chunks) == 24),
            ("image batch ids equal brute force", out["image_batch_ids_equal_brute_force"]),
            ("chunked embeddings", out["image_batch_min_cosine_to_unchunked"] >= 0.9999),
            ("coalesced equal direct", coalesced_equal and coalesced_score_diff <= score_tol),
            ("coalescer grouped", sum(groups) == N_COALESCE and len(groups) < N_COALESCE),
            (
                "device ingest",
                all(
                    ingest["patched"] == 1
                    and ingest["rebuilt"] == 0
                    and ingest["pending_after_request"] == 0
                    and ingest["journal_ops_added"] == ingest["journal_lines_added"] == INGEST_FOLDER
                    and ingest["mirror_equals_card_rows"]
                    for ingest in ingests
                )
                and patched["ok"],
            ),
            (
                "metrics",
                all(metric_counts.get(n, 0) > 0 for n in ("index.query", "index.dispatch", "embed.image", "embed.text", "ingest.stream", "ingest.add", "ingest.flush")),
            ),
            ("launch counts", launches == expected and all(launches.values()) or torch.device(device).type != "cuda"),
        )
        if not ok
    ]
    if failures:
        raise AssertionError(f"the serving surface failed: {failures}")
    return {
        "launches": launches,
        "journal_ops": store.stats()["journal_ops"] - journal0,
    }


def _host_ms(fn, device, iters: int = 10) -> float:
    """Mean host-clock time of one call that ends in a device sync."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        _sync(device)
    return (time.perf_counter() - t0) * 1e3 / iters


def breakdown(state, png: bytes, device) -> None:
    """Where an upload's and a search's time goes: each stage of the
    slice's requests timed alone, warm, on the app's own objects."""
    import numpy as np
    import torch
    from PIL import Image

    from imatch_tpu_torch.ops.phash import image_id
    from imatch_tpu_torch.ops.preprocess import preprocess_images

    emb = state.get_embedder()
    pil = Image.open(io.BytesIO(png)).convert("RGB")
    frame = np.asarray(pil)
    pixels = preprocess_images(
        [frame], device=emb.device, out_size=emb.cfg.vision.image_size, dtype=emb.compute_dtype
    )
    vec = emb.embed_image_device(frame)
    rows = {
        "decode_ms": _host_ms(lambda: Image.open(io.BytesIO(png)).convert("RGB"), device),
        "phash_ms": _host_ms(lambda: image_id(pil), device),
        "png_save_ms": _host_ms(lambda: pil.save(io.BytesIO(), "PNG"), device),
        "preprocess_ms": _host_ms(
            lambda: preprocess_images(
                [frame], device=emb.device, out_size=emb.cfg.vision.image_size,
                dtype=emb.compute_dtype,
            ),
            device,
        ),
        "image_tower_ms": _host_ms(lambda: emb._embed_pixels(pixels), device),
        "text_tower_ms": _host_ms(lambda: emb.embed_texts_device([TEXT_QUERY]), device),
        "store_query_ms": _host_ms(
            lambda: state.store.query(vec[None], n_results=10), device
        ),
    }
    log("breakdown: " + json.dumps(rows))
    if torch.device(device).type == "cuda":
        stages = {
            "image_tower": (lambda: emb._embed_pixels(pixels), rows["image_tower_ms"]),
            "text_tower": (lambda: emb.embed_texts_device([TEXT_QUERY]), rows["text_tower_ms"]),
            "store_query": (
                lambda: state.store.query(vec[None], n_results=10),
                rows["store_query_ms"],
            ),
        }
        for name, (fn, wall_ms) in stages.items():
            log(f"device {name}: " + json.dumps(device_busy(fn, wall_ms)))


def device_busy(fn, wall_ms: float, iters: int = 5, top: int = 0) -> dict:
    """Device time of one call from a torch.profiler trace (kernel_ab.py's
    ``trace``): the sum of its kernel and copy intervals, the port's
    kernels by name, and the idle share against ``wall_ms``, the same
    call's host-clock time measured without the profiler."""
    from imatch_tpu_torch.scripts.kernel_ab import trace

    t = trace(fn, iters)
    out = {
        "wall_ms": wall_ms,
        "device_busy_ms": t["busy_ms"],
        "idle_share": 1.0 - t["busy_ms"] / wall_ms,
        "device_ops_per_call": t["ops"],
        "trace_guarded": t["guarded"],
        **{f"{k}_ms": t["by_key"].get(k, 0.0) for k in ("K1", "K1_int8", "K2", "K3", "K4", "K5", "K6")},
    }
    if top:  # the device's time by kernel name, largest first
        ranked = sorted(t["by_name"].items(), key=lambda kv: -kv[1])[:top]
        out["top_kernels_ms"] = [[name[:70], ms] for name, ms in ranked]
    return out


# -- phase 7 -----------------------------------------------------------------

W8A8_BIG = 41  # 240x320 frames a0..a40; a0 is also the single upload
W8A8_TAIL = 5  # 200x300 frames: fewer than DEVICE_BUCKET_MIN, the host tail


def photo_frame(seed: int, h: int, w: int):
    """A photo-like uint8 frame from a seed: soft colour blobs on a flat
    ground with a little sensor noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3)) + rng.uniform(40, 200, 3)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(20, 90)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        img += blob[..., None] * rng.uniform(-120, 120, 3)
    return np.clip(img + rng.normal(0, 4, (h, w, 3)), 0, 255).astype(np.uint8)


def _phash_margin(frame) -> float:
    """The smallest distance of a 64 pHash coefficient to their median, on
    PIL's own 32x32 grid. Above 32, the device hash is provably PIL's: the
    device grid differs from PIL's in at most a few boundary pixels, each
    moving a coefficient by at most 4, so the device's margin stays above
    its 16 and its bits are PIL's (imatch_tpu_torch/ops/phash.py)."""
    import numpy as np
    import scipy.fftpack
    from PIL import Image

    grid = np.asarray(
        Image.fromarray(frame).convert("L").resize((32, 32), Image.Resampling.LANCZOS), np.float64
    )
    low = scipy.fftpack.dct(scipy.fftpack.dct(grid, axis=0), axis=1)[:8, :8]
    return float(np.abs(low - np.median(low)).min())


def _png_bytes(frame) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "PNG")
    return buf.getvalue()


def _w8a8_folder():
    """The folder's (filename, bytes), in upload order, and the host pHash
    id of every decodable file. The 240x320 frames that take the fused
    device path are photo-like frames whose pHash margin clears 32, so
    every id they get is PIL's (``_phash_margin``); an unconfident device
    hash takes the fp64 tail on the device grid, which can differ from PIL
    in rare boundary cases, as in the JAX package."""
    from PIL import Image

    from imatch_tpu_torch.ops.phash import image_id

    big, seed = [], 1000
    while len(big) < W8A8_BIG:
        frame = photo_frame(seed, 240, 320)
        if _phash_margin(frame) > 32.0:
            big.append(_png_bytes(frame))
        seed += 1
    files = [(f"a{i}.png", png) for i, png in enumerate(big)]
    files.insert(6, ("a5_again.png", big[5]))  # in-batch duplicate
    files += [(f"b{i}.png", _png_bytes(photo_frame(5000 + i, 200, 300))) for i in range(W8A8_TAIL)]
    files.insert(20, ("empty.png", b""))
    files.insert(30, ("broken.png", b"\x89PNG\r\n\x1a\n but no image follows"))
    host_ids = {
        name: image_id(Image.open(io.BytesIO(png)).convert("RGB"))
        for name, png in files
        if name not in ("empty.png", "broken.png")
    }
    assert len(set(host_ids.values())) == W8A8_BIG + W8A8_TAIL, "synthetic frames collide"
    return files, host_ids


def _check_folder_response(body, files, host_ids) -> None:
    """Every count and per-file status of /api/upload-folder, and every
    id equal to the host pHash id of its frame."""
    counts = [body["total"], body["successful"], body["skipped"], body["failed"]]
    want = [len(files), W8A8_BIG - 1 + W8A8_TAIL, 3, 1]
    assert body["success"] is True and counts == want, (counts, want)
    by_name = {r["filename"]: r for r in body["results"]}
    assert len(by_name) == len(files)
    for name, _ in files:
        r = by_name[name]
        if name == "empty.png":
            assert r == {"filename": name, "status": "skipped", "reason": "Empty file"}, r
        elif name == "broken.png":
            assert r["status"] == "error" and r["reason"].startswith("Cannot open image:"), r
        elif name in ("a0.png", "a5_again.png"):  # the upload's and an in-batch duplicate
            assert r["status"] == "skipped" and r["id"] == host_ids[name], r
            assert r["reason"] == "Duplicate image detected", r
        else:
            assert r["status"] == "success" and r["id"] == host_ids[name], r


def phase_w8a8(device="cuda", config=SLICE_CONFIG):
    """The app at ``config`` with IMATCH_EMBED_QUANT=int8 over HTTP: one
    upload, a folder through /api/upload-folder, an image and a text
    search. Returns the launch counts and the embedder. (A small config on
    the CPU rehearses the same control flow.)"""
    import shutil

    import torch

    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
    from imatch_tpu_torch.ops.kernels.quantize import ln_quant_rows, quant_rows
    from imatch_tpu_torch.ops.kernels.topk import tile_max
    from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
    from imatch_tpu_torch.pipeline.ingest import process_batch
    from imatch_tpu_torch.pipeline.state import AppState
    from imatch_tpu_torch.serving.app import create_app

    root = os.path.join("build", "chip_smoke_w8a8")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    embedder = ClipEmbedder(config, device=device, quant="int8")
    state = AppState(root=root, embedder=embedder, device=device, autoload=False)
    app = create_app(state)
    cfg = embedder.cfg
    log(f"w8a8: {cfg.name} app with the int8 image tower ready in {time.perf_counter() - t0:.1f} s")
    files, host_ids = _w8a8_folder()
    first = files[0][1]
    port = _free_port()
    with ServerThread(app, port):
        http = HttpClient(port)
        _sync(device)
        kernels = {"K1": tile_max, "K2": flash_mha, "K3": quant_rows, "K4": ln_quant_rows}
        for fn in kernels.values():
            fn.launches = 0
        times = {}
        status, body, times["upload_ms"] = http.request(
            "POST", "/api/upload", files=[("file", "first.png", first)]
        )
        assert status == 200 and body["metadata"]["id"] == host_ids["a0.png"], (status, body)
        status, body, times["upload_folder_ms"] = http.request(
            "POST", "/api/upload-folder", files=[("files", n, c) for n, c in files]
        )
        assert status == 200, (status, body)
        _check_folder_response(body, files, host_ids)
        assert process_batch.stream_failures == 0, "the fused stream failed"
        status, body, times["image_ms"] = http.request(
            "POST", "/api/search/image", [("limit", "5")], [("file", "q.png", files[8][1])]
        )
        assert files[8][0] == "a7.png" and status == 200, body
        top = body["results"][0]
        assert top["id"] == host_ids["a7.png"] and top["similarity_score"] >= 0.999, top
        self_score = top["similarity_score"]
        status, body, times["text_ms"] = http.request(
            "POST", "/api/search/text", [("query", TEXT_QUERY), ("limit", "5")]
        )
        assert status == 200 and len(body["results"]) == 5, body
        _sync(device)
        launches = {k: fn.launches for k, fn in kernels.items()}
        status, health, _ = http.request("GET", "/api/health")
        assert status == 200 and health["images"] == W8A8_BIG + W8A8_TAIL, health
    breakdown_fused(embedder, files, device)
    shutil.rmtree(root, ignore_errors=True)

    # image-tower calls: the upload, the fused chunk, the host tail, the
    # image search; one text-tower call
    image_calls, nv, nt = 4, cfg.vision.num_layers, cfg.text.num_layers
    expected = {"K1": 2, "K2": image_calls * nv + nt, "K3": 2 * nv * image_calls, "K4": 2 * nv * image_calls}
    log(
        "w8a8: "
        + json.dumps(
            {
                "config": cfg.name,
                "quant": embedder.quant,
                "files": len(files),
                **times,
                "self_match_similarity": self_score,
                "stream_failures": process_batch.stream_failures,
                "launches": launches,
                "expected_launches": expected,
            }
        )
    )
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != what the requests imply {expected}")
    return launches, embedder


def breakdown_fused(emb, files, device) -> None:
    """The fused bulk-ingest step's stages at the folder's chunk (42
    frames of one geometry, padded to 64), each timed alone, warm: the
    preprocess, the W8A8 tower, the device pHash and the whole step; and
    the bf16 tower on the same seed's weights at the same B."""
    import numpy as np
    import torch
    from PIL import Image

    from imatch_tpu_torch.models.clip.model import encode_image, init_random
    from imatch_tpu_torch.ops.phash import phash_core
    from imatch_tpu_torch.ops.preprocess import preprocess_core
    from imatch_tpu_torch.ops.resize import resample_matrix, resize_crop_matrices
    from imatch_tpu_torch.pipeline.embedder import SEED, pow2_bucket

    decoded = [
        np.asarray(Image.open(io.BytesIO(c)).convert("RGB"))
        for n, c in files
        if n.startswith("a")
    ]
    b, (h, w) = len(decoded), decoded[0].shape[:2]
    bp = pow2_bucket(b, 512)
    frames = torch.from_numpy(np.stack(decoded + decoded[-1:] * (bp - b))).to(emb.device)
    a_v_c, a_h_c = resize_crop_matrices(h, w, emb.cfg.vision.image_size)
    consts = tuple(
        torch.from_numpy(m).to(emb.device)
        for m in (
            a_v_c,
            a_h_c,
            resample_matrix(h, 32, "lanczos", quantize_8bpc=True),
            resample_matrix(w, 32, "lanczos", quantize_8bpc=True),
        )
    )
    pixels = preprocess_core(frames, consts[0], consts[1], dtype=emb.compute_dtype)
    gen = torch.Generator(device=emb.device).manual_seed(SEED)
    bf16 = init_random(emb.cfg, device=emb.device, dtype=emb.compute_dtype, generator=gen)
    stages = {
        "preprocess": lambda: preprocess_core(frames, consts[0], consts[1], dtype=emb.compute_dtype),
        "w8a8_tower": lambda: encode_image(emb.model, pixels),
        "phash": lambda: phash_core(frames, consts[2], consts[3]),
        "fused_step": lambda: emb._fused_step(frames, consts),
        "bf16_tower": lambda: encode_image(bf16, pixels),
    }
    rows = {"frames": b, "padded_batch": bp, "geometry": [h, w]}
    rows.update({f"{k}_ms": _host_ms(fn, device, iters=5) for k, fn in stages.items()})
    log("fused chunk: " + json.dumps(rows))
    if torch.device(device).type == "cuda":
        for name, fn in stages.items():
            busy = device_busy(fn, rows[f"{name}_ms"], iters=3, top=8 if "tower" in name else 0)
            log(f"device fused {name}: " + json.dumps(busy))
    del bf16


# -- phase 8 -----------------------------------------------------------------

# tier -> (environment, the engine its builds must report)
TIERS = {
    "int8": ({"IMATCH_SCORE_DTYPE": "int8"}, "tilemax"),
    "tilemax-host": ({"IMATCH_INDEX_ENGINE": "tilemax-host"}, "tilemax-host"),
}
N_TIER_UPLOADS = 4
AUTO_BUDGET = 4 << 30  # a 4 GiB device budget: a 2^20 x 768 tilemax build escalates


@contextlib.contextmanager
def environment(**values):
    """os.environ with ``values`` set, restored on leaving."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _references(store, queries, device, k=10):
    """Ids of the full fp32 brute force and of the bf16 tilemax engine over
    the store's rows, for each query."""
    import torch

    from imatch_tpu_torch.index.search import prepare_device_corpus, tilemax_topk

    n = store._n
    rows = torch.from_numpy(store._emb[:n]).to(device)
    alive = torch.from_numpy(store._alive[:n]).to(device)
    _, brute = brute_force_topk(queries, rows, alive, k)
    dc = prepare_device_corpus(rows, alive, tile_n=512, device=device)
    _, bf16 = tilemax_topk(queries, dc, k=store._k_bucket(k))
    ids = store._ids
    return (
        [[ids[i] for i in r] for r in brute[:, :k].tolist()],
        [[ids[i] for i in r] for r in bf16[:, :k].tolist()],
    )


def phase_tiers(embedder, device="cuda", store_rows=STORE_ROWS) -> dict:
    """The int8 score tier and the tilemax-host tier, each an app over
    HTTP on ``embedder`` with a store of ``store_rows`` rows; then an auto
    store that escalates. Returns the K1 and K1-int8 launch counts of each
    tier's searches. (A small config on the CPU rehearses the same control
    flow.)"""
    import shutil

    import torch

    from imatch_tpu_torch.index.store import VectorStore
    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
    from imatch_tpu_torch.ops.kernels.topk import tile_max, tile_max_int8
    from imatch_tpu_torch.pipeline.state import AppState
    from imatch_tpu_torch.serving.app import create_app

    cfg = embedder.cfg
    n_pre = store_rows - N_TIER_UPLOADS - INGEST_FOLDER  # room for the int8 tier's device ingest
    pre = _unit_rows(n_pre, cfg.projection_dim, 3, device)
    pre_ids = [f"pre_{i}" for i in range(n_pre)]
    pre_meta = [{"id": i} for i in pre_ids]
    pngs = [synthetic_png(200 + i) for i in range(N_TIER_UPLOADS)]
    counts = {}
    text_vec = None
    for tier, (env, engine) in TIERS.items():
        root = os.path.join("build", f"chip_smoke_{tier}")
        shutil.rmtree(root, ignore_errors=True)
        with environment(**env):
            state = AppState(root=root, embedder=embedder, device=device, autoload=False)
        store = state.store
        assert store.engine == engine, (store.engine, engine)
        store.add(ids=pre_ids, embeddings=pre, metadatas=pre_meta)
        store.query(pre[:1], n_results=10)  # the build: the uploads then patch it
        first_build = store.stats()["last_build"]
        port = _free_port()
        with ServerThread(create_app(state), port), recorded_queries(store) as seen:
            http = HttpClient(port)
            ids = []
            for i, png in enumerate(pngs):
                status, body, _ = http.request("POST", "/api/upload", files=[("file", f"t{i}.png", png)])
                assert status == 200 and body["success"], body
                ids.append(body["metadata"]["id"])
            _sync(device)
            tile_max.launches = 0
            tile_max_int8.launches = 0
            seen.clear()
            times, tops = {}, {}
            for name, path, fields, files in (
                ("text", "/api/search/text", [("query", TEXT_QUERY)], []),
                ("image", "/api/search/image", [], [("file", "q.png", pngs[1])]),
                (
                    "multimodal",
                    "/api/search/multimodal",
                    [("query", MULTIMODAL_QUERY), ("weight_image", "0.7")],
                    [("file", "q.png", pngs[2])],
                ),
            ):
                status, body, times[f"{name}_ms"] = http.request(
                    "POST", path, fields + [("limit", "10")], files
                )
                assert status == 200 and len(body["results"]) == 10, body
                tops[name] = [r["id"] for r in body["results"]]
            _sync(device)
            launches = {"K1": tile_max.launches, "K1_int8": tile_max_int8.launches}
        assert tops["image"][0] == ids[1], tops["image"]
        uploads_patched = store.stats()["patched_mutations"]
        queries = torch.cat([q.to(device) for q in seen])
        brute, bf16 = _references(store, queries, device)
        equal = {
            name: tops[name] == brute[j] == bf16[j]
            for j, name in enumerate(("text", "image", "multimodal"))
        }
        text_vec = queries[:1]
        wall = _host_ms(lambda: store.query(text_vec, n_results=10), device)
        # patches at full size: 64 deletes, then 64 updates (the host tier
        # cannot patch an update: it rebuilds, after the check)
        store.delete(pre_ids[:64])
        if engine != "tilemax-host":
            store.update(pre_ids[100:164], embeddings=_unit_rows(64, cfg.projection_dim, 7, device))
        patched = check_patched(store, queries, device)
        if engine == "tilemax-host":
            store.update(pre_ids[100:164], embeddings=_unit_rows(64, cfg.projection_dim, 7, device))
            patched["ids_equal_brute_force_after_rebuild"] = (
                store.query(queries, n_results=10)["ids"] == _references(store, queries, device)[0]
            )
        st = store.stats()
        patched.update({k: st[k] for k in ("patched_mutations", "rebuild_mutations")})
        row = {
            "tier": tier,
            "config": cfg.name,
            "store_rows": store.count(),
            "first_build": first_build,
            **times,
            "ids_equal_brute_force_and_bf16": equal,
            "launches": launches,
            "store_query_ms": wall,
            "uploads_patched": uploads_patched,
            "patches": patched,
        }
        if torch.device(device).type == "cuda":
            row["device_store_query"] = device_busy(
                lambda: store.query(text_vec, n_results=10), wall
            )
        log("tiers: " + json.dumps(row))
        # one int8 phase 1 a search on the card; the CPU runs plain versions
        expected = {"K1": 0, "K1_int8": 3 if torch.device(device).type == "cuda" else 0}
        # the uploads and the deletes patch; the updates patch, or rebuild once on the host tier
        want_patches = (N_TIER_UPLOADS + 1, 1) if engine == "tilemax-host" else (N_TIER_UPLOADS + 2, 0)
        if (
            first_build["engine"] != engine
            or not all(equal.values())
            or launches != expected
            or uploads_patched != N_TIER_UPLOADS
            or not patched["ok"]
            or not patched.get("ids_equal_brute_force_after_rebuild", True)
            or (patched["patched_mutations"], patched["rebuild_mutations"]) != want_patches
        ):
            raise AssertionError(f"the {tier} tier failed: {row}")
        if tier == "int8":
            # the surface phase's device-resident folder ingest, on the int8 tier
            frames = [photo_frame(9700 + i, 240, 320) for i in range(INGEST_FOLDER)]
            with ServerThread(create_app(state), port := _free_port()), call_counts(
                clip_vision=embedder.model.vision
            ) as towers:
                _sync(device)
                flash_mha.launches = 0
                ingest = device_ingest_check(state, HttpClient(port), frames, device, "i8_")
                _sync(device)
                ingest["K2"] = flash_mha.launches
            ingest["patch_check"] = check_patched(store, queries, device)
            want_k2 = cfg.vision.num_layers * towers["clip_vision"] if torch.device(device).type == "cuda" else 0
            log("tiers int8 device ingest: " + json.dumps(ingest))
            if not (
                ingest["patched"] == 1
                and ingest["rebuilt"] == 0
                and ingest["pending_after_request"] == 0
                and ingest["mirror_equals_card_rows"]
                and ingest["patch_check"]["ok"]
                and ingest["K2"] == want_k2
            ):
                raise AssertionError(f"device ingest on the int8 tier failed: {ingest}")
            launches["K2_ingest"] = ingest["K2"]
        counts[tier] = launches
        del state, store
        gc.collect()
        shutil.rmtree(root, ignore_errors=True)

    # auto: a device budget the tilemax build would outgrow
    with environment(IMATCH_INDEX_ENGINE="auto", IMATCH_DEVICE_BYTES_BUDGET=str(AUTO_BUDGET)):
        auto = VectorStore(device=device)
        auto.add(ids=pre_ids, embeddings=pre)
        got = auto.query(text_vec, n_results=10)["ids"]
    brute, _ = _references(auto, text_vec, device)
    stats = auto.stats()
    log(
        "tiers auto: "
        + json.dumps(
            {"engine": stats["engine"], "last_build": stats["last_build"], "budget": AUTO_BUDGET}
        )
    )
    if stats["last_build"]["engine"] != "tilemax-host" or got != brute:
        raise AssertionError(f"the auto store did not escalate or disagrees: {stats}")
    del auto, pre
    gc.collect()
    return counts


# -- phase 8b ----------------------------------------------------------------

MD_CONFIG = "moondream2"
MD_UPLOADS = 4
MD_FOLDER = 20  # encode and caption chunks of 16 + 4, one yes/no chunk of 20 padded to 32
MD_FILTER = "is there a red object"
MD_FILTER_AFTER_RESET = "is it daytime"
MD_MIN_COSINE = (0.999, 0.99)  # mean and minimum per-row cosine, bf16 K2 tower vs fp32 plain
MD_GATE_IMAGES = 100  # the back-fill the searches run beside
MD_GATE_FILTER = "is there a tree"
MD_GATE_SEARCHES = 8
MD_GATE_STAGGER_S = 0.15  # the searches' start times, apart


def synthetic_gpt2_vocab(directory: str, vocab_size: int, eos_id: int):
    """A GPT-2-layout vocab.json and merges.txt for a model of
    ``vocab_size`` ids: the 256 byte tokens, ``<|endoftext|>`` at
    ``eos_id``, and every other id a merged lowercase token of 2-4 letters,
    so that every id a random-weight model emits decodes to text (the byte
    fallback drops ids above 257). Returns the two paths."""
    import itertools
    import string

    from imatch_tpu_torch.ops.tokenizer import bytes_to_unicode

    b2u = bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    vocab["<|endoftext|>"] = eos_id
    free = [i for i in range(256, vocab_size) if i != eos_id]
    letters = string.ascii_lowercase
    words = itertools.chain.from_iterable(
        itertools.product(letters, repeat=n) for n in (2, 3, 4)
    )
    merges = []
    for i, word in zip(free, words):
        merges.append(("".join(word[:-1]), word[-1]))
        vocab["".join(word)] = i
    os.makedirs(directory, exist_ok=True)
    paths = (os.path.join(directory, "vocab.json"), os.path.join(directory, "merges.txt"))
    with open(paths[0], "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(paths[1], "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return paths


@contextlib.contextmanager
def plain_attention():
    """The encoder towers' attention through K2's plain version (the
    reference side of a check), restored on leaving."""
    from imatch_tpu_torch.models.clip import model as clip_model
    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha_plain

    mha = clip_model.mha
    clip_model.mha = lambda q, k, v, *, causal=False: flash_mha_plain(q, k, v, causal=causal)
    try:
        yield
    finally:
        clip_model.mha = mha


@contextlib.contextmanager
def call_counts(**modules):
    """Forward calls of each named module, counted for a ``with`` block."""
    counts = dict.fromkeys(modules, 0)
    handles = []
    for name, mod in modules.items():

        def hook(_mod, _args, name=name):
            counts[name] += 1

        handles.append(mod.register_forward_pre_hook(hook))
    try:
        yield counts
    finally:
        for h in handles:
            h.remove()


def _timed(fn, device, iters: int = 3):
    """(result, mean host ms of ``iters`` warm calls ending in a sync)."""
    out = fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3 / iters


def md_tower_check(svc, frame, device) -> dict:
    """The served tower (K2, compute dtype) against the same seed's
    weights in fp32 with the plain attention, on the same device, at B=1:
    per-row cosine of the (P, D) features."""
    import numpy as np
    import torch

    from imatch_tpu_torch.models.moondream.model import encode_image_features, init_random
    from imatch_tpu_torch.models.moondream.runtime import SEED

    pixels = svc._preprocess(frame)
    got = encode_image_features(svc.model, pixels)[0].float().cpu().numpy()
    ref_model = init_random(svc.cfg, seed=SEED, device=device, dtype=torch.float32)
    with plain_attention():
        want = encode_image_features(ref_model, pixels)[0].cpu().numpy()
    del ref_model
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    assert got.shape == want.shape == (svc.cfg.vision.num_patches, svc.cfg.text.hidden_size)
    assert np.isfinite(got).all()
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    return {"mean_cosine": float(cos.mean()), "min_cosine": float(cos.min()), "shape": list(got.shape)}


def md_decode_check(svc, encoded) -> dict:
    """Cache-free against cached prefill logits, and segmented against
    monolithic greedy decode, at the caption prompt."""
    import torch

    from imatch_tpu_torch.models.moondream.generate import prefill
    from imatch_tpu_torch.models.moondream.runtime import CAPTION_PROMPT

    feats = svc._feats(encoded)
    tokens = svc._tokens(svc._prompt_id_list(CAPTION_PROMPT, max_new=48), 1)
    cached, _, pos = prefill(svc.model, feats, tokens, max_new=48)
    free, _, pos_free = prefill(svc.model, feats, tokens, use_cache=False)
    diff = float((cached - free).abs().max())
    mono = svc._generate(feats, tokens, 48)
    seg = svc._generate_segmented(feats, tokens, 48, 8)
    out = {
        "prompt_len": pos,
        "prefill_cached_vs_free_max_abs": diff,
        "prefill_logit_scale": float(free.abs().max()),
        "same_argmax": bool(torch.equal(cached.argmax(-1), free.argmax(-1))),
        "segmented_equals_monolithic": bool(
            torch.equal(mono.tokens, seg.tokens) and torch.equal(mono.lengths, seg.lengths)
        ),
        "caption_length": int(mono.lengths[0]),
    }
    if pos != pos_free or not out["same_argmax"] or diff > 1e-3 * out["prefill_logit_scale"]:
        raise AssertionError(f"cache-free and cached prefill disagree: {out}")
    if not out["segmented_equals_monolithic"]:
        raise AssertionError(f"segmented decode differs from one loop: {out}")
    return out


def md_stage_times(svc, frames, device) -> dict:
    """Each stage alone, warm, host ms of calls that end on the host."""
    from imatch_tpu_torch.models.moondream.generate import greedy_generate, prefill
    from imatch_tpu_torch.models.moondream.runtime import CAPTION_PROMPT

    t = {}
    enc, t["encode_b1_ms"] = _timed(lambda: svc.encode_image(frames[0]), device)
    encs, t["encode_b16_ms"] = _timed(lambda: svc.encode_image_batch(frames[:16]), device, 2)
    feats = svc._feats(enc)
    tokens = svc._tokens(svc._prompt_id_list(CAPTION_PROMPT, max_new=48), 1)
    _, t["caption_prefill_b1_ms"] = _timed(lambda: prefill(svc.model, feats, tokens, max_new=48), device)
    state = {}

    def decode():
        logits, cache, pos = prefill(svc.model, feats, tokens, max_new=48)
        _sync(device)
        t0 = time.perf_counter()
        result = greedy_generate(svc.model, logits, cache, pos, max_new=48)
        result.tokens.cpu()
        state["ms"] = (time.perf_counter() - t0) * 1e3
        state["steps"] = int((result.lengths.max()))

    decode()
    decode()
    t["caption_decode_b1_ms"] = state["ms"]
    t["caption_decode_steps"] = state["steps"] - 1  # the first token comes from the prefill
    t["caption_decode_ms_per_step"] = state["ms"] / max(1, state["steps"] - 1)
    _, t["caption_b1_ms"] = _timed(lambda: svc.caption(enc), device)
    q = "Yes or No: " + MD_FILTER
    _, t["yes_no_b1_ms"] = _timed(lambda: svc.query(enc, q), device)
    batch64 = (encs * 4)[:64]
    _, t["yes_no_b64_ms"] = _timed(lambda: svc.query_yes_no_batch(batch64, q), device, 2)
    _, t["caption_b16_ms"] = _timed(lambda: svc.caption_batch(encs[:16]), device, 1)
    return t


def gate_reading(state, http, device) -> dict:
    """Text searches during a filter back-fill over ``MD_GATE_IMAGES``
    images (the store's images and records added with copies of a cached
    encoding), against the same searches with the card idle: 8 threads
    started ``MD_GATE_STAGGER_S`` apart, each a new text. The back-fill's
    yes/no chunks park at GATE.checkpoint() while a search's store query
    runs, so a search waits for at most the chunk already on the card. A
    reading, not a bar."""
    from imatch_tpu_torch.pipeline.captioner import load_encoded, save_encoded

    store = state.store
    have = list(state.image_metadata)
    enc = load_encoded(state.encoded_dir, have[0])
    extra = [f"img_gate{i:03d}" for i in range(MD_GATE_IMAGES - len(have))]
    mds = [{"id": i, "filename": f"{i}.png", "description": i, "custom_metadata": ""} for i in extra]
    with state.lock:
        store.add(extra, _unit_rows(len(extra), store.dim, 11, device), metadatas=mds)
        for md in mds:
            state.image_metadata[md["id"]] = md
    for i in extra:
        save_encoded(state.encoded_dir, i, enc)
    progress = state.filter_progress

    def searches(tag):
        return staggered_searches(
            http,
            tag,
            MD_GATE_SEARCHES,
            MD_GATE_STAGGER_S,
            lambda: progress.get(MD_GATE_FILTER, {}).get("status") == "processing",
        )

    idle_ms, _ = searches("idle")
    t = time.perf_counter()
    status, body, _ = http.request("POST", "/api/filters", [("filter_query", MD_GATE_FILTER)])
    assert status == 200, body
    during_ms, during_busy = searches("busy")
    while progress.get(MD_GATE_FILTER, {}).get("status") not in ("completed", "error"):
        if time.perf_counter() - t > 300:
            raise AssertionError(f"the gate back-fill did not finish: {progress.get(MD_GATE_FILTER)}")
        time.sleep(0.01)
    backfill_ms = (time.perf_counter() - t) * 1e3
    final = progress[MD_GATE_FILTER]
    assert final["status"] == "completed" and final["total"] == MD_GATE_IMAGES, final
    status, body, _ = http.request("DELETE", "/api/filters/" + MD_GATE_FILTER.replace(" ", "%20"))
    assert status == 200 and MD_GATE_FILTER not in body["filters"], body
    return {
        "images": MD_GATE_IMAGES,
        "backfill_ms": backfill_ms,
        "idle_search_ms": idle_ms,
        "search_ms_during_backfill": during_ms,
        "started_while_backfilling": during_busy,
        "p50_idle_ms": _p50(idle_ms),
        "p50_during_ms": _p50([m for m, b in zip(during_ms, during_busy) if b] or during_ms),
    }


def phase_moondream(embedder, device="cuda", config=MD_CONFIG) -> dict:
    """The Moondream captioner and the yes/no filter system at ``config``
    (full width and depth, seeded random weights, bf16 on the card): the
    tower against fp32 with the plain attention, the decode checks, each
    stage timed, then the app over HTTP (IMATCH_CAPTIONER=moondream) with
    ``embedder`` as its CLIP: uploads with captions, a filter back-filled to
    100, filtered searches, an upload and a folder after it, DELETE, reset
    and a restart. Returns the K2 launches of the HTTP requests. (tiny-md
    and a small CLIP on the CPU rehearse the same control flow.)"""
    import shutil

    import numpy as np
    import torch

    from PIL import Image

    from imatch_tpu_torch.models.moondream.configs import get_md_config
    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
    from imatch_tpu_torch.pipeline.captioner import load_encoded
    from imatch_tpu_torch.pipeline.search import enhance_query_with_caption
    from imatch_tpu_torch.pipeline.state import AppState
    from imatch_tpu_torch.serving.app import create_app

    root = os.path.join("build", "chip_smoke_md")
    shutil.rmtree(root, ignore_errors=True)
    cfg = get_md_config(config)
    vocab, merges = synthetic_gpt2_vocab(
        os.path.join(root, "vocab"), cfg.text.vocab_size, cfg.text.eos_token_id
    )
    env = dict(
        IMATCH_CAPTIONER="moondream", IMATCH_MD_CONFIG=config,
        IMATCH_MD_VOCAB=vocab, IMATCH_MD_MERGES=merges,
    )
    t0 = time.perf_counter()
    with environment(**env):
        state = AppState(root=root, embedder=embedder, device=device)
    svc = state.captioner
    assert type(svc).__name__ == "MoondreamTorch" and svc.cfg.name == config, svc
    n_params = sum(p.numel() for p in svc.model.parameters())
    log(
        f"moondream: {config} ({n_params} parameters, {svc.dtype}) and {embedder.cfg.name} "
        f"app ready in {time.perf_counter() - t0:.1f} s"
    )
    frames = [photo_frame(7000 + i, 240, 320) for i in range(MD_UPLOADS + 1 + MD_FOLDER)]
    tower = md_tower_check(svc, frames[0], device)
    log("moondream tower: " + json.dumps(tower))
    if tower["mean_cosine"] < MD_MIN_COSINE[0] or tower["min_cosine"] < MD_MIN_COSINE[1]:
        raise AssertionError(f"the bf16 K2 tower strays from the fp32 plain tower: {tower}")
    decode = md_decode_check(svc, svc.encode_image(frames[0]))
    log("moondream decode: " + json.dumps(decode))
    stages = md_stage_times(svc, frames[MD_UPLOADS + 1 :], device)
    log("moondream stages: " + json.dumps(stages))

    pngs = [_png_bytes(f) for f in frames]
    port = _free_port()
    times = {}
    counts_of = dict(md_vision=svc.model.vision, clip_vision=embedder.model.vision, clip_text=embedder.model.text)
    with ServerThread(create_app(state), port), call_counts(**counts_of) as calls:
        http = HttpClient(port)
        _sync(device)
        flash_mha.launches = 0
        ids = []
        for i in range(MD_UPLOADS):
            status, body, ms = http.request("POST", "/api/upload", files=[("file", f"m{i}.png", pngs[i])])
            assert status == 200 and body["success"], body
            md = body["metadata"]
            assert md["custom_metadata"].strip(), f"upload {i} got no caption: {md}"
            assert load_encoded(state.encoded_dir, md["id"])["features"].shape == (
                cfg.vision.num_patches, cfg.text.hidden_size,
            ), md
            ids.append(md["id"])
            times.setdefault("upload_with_caption_ms", []).append(ms)
        status, body, _ = http.request("POST", "/api/filters", [("filter_query", MD_FILTER)])
        assert status == 200 and body == {"success": True, "filters": [MD_FILTER]}, body
        t = time.perf_counter()
        while True:
            status, prog, _ = http.request("GET", "/api/filter-progress?filter_query=" + MD_FILTER.replace(" ", "%20"))
            if prog.get("status") in ("completed", "error"):
                break
            if time.perf_counter() - t > 300:
                raise AssertionError(f"the back-fill did not finish: {prog}")
            time.sleep(0.01)
        times["backfill_ms"] = (time.perf_counter() - t) * 1e3
        want = {"status": "completed", "progress": 100, "processed": MD_UPLOADS, "total": MD_UPLOADS}
        assert prog == want, prog
        status, body, _ = http.request("GET", "/api/images")
        answers = {m["id"]: json.loads(m["filter_results_json"])[MD_FILTER] for m in body["images"]}
        assert sorted(answers) == sorted(ids) and set(answers.values()) <= {"Yes", "No"}, answers
        yes = sorted(i for i, a in answers.items() if a == "Yes")
        status, body, times["filtered_search_ms"] = http.request(
            "POST", "/api/search/text", [("query", ""), ("filters", MD_FILTER), ("limit", "100")]
        )
        assert status == 200 and sorted(r["id"] for r in body["results"]) == yes, (body, yes)
        status, body, times["filtered_text_search_ms"] = http.request(
            "POST", "/api/search/text", [("query", TEXT_QUERY), ("filters", MD_FILTER), ("limit", "100")]
        )
        assert status == 200 and sorted(r["id"] for r in body["results"]) == yes, (body, yes)
        status, body, times["upload_after_filter_ms"] = http.request(
            "POST", "/api/upload", files=[("file", "late.png", pngs[MD_UPLOADS])]
        )
        assert status == 200 and body["metadata"]["custom_metadata"].strip(), body
        late = json.loads(body["metadata"]["filter_results_json"])
        assert set(late) == {MD_FILTER} and late[MD_FILTER] in ("Yes", "No"), late
        folder = [("files", f"f{i}.png", pngs[MD_UPLOADS + 1 + i]) for i in range(MD_FOLDER)]
        status, body, times["folder_ms"] = http.request("POST", "/api/upload-folder", files=folder)
        assert status == 200 and body["successful"] == MD_FOLDER, body
        status, body, _ = http.request("GET", "/api/images")
        assert len(body["images"]) == MD_UPLOADS + 1 + MD_FOLDER, body
        for m in body["images"]:
            assert m["custom_metadata"].strip(), f"no caption: {m}"
            assert json.loads(m["filter_results_json"])[MD_FILTER] in ("Yes", "No"), m
        _sync(device)
        launches = {"K2": flash_mha.launches}
        counted = dict(calls)
        gate = gate_reading(state, http, device)
        log("moondream gate: " + json.dumps(gate))
        # /search's caption enhancement: the query image's caption extends
        # the text, and the results are /api/search/multimodal's on it
        query_png = [("file", "q.png", pngs[0])]
        status, body, times["search_enhanced_ms"] = http.request(
            "POST", "/search", [("query", TEXT_QUERY), ("enhance_with_caption", "true"), ("limit", "10")], query_png
        )
        assert status == 200 and body["mode"] == "multimodal", body
        extended = enhance_query_with_caption(state, Image.open(io.BytesIO(pngs[0])), TEXT_QUERY)
        assert extended.startswith(TEXT_QUERY + ". ") and len(extended) > len(TEXT_QUERY) + 2, extended
        status, want_enh, _ = http.request(
            "POST", "/api/search/multimodal", [("query", extended), ("limit", "10")], query_png
        )
        assert [r["id"] for r in body["results"]] == [r["id"] for r in want_enh["results"]], (body, want_enh)
        times["enhanced_query_chars"] = len(extended)
        status, body, _ = http.request("DELETE", "/api/filters/" + MD_FILTER.replace(" ", "%20"))
        assert status == 200 and body == {"success": True, "filters": []}, body
        status, body, _ = http.request("DELETE", "/api/filters/" + MD_FILTER.replace(" ", "%20"))
        assert status == 404, body
        status, body, times["reset_ms"] = http.request("POST", "/api/reset")
        assert status == 200 and body == {"success": True}, body
        status, body, _ = http.request("GET", "/api/filters")
        assert body == {"filters": []}, body
        status, body, _ = http.request("POST", "/api/filters", [("filter_query", MD_FILTER_AFTER_RESET)])
        assert status == 200, body
        status, health, _ = http.request("GET", "/api/health")
        assert health["images"] == 0 and health["captioner"] is True, health

    # a restart on the same directory: the saved filter is there
    restarted = AppState(root=root, embedder=embedder, captioner=svc, device=device)
    with ServerThread(create_app(restarted), port := _free_port()):
        http = HttpClient(port)
        status, body, _ = http.request("GET", "/api/filters")
        assert body == {"filters": [MD_FILTER_AFTER_RESET]}, body
        status, health, _ = http.request("GET", "/api/health")
        assert health["images"] == 0 and health["captioner"] is True, health

    # encodes: each upload and the late one, the folder's chunks of 16 + 4
    md_encodes = MD_UPLOADS + 1 + -(-MD_FOLDER // 16)
    expected_calls = {"md_vision": md_encodes}
    expected = {
        "K2": cfg.vision.num_layers * md_encodes
        + embedder.cfg.vision.num_layers * counted["clip_vision"]
        + embedder.cfg.text.num_layers * counted["clip_text"]
    }
    if torch.device(device).type != "cuda":  # the CPU runs the plain versions
        expected = {"K2": 0}
    log(
        "moondream slice: "
        + json.dumps(
            {
                "config": config,
                "clip": embedder.cfg.name,
                **times,
                "filter_answers": answers,
                "tower_calls": counted,
                "launches": launches,
                "expected_launches": expected,
            }
        )
    )
    del state, restarted
    gc.collect()
    shutil.rmtree(root, ignore_errors=True)
    if counted["md_vision"] != expected_calls["md_vision"]:
        raise AssertionError(f"Moondream encodes {counted} != what the requests imply {expected_calls}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != what the requests imply {expected}")
    return {"launches": launches["K2"], "tower": tower, "decode": decode, "stages": stages, "http": times}


# -- phase 8c ----------------------------------------------------------------

U2_CONFIG = "u2net"
U2_FOLDER = ((12, 240, 320), (8, 200, 300))  # forwards of 8 + 4, and of 8
U2_QUERIES = 3  # frames of /api/search/image-batch
# bf16 against fp32 alpha on the card, in uint8 levels: the largest
# difference and the mean over the frame, pinned at about twice and eight
# times the first reading at u2net (27 and 0.0126 levels; PERF.md section 5)
U2_BF16_ALPHA_BOUND = (64, 0.1)


def _u2_frames(n, h, w, seed):
    """``n`` photo-like frames whose pHash margin clears 32, so that the
    device hash of their geometry bucket is PIL's (``_phash_margin``)."""
    out = []
    while len(out) < n:
        frame = photo_frame(seed, h, w)
        if _phash_margin(frame) > 32.0:
            out.append(frame)
        seed += 1
    return out


def u2_mask_check(config, device):
    """One 240x320 frame's alpha: the fp32 module on the card against the
    same seed's fp32 module on the CPU (within 1 level), and the served
    bf16 module against the fp32 one on the card (within
    ``U2_BF16_ALPHA_BOUND``); the saliency's range on the frame beside
    them (the min-max normalisation divides by it). Returns the readings,
    the served segmenter and the frame."""
    import numpy as np
    import torch

    from imatch_tpu_torch.models.u2net.bridge import init_random
    from imatch_tpu_torch.models.u2net.runtime import SEED, U2NetSegmenter

    frame = photo_frame(9100, 240, 320)
    served = U2NetSegmenter(config=config, device=device)
    fp32 = U2NetSegmenter(config=config, device=device)
    fp32.model = init_random(fp32.cfg, seed=SEED, device=device, dtype=torch.float32)
    cpu = U2NetSegmenter(config=config, device="cpu")
    a16, a32, a_cpu = (s.remove_background(frame)[..., 3].astype(int) for s in (served, fp32, cpu))
    with torch.no_grad():
        sal = fp32.model(fp32._model_inputs_batch([frame]))
    out = {
        "config": config,
        "served_dtype": str(served.dtype).replace("torch.", ""),
        "saliency_range": float(sal.max() - sal.min()),
        "fp32_card_vs_cpu_max_levels": int(np.abs(a32 - a_cpu).max()),
        "fp32_card_vs_cpu_differing": float((a32 != a_cpu).mean()),
        "bf16_vs_fp32_max_levels": int(np.abs(a16 - a32).max()),
        "bf16_vs_fp32_mean_levels": float(np.abs(a16 - a32).mean()),
        "bf16_vs_fp32_differing": float((a16 != a32).mean()),
    }
    del fp32, cpu
    gc.collect()
    if out["fp32_card_vs_cpu_max_levels"] > 1:
        raise AssertionError(f"the fp32 U2-Net on the card strays from the CPU's: {out}")
    if out["bf16_vs_fp32_max_levels"] > U2_BF16_ALPHA_BOUND[0] or out["bf16_vs_fp32_mean_levels"] > U2_BF16_ALPHA_BOUND[1]:
        raise AssertionError(f"the bf16 U2-Net strays from the fp32 one: {out}")
    return out, served, frame


@contextlib.contextmanager
def counted_cutouts(seg):
    """Successful ``remove_background`` and ``remove_background_batch``
    calls of ``seg`` (frames each), and its forwards' batch sizes, in a
    ``with`` block."""
    out = {"single": 0, "batch_frames": [], "forwards": []}
    single, batch = seg.remove_background, seg.remove_background_batch

    def counting_single(image):
        r = single(image)
        out["single"] += 1
        return r

    def counting_batch(images):
        r = batch(images)
        out["batch_frames"].append(len(r))
        return r

    hook = seg.model.register_forward_pre_hook(lambda _m, args: out["forwards"].append(int(args[0].shape[0])))
    seg.remove_background, seg.remove_background_batch = counting_single, counting_batch
    try:
        yield out
    finally:
        hook.remove()
        del seg.remove_background, seg.remove_background_batch


def phase_u2net(embedder, device="cuda", config=U2_CONFIG) -> dict:
    """U2-Net background removal at ``config`` (seeded random weights, bf16
    on the card): the mask checks, ``predict_mask`` and an 8-frame
    ``remove_background_batch`` chunk timed, then the app over HTTP with
    IMATCH_SEGMENTER=u2net and ``embedder`` as its CLIP: /api/upload and
    /api/upload-folder with remove_bg (RGBA files, the folder's forwards a
    geometry chunk, host pHash ids), and /api/search/image,
    /api/search/multimodal and /api/search/image-batch with remove_bg
    against the same searches on the cutouts' RGB. Every cutout must have
    succeeded (the routes log a failure and keep the frame). Returns the K1
    and K2 launches of the requests. (tiny-u2 and a small CLIP on the CPU
    rehearse the same control flow.)"""
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
    from imatch_tpu_torch.ops.kernels.topk import tile_max
    from imatch_tpu_torch.ops.phash import image_id
    from imatch_tpu_torch.pipeline.state import AppState
    from imatch_tpu_torch.serving.app import create_app
    from imatch_tpu_torch.utils.batching import pow2_bucket

    t0 = time.perf_counter()
    masks, seg, frame = u2_mask_check(config, device)
    log("u2net masks: " + json.dumps(masks))
    chunk = _u2_frames(8, 240, 320, 9200)
    times = {}
    _, times["predict_mask_b1_ms"] = _timed(lambda: seg.predict_mask(frame), device)
    with counted_cutouts(seg) as c:
        _, times["remove_background_batch_b8_ms"] = _timed(lambda: seg.remove_background_batch(chunk), device)
    assert c["forwards"] == [8] * len(c["batch_frames"]), c  # one forward a chunk, each call
    del seg
    gc.collect()

    root = os.path.join("build", "chip_smoke_u2")
    shutil.rmtree(root, ignore_errors=True)
    with environment(IMATCH_SEGMENTER="u2net", IMATCH_U2_CONFIG=config, IMATCH_CAPTIONER="null"):
        state = AppState(root=root, embedder=embedder, device=device, autoload=False)
    seg = state.segmenter
    assert type(seg).__name__ == "U2NetSegmenter" and seg.cfg.name == config, seg
    assert seg.dtype == (torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32)
    log(f"u2net: {config} segmenter and {embedder.cfg.name} app ready in {time.perf_counter() - t0:.1f} s")
    folder = [f for n, h, w in U2_FOLDER for f in _u2_frames(n, h, w, 9300 + h)]
    files = [("files", f"c{i}.png", _png_bytes(f)) for i, f in enumerate(folder)]
    host_ids = [image_id(Image.fromarray(f)) for f in folder]
    upload = photo_frame(9400, 240, 320)
    queries = [photo_frame(9500 + i, 200 + 20 * i, 260) for i in range(U2_QUERIES)]
    q_png = [("file", "q.png", _png_bytes(queries[0]))]
    counts_of = dict(clip_vision=embedder.model.vision, clip_text=embedder.model.text)
    with ServerThread(create_app(state), port := _free_port()), call_counts(**counts_of) as towers, \
            engine_calls(state.store) as calls, counted_cutouts(seg) as cut:
        http = HttpClient(port)
        _sync(device)
        flash_mha.launches = tile_max.launches = tile_max.mma_launches = 0
        status, body, times["upload_remove_bg_ms"] = http.request(
            "POST", "/api/upload", [("remove_bg", "true")], [("file", "u.png", _png_bytes(upload))]
        )
        assert status == 200 and body["success"], body
        saved = np.asarray(Image.open(body["metadata"]["processed_url"]))
        assert saved.shape == (240, 320, 4), saved.shape  # an RGBA cutout
        status, body, times["folder_remove_bg_ms"] = http.request(
            "POST", "/api/upload-folder", [("remove_bg", "true")], files
        )
        assert status == 200 and body["successful"] == len(folder), body
        assert [r["id"] for r in body["results"]] == host_ids, body
        for r in body["results"]:
            f = np.asarray(Image.open(state.image_metadata[r["id"]]["processed_url"]))
            assert f.ndim == 3 and f.shape[-1] == 4, (r, f.shape)
        results = {}
        for route, fields in (
            ("/api/search/image", [("limit", "10")]),
            ("/api/search/multimodal", [("query", TEXT_QUERY), ("limit", "10")]),
        ):
            status, bg, times[f"{route.split('/')[-1]}_remove_bg_ms"] = http.request(
                "POST", route, fields + [("remove_bg", "true")], q_png
            )
            assert status == 200 and bg["results"], bg
            results[route] = bg["results"]
        frames_png = [("files", f"q{i}.png", _png_bytes(q)) for i, q in enumerate(queries)]
        status, bg, times["image_batch_remove_bg_ms"] = http.request(
            "POST", "/api/search/image-batch", [("limit", "10"), ("remove_bg", "true")], frames_png
        )
        assert status == 200 and len(bg["results"]) == U2_QUERIES, bg
        results["/api/search/image-batch"] = bg["results"]
        _sync(device)
        launches = {
            "K1": tile_max.launches - tile_max.mma_launches,
            "K1_mma": tile_max.mma_launches,
            "K2": flash_mha.launches,
        }
        tower_calls, engine_qs, cutouts = dict(towers), list(calls), json.loads(json.dumps(cut))
        # the same searches on the cutouts' RGB, as a client would send them
        cut_png = [("file", "qc.png", _png_bytes(seg.remove_background(queries[0])[..., :3]))]
        for route, fields in (
            ("/api/search/image", [("limit", "10")]),
            ("/api/search/multimodal", [("query", TEXT_QUERY), ("limit", "10")]),
        ):
            status, plain, _ = http.request("POST", route, fields, cut_png)
            assert [r["id"] for r in plain["results"]] == [r["id"] for r in results[route]], (route, plain)
        cut_frames = [
            ("files", f"qc{i}.png", _png_bytes(seg.remove_background(q)[..., :3])) for i, q in enumerate(queries)
        ]
        status, plain, _ = http.request("POST", "/api/search/image-batch", [("limit", "10")], cut_frames)
        assert [[r["id"] for r in row] for row in plain["results"]] == [
            [r["id"] for r in row] for row in results["/api/search/image-batch"]
        ], plain
        status, metrics, _ = http.request("GET", "/api/metrics")
    alpha = seg.remove_background(upload)[..., 3].astype(int)
    upload_alpha_levels = int(np.abs(saved[..., 3].astype(int) - alpha).max())
    timers = set(metrics["timings"])
    del state
    gc.collect()
    shutil.rmtree(root, ignore_errors=True)
    chunk_n = int(os.environ.get("IMATCH_U2_CHUNK", "8"))
    want_forwards = [pow2_bucket(min(chunk_n, n - s), chunk_n) for n, _, _ in U2_FOLDER for s in range(0, n, chunk_n)]
    want_cutouts = {"single": 1 + 2 + U2_QUERIES, "batch_frames": [len(folder)], "forwards": [1] + want_forwards + [1] * (2 + U2_QUERIES)}
    nv, nt = embedder.cfg.vision.num_layers, embedder.cfg.text.num_layers
    expected = {
        "K1": sum(q == 1 for q in engine_qs),
        "K1_mma": sum(q >= 2 for q in engine_qs),
        "K2": nv * tower_calls["clip_vision"] + nt * tower_calls["clip_text"],
    }
    if torch.device(device).type != "cuda":  # the CPU runs the plain versions
        expected = dict.fromkeys(expected, 0)
    out = {
        "config": config,
        "clip": embedder.cfg.name,
        **times,
        "upload_alpha_vs_segmenter_max_levels": upload_alpha_levels,
        "cutouts": cutouts,
        "expected_cutouts": want_cutouts,
        "tower_calls": tower_calls,
        "engine_queries": engine_qs,
        "launches": launches,
        "expected_launches": expected,
    }
    log("u2net slice: " + json.dumps(out))
    if cutouts != want_cutouts:
        raise AssertionError(f"cutouts {cutouts} != what the requests imply {want_cutouts}")
    if upload_alpha_levels > 1:
        raise AssertionError(f"the uploaded cutout's alpha is not the segmenter's: {upload_alpha_levels}")
    if not {"segment", "ingest.segment"} <= timers:
        raise AssertionError(f"no segment timers in /api/metrics: {sorted(timers)}")
    if launches != expected or not launches["K2"] and torch.device(device).type == "cuda":
        raise AssertionError(f"launch counts {launches} != what the requests imply {expected}")
    return {"launches": launches, "masks": masks, "http": times}


# -- phase 8d ----------------------------------------------------------------

MD_INT8_MODES = {  # mode -> its environment, cumulative as the runtime composes them
    "int8_weights": {"IMATCH_MD_QUANT": "int8"},
    "int8_cache": {"IMATCH_MD_QUANT": "int8", "IMATCH_MD_CACHE": "int8"},
    "w8a8": {"IMATCH_MD_QUANT": "int8", "IMATCH_MD_CACHE": "int8", "IMATCH_MD_ACT": "int8"},
}
MD_VQA_CHUNK = 64
# cosine bars: tests/test_moondream.py:224 (int8 weights against bf16 weights),
# :359 (the first decode step through the int8 cache) and :489 (W8A8
# against weight-only int8)
MD_INT8_COSINE = {"int8_weights": 0.999, "int8_cache": 0.999, "w8a8": 0.99}
MD_W8A8_YES_NO_AGREE = 0.9  # of the 64 answers, against weight-only int8's


def _row_cosines(a, b):
    import torch

    a, b = a.double(), b.double()
    return ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).cpu()


def md_mode_times(svc, feats1, tokens1, feats16, tokens16, batch64, device) -> dict:
    """A mode's stages, warm, host ms of calls that end on the host: the
    caption prefill at B = 1 and 16 (the cache built), one decode step (the
    mean of a 48-token greedy decode), the yes/no chunk of 64."""
    from imatch_tpu_torch.models.moondream.generate import greedy_generate

    t = {}
    _, t["prefill_b1_ms"] = _timed(lambda: svc._prefill(feats1, tokens1, 48), device)
    _, t["prefill_b16_ms"] = _timed(lambda: svc._prefill(feats16, tokens16, 48), device, 2)
    state = {}

    def decode():
        logits, cache, pos = svc._prefill(feats1, tokens1, 48)
        _sync(device)
        t0 = time.perf_counter()
        result = greedy_generate(svc.model, logits, cache, pos, max_new=48)
        result.tokens.cpu()
        state["ms"] = (time.perf_counter() - t0) * 1e3
        state["steps"] = int(result.lengths.max()) - 1  # the first token comes from the prefill

    decode()
    decode()
    t["decode_step_ms"] = state["ms"] / max(1, state["steps"])
    t["decode_steps"] = state["steps"]
    q = "Yes or No: " + MD_FILTER
    _, t["yes_no_b64_ms"] = _timed(lambda: svc.query_yes_no_batch(batch64, q), device, 2)
    return t


def phase_md_int8(device="cuda", config=MD_CONFIG) -> dict:
    """The int8 Moondream modes at ``config`` (full width and depth, the
    seeded random weights of phase 8b, bf16 compute), each built from its
    environment beside a bf16 service: int8 weights (prefill logits
    cosine against bf16, greedy caption tokens), + the int8 cache (the
    first decode step's cosine against the bf16 cache, segmented equal to
    monolithic decode), + the W8A8 prefill (cosine against weight-only
    int8, cache-free equal to cache-building, a 64-image yes/no chunk
    against weight-only int8's answers), each mode's caption and yes/no
    served, each stage timed. The W8A8 service's caption and yes/no chunk
    are its main path: their K3 and K4 launches are held to 2 and 1 a
    layer a prefill. Returns the launches and the readings. (tiny-md on the
    CPU rehearses the same control flow.)"""
    import shutil

    import torch

    from imatch_tpu_torch.models.moondream.configs import get_md_config
    from imatch_tpu_torch.models.moondream.generate import prefill
    from imatch_tpu_torch.models.moondream.model import Int8Linear, decoder_forward, embed_tokens, lm_logits
    from imatch_tpu_torch.models.moondream.runtime import CAPTION_PROMPT, MoondreamTorch
    from imatch_tpu_torch.ops.kernels.quantize import ln_quant_rows, quant_rows

    root = os.path.join("build", "chip_smoke_md_int8")
    shutil.rmtree(root, ignore_errors=True)
    cfg = get_md_config(config)
    vocab, merges = synthetic_gpt2_vocab(os.path.join(root, "vocab"), cfg.text.vocab_size, cfg.text.eos_token_id)
    base = dict(IMATCH_MD_CONFIG=config, IMATCH_MD_VOCAB=vocab, IMATCH_MD_MERGES=merges)
    t0 = time.perf_counter()
    with environment(**base):
        ref = MoondreamTorch(device=device)
    encs = ref.encode_image_batch([photo_frame(9600 + i, 240, 320) for i in range(16)])
    ids = ref._prompt_id_list(CAPTION_PROMPT, max_new=48)
    feats1, tokens1 = ref._feats(encs[0]), ref._tokens(ids, 1)
    feats16, tokens16 = ref._batched_feats(encs, 16), ref._tokens(ids, 16)
    batch64 = (encs * 4)[:MD_VQA_CHUNK]
    question = "Yes or No: " + MD_FILTER
    times = {"bf16": md_mode_times(ref, feats1, tokens1, feats16, tokens16, batch64, device)}
    l_bf16, _, pos = prefill(ref.model, feats16, tokens16, max_new=48)
    tokens_bf16 = ref._generate(feats1, tokens1, 48).tokens
    del ref
    gc.collect()
    readings = {"prompt_len": pos, "rows_b1": pos, "rows_b16": 16 * pos}
    svcs = {}
    for mode, env in MD_INT8_MODES.items():
        with environment(**base, **env):
            svcs[mode] = svc = MoondreamTorch(device=device)
        assert isinstance(svc.model.text.lm_head, Int8Linear) and svc.model.text.lm_head.q.dtype == torch.int8
        assert svc.act_quant == (mode == "w8a8") and (svc.cache_dtype is not None) == (mode != "int8_weights")
        times[mode] = md_mode_times(svc, feats1, tokens1, feats16, tokens16, batch64, device)
    log(f"moondream int8: {config} in 3 modes and bf16, built and timed in {time.perf_counter() - t0:.1f} s")

    w8, c8, a8 = svcs["int8_weights"], svcs["int8_cache"], svcs["w8a8"]
    # int8 weights against bf16 weights: the same inputs' prefill logits
    l_w8, _, _ = prefill(w8.model, feats16, tokens16, max_new=48)
    readings["int8_weights_min_cosine"] = float(_row_cosines(l_w8, l_bf16).min())
    tok_w8 = w8._generate(feats1, tokens1, 48).tokens
    readings["int8_weights_caption_tokens_equal_bf16"] = int((tok_w8 == tokens_bf16).cumprod(-1).sum())
    # the int8 cache against the bf16 cache, on the int8 weights: the first
    # decode step
    logits, cache_bf, pos = prefill(c8.model, feats16, tokens16, max_new=48)
    _, cache_i8, _ = prefill(c8.model, feats16, tokens16, max_new=48, cache_dtype=torch.int8)
    assert cache_i8.k.dtype == torch.int8 and cache_i8.ks is not None
    emb = embed_tokens(c8.model, torch.argmax(logits, dim=-1)[:, None])
    h_bf, _ = decoder_forward(c8.model, emb, cache_bf, pos)
    h_i8, _ = decoder_forward(c8.model, emb, cache_i8, pos)
    del cache_bf, cache_i8
    readings["int8_cache_min_cosine"] = float(_row_cosines(lm_logits(c8.model, h_i8)[:, 0], lm_logits(c8.model, h_bf)[:, 0]).min())
    mono = c8._generate(feats1, tokens1, 48)
    seg = c8._generate_segmented(feats1, tokens1, 48, 8)
    readings["int8_cache_segmented_equals_monolithic"] = bool(
        torch.equal(mono.tokens, seg.tokens) and torch.equal(mono.lengths, seg.lengths)
    )
    # W8A8 against weight-only int8; its cache-free and cache-building prefills
    l_a8_free, _, _ = prefill(a8.model, feats16, tokens16, use_cache=False, act_quant=True)
    l_a8, _, _ = prefill(a8.model, feats16, tokens16, max_new=48, act_quant=True)
    readings["w8a8_min_cosine"] = float(_row_cosines(l_a8, l_w8).min())
    readings["w8a8_cached_vs_free_max_abs"] = float((l_a8 - l_a8_free).abs().max())
    readings["w8a8_logit_scale"] = float(l_a8_free.abs().max())
    answers_w8 = w8.query_yes_no_batch(batch64, question)

    # the W8A8 service's main path: a caption and a yes/no chunk
    _sync(device)
    quant_rows.launches = ln_quant_rows.launches = 0
    caption = a8.caption(encs[0])["caption"]
    answers_a8 = a8.query_yes_no_batch(batch64, question)
    _sync(device)
    launches = {"K3_md": quant_rows.launches, "K4_md": ln_quant_rows.launches}
    readings["w8a8_yes_no_agree_with_int8_weights"] = sum(a == b for a, b in zip(answers_a8, answers_w8)) / len(answers_w8)
    readings["w8a8_yes"] = sum(answers_a8)
    readings["w8a8_caption_chars"] = len(caption)
    for mode in ("int8_weights", "int8_cache"):
        svc = svcs[mode]
        readings[f"{mode}_caption_chars"] = len(svc.caption(encs[0])["caption"])
        readings[f"{mode}_yes"] = sum(svc.query_yes_no_batch(batch64, question))
    del svcs, w8, c8, a8
    gc.collect()
    shutil.rmtree(root, ignore_errors=True)
    n = cfg.text.num_layers
    prefills = 2  # the caption's and the chunk's
    expected = {"K3_md": 2 * n * prefills, "K4_md": n * prefills}
    if torch.device(device).type != "cuda":  # the CPU runs the plain versions
        expected = dict.fromkeys(expected, 0)
    out = {"config": config, **readings, "times": times, "launches": launches, "expected_launches": expected}
    log("moondream int8: " + json.dumps(out))
    for mode, bar in MD_INT8_COSINE.items():
        if readings[f"{mode}_min_cosine"] < bar:
            raise AssertionError(f"{mode}: prefill or decode logits stray, cosine {readings[f'{mode}_min_cosine']} < {bar}")
    if not readings["int8_cache_segmented_equals_monolithic"]:
        raise AssertionError("segmented decode differs from one loop on the int8 cache")
    if readings["w8a8_yes_no_agree_with_int8_weights"] < MD_W8A8_YES_NO_AGREE:
        raise AssertionError(f"W8A8 yes/no answers stray from weight-only int8's: {readings}")
    if readings["w8a8_cached_vs_free_max_abs"] > 1e-3 * readings["w8a8_logit_scale"]:
        raise AssertionError(f"the W8A8 cache-free and cache-building prefills disagree: {readings}")
    if launches != expected:
        raise AssertionError(f"K3/K4 launches {launches} != 2 and 1 a layer a W8A8 prefill {expected}")
    return {"launches": launches, "readings": readings, "times": times}


# -- phase 8e ----------------------------------------------------------------

IVF_ROWS = 1 << 20
IVF_CENTRES = 4096
IVF_NOISE = 0.5  # the norm of a row's noise against its unit centre
IVF_QUERIES = 64
IVF_ADDS = 16
IVF_GROWTH = 128  # rows added past a lowered IMATCH_IVF_REBUILD_FRAC
IVF_UPLOADS = 4
SHARDS = 4  # logical shards on one card


def clustered_corpus(n: int, d: int, centres: int, seed: int, device):
    """Unit rows, each a random unit centre of ``centres`` plus Gaussian
    noise of norm about IVF_NOISE; rows [n-64, n) duplicate rows [0, 64);
    about 1% tombstones, none among rows 0-3 and their duplicates (queries
    whose self-match ties)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    c = torch.randn((centres, d), generator=g, device=device)
    c /= c.norm(dim=1, keepdim=True)
    which = torch.randint(0, centres, (n,), generator=g, device=device)
    x = c[which] + torch.randn((n, d), generator=g, device=device) * (IVF_NOISE / math.sqrt(d))
    del c, which
    x /= x.norm(dim=1, keepdim=True)
    x[n - 64 :] = x[:64]
    valid = torch.rand((n,), generator=g, device=device) >= 0.01
    valid[:4] = valid[n - 64 : n - 60] = True
    return x, valid


@contextlib.contextmanager
def counted_trains():
    """Calls of the port's ``train_centroids`` (k-means runs) in a ``with``
    block: the store, ``build_ivf`` and the sharded IVF all reach it through
    the module."""
    from imatch_tpu_torch.index import ivf

    train = ivf.train_centroids
    out = {"n": 0}

    def counting(*args, **kw):
        out["n"] += 1
        return train(*args, **kw)

    ivf.train_centroids = counting
    try:
        yield out
    finally:
        ivf.train_centroids = train


def _ids_match(got_ids, got_s, queries, corpus, valid, brute_s, brute_i) -> dict:
    """Phase 4's rule: ids equal to the brute force's, or, past 16 queries,
    equal up to fp32 near-ties (valid, distinct rows whose full product is
    within 1e-5 of the brute force's at each rank); scores within 1e-5."""
    import torch

    from imatch_tpu_torch.ops.kernels.topk import NEG_INF

    full = torch.where(valid[None, :], queries @ corpus.T, NEG_INF).gather(1, got_ids)
    distinct = bool((torch.sort(got_ids, dim=1).values.diff(dim=1) != 0).all())
    exact = bool(torch.equal(got_ids, brute_i))
    ties = bool(valid[got_ids].all()) and distinct and float((full - brute_s).abs().max()) <= 1e-5
    score_err = float((got_s - brute_s).abs().max())
    ok = (exact if queries.shape[0] <= 16 else ties) and score_err <= 1e-5
    return {"ids_equal": exact, "ids_equal_up_to_ties": ties, "max_score_err": score_err, "ok": ok}


def _readings(calls: dict, device) -> dict:
    """Host ms of each call (ending in a sync), then, on the card, its
    device busy ms and idle share from a trace (host readings first)."""
    import torch

    out = {name: {"host_ms": _host_ms(fn, device)} for name, fn in calls.items()}
    if torch.device(device).type == "cuda":
        for name, fn in calls.items():
            busy = device_busy(fn, out[name]["host_ms"], iters=3)
            out[name].update(
                device_busy_ms=busy["device_busy_ms"],
                idle_share=busy["idle_share"],
                device_ops=busy["device_ops_per_call"],
                K1_ms=busy["K1_ms"],
            )
    return out


def ivf_library(x, valid, device) -> dict:
    """(a) ``build_ivf`` timed whole and by stage, at the default C; a full
    probe against the brute force; recall@10 and self-matches at n_probe 8;
    the probe's readings at Q = 1 and 16 and n_probe 8 and 64 beside the
    exact bf16 engine on the same rows."""
    import torch

    from imatch_tpu_torch.index import ivf
    from imatch_tpu_torch.index.search import prepare_device_corpus, tilemax_topk

    n = x.shape[0]
    out = {}
    t0 = time.perf_counter()
    index = ivf.build_ivf(x, valid)
    _sync(device)
    out["build_ivf_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cents = ivf.train_centroids(x, valid)
    _sync(device)
    out["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    assign = ivf.assign_rows(x, cents)
    out["assign_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ivf.pack_ivf_stats(x, valid, cents, assign)
    _sync(device)
    out["pack_s"] = time.perf_counter() - t0
    c, m = index.members.shape
    out.update(clusters=int(cents.shape[0]), clusters_nonempty=c, member_width=m)
    g = torch.Generator().manual_seed(81)
    rows = torch.nonzero(valid[64 : n - 64].cpu()).flatten() + 64
    q_ids = torch.cat([torch.arange(4), rows[torch.randperm(rows.numel(), generator=g)[: IVF_QUERIES - 4]]])
    q_ids = q_ids.to(x.device)
    queries = x[q_ids]
    brute_s, brute_i = brute_force_topk(queries, x, valid, 10)
    s, i = ivf.ivf_topk(queries[:16], index, k=10, n_probe=c)
    out["full_probe"] = _ids_match(i, s, queries[:16], x, valid, brute_s[:16], brute_i[:16])
    s, i = ivf.ivf_topk(queries, index, k=10, n_probe=8)
    hits = [len(set(a) & set(b)) for a, b in zip(i.tolist(), brute_i.tolist())]
    out["recall_at_10_nprobe_8"] = sum(hits) / (10 * len(hits))
    out["self_match_first"] = bool(torch.equal(i[:, 0], q_ids))
    dc = prepare_device_corpus(x, valid, tile_n=512, device=device)
    calls = {}
    for nq in (1, 16):
        for n_probe in (8, 64):
            calls[f"ivf_q{nq}_nprobe{n_probe}"] = (
                lambda nq=nq, n_probe=n_probe: ivf.ivf_topk(queries[:nq], index, k=10, n_probe=n_probe)
            )
        calls[f"exact_bf16_q{nq}"] = lambda nq=nq: tilemax_topk(queries[:nq], dc, k=10)
    out["readings"] = _readings(calls, device)
    del index, dc
    ok = out["full_probe"]["ok"] and out["recall_at_10_nprobe_8"] >= 0.95 and out["self_match_first"]
    return out, ok, queries


def _members_equal(a, b) -> bool:
    """Two member tables hold the same lists (a repack may be wider)."""
    import torch

    w = min(a.shape[1], b.shape[1])
    return (
        bool(torch.equal(a[:, :w], b[:, :w]))
        and bool((a[:, w:] == -1).all())
        and bool((b[:, w:] == -1).all())
    )


def ivf_store_check(x, valid, queries, device, root) -> tuple:
    """(b) An IMATCH_INDEX_ENGINE=ivf store of the corpus: single adds
    patched without a k-means run, the patched member lists equal to a
    repack's, 64 deletes, growth past a lowered IMATCH_IVF_REBUILD_FRAC
    retraining once, then ``save`` with its sidecar and a ``load`` that
    answers the same without a k-means run. Returns the loaded store."""
    import numpy as np

    from imatch_tpu_torch.index import ivf
    from imatch_tpu_torch.index.store import VectorStore

    n = x.shape[0]
    host, alive = x.cpu().numpy(), valid.cpu().numpy()
    n_pre = n - IVF_ADDS - IVF_GROWTH
    ids = [f"v{i}" for i in range(n)]
    q = queries[:16]
    out = {}
    with counted_trains() as trains, environment(IMATCH_INDEX_ENGINE="ivf"):
        store = VectorStore(device=device)
        store.add(ids=ids[:n_pre], embeddings=host[:n_pre], metadatas=[{"id": i} for i in ids[:n_pre]])
        store.delete([ids[i] for i in np.flatnonzero(~alive[:n_pre])])  # ~1% tombstones
        store.query(q, n_results=10)  # the build the adds then patch
        out["first_build"] = store.stats()["last_build"]
        out["trains_after_build"] = trains["n"]
        for i in range(n_pre, n_pre + IVF_ADDS):
            store.add(ids=[ids[i]], embeddings=host[i : i + 1], metadatas=[{"id": ids[i]}])
        st = store.stats()
        out["adds_patched"] = st["patched_mutations"]
        out["trains_after_adds"] = trains["n"]
        _, state = store._device_corpus
        h = store._ivf_host
        repack, stats = ivf.pack_ivf_stats(state.corpus, store._alive, h["cents"], h["assign"])
        out["members_equal_repack"] = _members_equal(state.members, repack.members) and bool(
            np.array_equal(stats["counts"], h["counts"])
        )
        del repack
        hit = store.query(host[n_pre : n_pre + IVF_ADDS], n_results=1)["ids"]
        out["added_rows_found"] = [r[0] for r in hit] == ids[n_pre : n_pre + IVF_ADDS]
        gone = [i for i in ids[100:164] if alive[int(i[1:])]]
        store.delete(ids[100:164])
        res = store.query(host[100:164][alive[100:164]], n_results=10)["ids"]
        out["deleted_absent"] = not set(gone) & {i for r in res for i in r}
        out["patched_after_deletes"] = store.stats()["patched_mutations"]
        built = store._ivf_host["built_live"]
        frac = 0.25 * IVF_GROWTH / built  # IVF_GROWTH more rows outgrow it
        with environment(IMATCH_IVF_REBUILD_FRAC=repr(frac)):
            grow = slice(n_pre + IVF_ADDS, n)
            store.add(ids=ids[grow], embeddings=host[grow], metadatas=[{"id": i} for i in ids[grow]])
            store.query(q, n_results=10)
            store.query(q, n_results=10)
        out["trains_after_growth"] = trains["n"]
        out["ivf_after_growth"] = store.stats()["ivf"]
        want = store.query(q, n_results=10)["ids"]
        t0 = time.perf_counter()
        store.save(root)
        out["save_s"] = time.perf_counter() - t0
        with open(os.path.join(root, "manifest.json")) as f:
            out["sidecar"] = json.load(f).get("ivf")
        del store, state
        gc.collect()
        t0 = time.perf_counter()
        loaded = VectorStore.load(root, persist=False, device=device)
        got = loaded.query(q, n_results=10)["ids"]
        out["load_and_first_query_s"] = time.perf_counter() - t0
        out["loaded_equal"] = got == want
        out["loaded_ivf"] = loaded.stats()["ivf"]
        out["trains_after_load"] = trains["n"]
    ok = (
        out["trains_after_build"] == out["trains_after_adds"] == 1
        and out["adds_patched"] == IVF_ADDS
        and out["members_equal_repack"]
        and out["added_rows_found"]
        and out["deleted_absent"]
        and out["patched_after_deletes"] == IVF_ADDS + 1
        and out["trains_after_growth"] == 2
        and out["sidecar"] is not None
        and out["loaded_equal"]
        and out["trains_after_load"] == 2
        and out["loaded_ivf"]["last_mode"] == "repair"
    )
    return loaded, out, ok


def ivf_http_check(store, embedder, device, root) -> tuple:
    """(c) Slice 1's app with IMATCH_INDEX_ENGINE=ivf on ``store``:
    uploads, an image search at the default probe whose first result is
    the uploaded image, a text search; K2's launches held to the tower
    calls that hooks count, K1 to none (IVF runs no K1)."""
    import shutil

    import torch

    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
    from imatch_tpu_torch.ops.kernels.topk import tile_max
    from imatch_tpu_torch.pipeline.state import AppState
    from imatch_tpu_torch.serving.app import create_app

    shutil.rmtree(root, ignore_errors=True)
    with environment(IMATCH_INDEX_ENGINE="ivf", IMATCH_CAPTIONER="null"):
        state = AppState(root=root, embedder=embedder, device=device, autoload=False)
    state.store = store
    patched0 = store.stats()["patched_mutations"]
    pngs = [synthetic_png(8300 + i) for i in range(IVF_UPLOADS)]
    times, ids = {}, []
    counts_of = dict(clip_vision=embedder.model.vision, clip_text=embedder.model.text)
    with ServerThread(create_app(state), port := _free_port()), call_counts(**counts_of) as towers:
        http = HttpClient(port)
        _sync(device)
        flash_mha.launches = tile_max.launches = 0
        for i, png in enumerate(pngs):
            status, body, times[f"upload_{i}_ms"] = http.request("POST", "/api/upload", files=[("file", f"i{i}.png", png)])
            assert status == 200 and body["success"], body
            ids.append(body["metadata"]["id"])
        status, body, times["image_search_ms"] = http.request(
            "POST", "/api/search/image", [("limit", "10")], [("file", "q.png", pngs[1])]
        )
        assert status == 200, body
        image_top = [r["id"] for r in body["results"]]
        status, body, times["text_search_ms"] = http.request("POST", "/api/search/text", [("query", TEXT_QUERY), ("limit", "10")])
        assert status == 200, body
        text_n = len(body["results"])
        _sync(device)
        launches = {"K1": tile_max.launches, "K2": flash_mha.launches}
        tower_calls = dict(towers)
    nv, nt = embedder.cfg.vision.num_layers, embedder.cfg.text.num_layers
    expected = {"K1": 0, "K2": nv * tower_calls["clip_vision"] + nt * tower_calls["clip_text"]}
    if torch.device(device).type != "cuda":
        expected["K2"] = 0
    out = {
        **times,
        "image_top": image_top[:3],
        "upload_first": image_top[:1] == [ids[1]],
        "text_results": text_n,
        "uploads_patched": store.stats()["patched_mutations"] - patched0,
        "tower_calls": tower_calls,
        "launches": launches,
        "expected_launches": expected,
    }
    del state
    gc.collect()
    shutil.rmtree(root, ignore_errors=True)
    ok = (
        out["upload_first"]
        and text_n == 10
        and out["uploads_patched"] == IVF_UPLOADS
        and launches == expected
        and (launches["K2"] > 0 or torch.device(device).type != "cuda")
    )
    return out, ok


def _bit_equal(a, b) -> bool:
    return a["ids"] == b["ids"] and a["distances"] == b["distances"]


def _shard_states_equal(got, want) -> bool:
    import torch

    return got.rows == want.rows and all(
        torch.equal(getattr(g, f), getattr(w, f))
        for g, w in zip(got.shards, want.shards)
        for f in ("scoring", "exact", "valid")
    )


def sharded_check(x, valid, queries, device, root) -> tuple:
    """(d) ``sharded`` at P = 1 (the card) and P = SHARDS logical shards on
    it, bf16 and fp32, at Q = 1 and 16: bit for bit the ``tilemax``
    engine's answers on the same rows, K1 launched P times an engine call;
    patched adds, deletes and updates against a fresh build; ``ivf-sharded``
    at a full probe bit for bit ``sharded``, across a sidecar restart at
    P = SHARDS; the same over every card where more than one is visible.
    Returns the readings, whether all held, and the counted K1 launches."""
    import numpy as np
    import torch

    from imatch_tpu_torch.index.store import VectorStore
    from imatch_tpu_torch.ops.kernels.topk import tile_max

    host = x[valid].cpu().numpy()  # no tombstones: the sharded IVF sidecar needs none
    n = host.shape[0]
    ids = [f"s{i}" for i in range(n)]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    out, ok, launches = {}, True, {"K1": 0, "K1_mma": 0}

    def engine_check(store, ref_answers, tag, p):
        """The store's Q = 1 and 16 answers against ``ref_answers`` and its
        K1 launches an engine call (counted here for the kernels line)."""
        nonlocal ok
        store.query(queries[:1], n_results=10)  # the build
        row = {}
        for nq in (1, 16):
            _sync(device)
            k1, mma = tile_max.launches, tile_max.mma_launches
            got = store.query(queries[:nq], n_results=10)
            _sync(device)
            calls = tile_max.launches - k1
            launches["K1_mma"] += tile_max.mma_launches - mma
            launches["K1"] += calls - (tile_max.mma_launches - mma)
            row[f"q{nq}"] = {"bit_equal": _bit_equal(got, ref_answers[nq]), "k1_launches": calls}
            ok &= row[f"q{nq}"]["bit_equal"] and calls == (p if on_card else 0)
        out[tag] = row

    readings = {}
    for dtype in ("bf16", "fp32"):
        ref = VectorStore(engine="tilemax", score_dtype=dtype, device=device)
        ref.add(ids=ids, embeddings=host)
        want = {nq: ref.query(queries[:nq], n_results=10) for nq in (1, 16)}
        stores = {}
        for p in (1, SHARDS):
            st = VectorStore(engine="sharded", score_dtype=dtype, device=device, mesh=(dev,) * p)
            st.add(ids=ids, embeddings=host)
            engine_check(st, want, f"sharded_{dtype}_p{p}", p)
            stores[p] = st
        if dtype == "bf16":
            for nq in (1, 16):
                readings[f"tilemax_q{nq}"] = lambda nq=nq, s=ref: s.query(queries[:nq], n_results=10)
                for p, st in stores.items():
                    readings[f"sharded_p{p}_q{nq}"] = lambda nq=nq, s=st: s.query(queries[:nq], n_results=10)
            out["readings"] = _readings(readings, device)
            readings.clear()
            sharded, exact = stores[SHARDS], ref
            ivf_rows = ivf_sharded_check(sharded, ids, host, queries, device, root, out)
            ok &= ivf_rows
            # patched adds, deletes and updates on both stores
            g = np.random.default_rng(83)
            fresh_rows = g.standard_normal((IVF_ADDS + 64, host.shape[1])).astype(np.float32)
            fresh_rows /= np.linalg.norm(fresh_rows, axis=1, keepdims=True)
            for s in (sharded, exact):
                s.add(ids=[f"n{i}" for i in range(IVF_ADDS)], embeddings=fresh_rows[:IVF_ADDS])
                s.delete(ids[1000:1064])
                s.update(ids[2000:2064], embeddings=fresh_rows[IVF_ADDS:])
            st = sharded.stats()
            fresh = sharded._build_device(sharded._emb.copy(), sharded._alive.copy())[0]
            got = {nq: sharded.query(queries[:nq], n_results=10) for nq in (1, 16)}
            fresh_ids = sharded._run_engine(torch.from_numpy(queries[:16].cpu().numpy()), fresh, 16)[1][:, :10]
            out["patches"] = {  # the patched store against a fresh build and tilemax
                "patched": st["patched_mutations"],
                "rebuilt": st["rebuild_mutations"],
                "state_equals_fresh_build": _shard_states_equal(sharded._device_corpus[1], fresh[1]),
                "answers_equal_fresh_build": [[sharded._ids[i] for i in r] for r in fresh_ids.tolist()]
                == got[16]["ids"],
                "bit_equal_tilemax": all(_bit_equal(got[nq], exact.query(queries[:nq], n_results=10)) for nq in (1, 16)),
            }
            ok &= (
                (st["patched_mutations"], st["rebuild_mutations"]) == (3, 0)
                and out["patches"]["state_equals_fresh_build"]
                and out["patches"]["answers_equal_fresh_build"]
                and out["patches"]["bit_equal_tilemax"]
            )
            del fresh, sharded, exact
            if torch.cuda.device_count() > 1:  # the same checks over every card
                mesh = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
                half = n // 2
                st = VectorStore(engine="sharded", device=device, mesh=mesh)
                st.add(ids=ids[:half], embeddings=host[:half])
                ref2 = VectorStore(engine="tilemax", device=device)
                ref2.add(ids=ids[:half], embeddings=host[:half])
                want2 = {nq: ref2.query(queries[:nq], n_results=10) for nq in (1, 16)}
                engine_check(st, want2, "sharded_cards", len(mesh))
                cards = {}
                ok &= ivf_sharded_check(st, ids[:half], host[:half], queries, device, root, cards)
                out["ivf_sharded_cards"] = cards["ivf_sharded"]
                del st, ref2
            else:
                out["multi_card"] = "fewer than two CUDA devices visible: no multi-card run took place"
                log("sharded: fewer than two CUDA devices are visible; no multi-card run took place")
        del ref, stores
        gc.collect()
    return out, ok, launches


def ivf_sharded_check(sharded, ids, host, queries, device, root, out) -> bool:
    """``ivf-sharded`` at SHARDS shards on the rows of ``sharded`` (no
    tombstones): at a full probe bit for bit ``sharded``; saved with its
    sidecar and loaded at the same mesh, the same answers at the default
    and the full probe without a k-means run."""
    import shutil

    from imatch_tpu_torch.index.store import VectorStore

    mesh = sharded._mesh
    with counted_trains() as trains:
        ann = VectorStore(engine="ivf-sharded", device=device, mesh=mesh)
        ann.add(ids=ids, embeddings=host)
        with environment(IMATCH_IVF_NPROBE="1000000"):
            full = {nq: ann.query(queries[:nq], n_results=10) for nq in (1, 16)}
        default = ann.query(queries[:16], n_results=10)
        want = {nq: sharded.query(queries[:nq], n_results=10) for nq in (1, 16)}
        row = {
            "trains": trains["n"],
            "full_probe_bit_equal_sharded": all(_bit_equal(full[nq], want[nq]) for nq in (1, 16)),
            "clusters": ann.stats()["ivf"]["clusters"],
        }
        shutil.rmtree(root, ignore_errors=True)
        t0 = time.perf_counter()
        ann.save(root)
        row["save_s"] = time.perf_counter() - t0
        del ann
        gc.collect()
        with environment(IMATCH_INDEX_ENGINE="ivf-sharded"):
            t0 = time.perf_counter()
            loaded = VectorStore.load(root, persist=False, device=device, mesh=mesh)
            again = loaded.query(queries[:16], n_results=10)
            row["load_and_first_query_s"] = time.perf_counter() - t0
            with environment(IMATCH_IVF_NPROBE="1000000"):
                full_again = loaded.query(queries[:16], n_results=10)
        row["restart_equal"] = _bit_equal(again, default) and _bit_equal(full_again, want[16])
        row["restart_ivf"] = loaded.stats()["ivf"]
        row["trains_after_restart"] = trains["n"]
    del loaded
    gc.collect()
    shutil.rmtree(root, ignore_errors=True)
    out["ivf_sharded"] = row
    return (
        row["trains"] == len(mesh)
        and row["full_probe_bit_equal_sharded"]
        and row["restart_equal"]
        and row["trains_after_restart"] == len(mesh)
        and row["restart_ivf"]["last_mode"] == "repair"
    )


def phase_ivf(embedder, device="cuda", rows=IVF_ROWS, centres=IVF_CENTRES) -> dict:
    """Phase 8e: the IVF tier and the sharded engines on a ``rows``-row
    clustered corpus at ``embedder``'s width: (a) the IVF library, (b) the
    ivf store, (c) the app over HTTP on that store, (d) the sharded engines.
    Returns the K1 and K2 launches of (c) and (d). (A small corpus and
    config on the CPU rehearse the same control flow.)"""
    import shutil

    import torch

    t0 = time.perf_counter()
    dim = embedder.cfg.projection_dim
    x, valid = clustered_corpus(rows, dim, centres, 80, device)
    roots = {k: os.path.join("build", f"chip_smoke_ivf_{k}") for k in ("store", "app", "sharded")}
    for r in roots.values():
        shutil.rmtree(r, ignore_errors=True)
    lib, lib_ok, queries = ivf_library(x, valid, device)
    log("ivf library: " + json.dumps(lib))
    store, st, st_ok = ivf_store_check(x, valid, queries, device, roots["store"])
    log("ivf store: " + json.dumps(st))
    shutil.rmtree(roots["store"], ignore_errors=True)
    http, http_ok = ivf_http_check(store, embedder, device, roots["app"])
    log("ivf http: " + json.dumps(http))
    del store
    gc.collect()
    sh, sh_ok, k1 = sharded_check(x, valid, queries, device, roots["sharded"])
    log("sharded: " + json.dumps(sh))
    del x, valid, queries
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    log(f"phase 8e: {time.perf_counter() - t0:.1f} s")
    failed = [name for name, good in (("library", lib_ok), ("store", st_ok), ("http", http_ok), ("sharded", sh_ok)) if not good]
    if failed:
        raise AssertionError(f"phase 8e failed: {failed}")
    return {"launches": {"K1": k1["K1"], "K1_mma": k1["K1_mma"], "K2": http["launches"]["K2"]}}


def phase_reference() -> None:
    """vit-b32 (depth cut to 2 layers a tower) on the card, bf16 and fp32,
    against the same weights in fp32 on the CPU: per-row cosine of the
    embeddings, and of their deviations from the CPU mean (random-init
    towers map every image close to one direction)."""
    import dataclasses

    import numpy as np
    import torch

    from imatch_tpu_torch.models.clip.bridge import params_to_numpy
    from imatch_tpu_torch.models.clip.configs import get_config
    from imatch_tpu_torch.models.clip.model import init_random
    from imatch_tpu_torch.pipeline.embedder import ClipEmbedder

    base = get_config("vit-b32")
    cfg = dataclasses.replace(
        base,
        name="vit-b32-2layer",
        vision=dataclasses.replace(base.vision, num_layers=2),
        text=dataclasses.replace(base.text, num_layers=2),
    )
    gen = torch.Generator().manual_seed(2)
    tree = params_to_numpy(init_random(cfg, device="cpu", dtype=torch.float32, generator=gen))
    from PIL import Image

    frames = [np.asarray(Image.open(io.BytesIO(synthetic_png(40 + i)))) for i in range(4)]
    texts = ["a red drill", "blue sky over the sea", "a cat", "two dogs on grass"]
    ref = ClipEmbedder(cfg, params=tree, device="cpu")
    want = np.concatenate([ref.embed_images(frames), ref.embed_texts(texts)])
    mean = want.mean(0)
    bars = {torch.float32: (0.99999, 0.999), torch.bfloat16: (0.999, 0.9)}
    for dtype, (raw_bar, dev_bar) in bars.items():
        emb = ClipEmbedder(cfg, params=tree, device="cuda", compute_dtype=dtype)
        got = np.concatenate([emb.embed_images(frames), emb.embed_texts(texts)])
        assert got.shape == want.shape and np.isfinite(got).all()
        raw = (got * want).sum(1)
        a, b = got - mean, want - mean
        dev = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
        log(
            f"reference vit-b32 2-layer {str(dtype).replace('torch.', '')} vs CPU fp32: "
            f"min cosine {raw.min():.7f} (bar {raw_bar}), min deviation cosine "
            f"{dev.min():.5f} (bar {dev_bar})"
        )
        if raw.min() < raw_bar or dev.min() < dev_bar:
            raise AssertionError(f"{dtype} towers on the card disagree with the CPU")


def _cosines(got, want):
    """Per-row cosine of unit embeddings, and of their deviations from the
    reference's mean (random-init towers map every input close to one
    direction, which the raw cosine hides)."""
    import numpy as np

    raw = (got * want).sum(1)
    a, b = got - want.mean(0), want - want.mean(0)
    dev = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    return raw, dev


def phase_w8a8_fidelity(w8a8) -> None:
    """The W8A8 tower (bf16 compute, as served) against the full-fp32
    tower on the same seed's weights, on the card, for 8 frames and for
    the 8 standard-normal pixel inputs the JAX tier's measurement used
    (scripts/exp_w8a8_vit.py); the bf16 tower beside it as the yardstick.
    The gate is the JAX tier's figure as that script computes it: the mean
    cosine over the 8 >= 0.9995, for both input sets; the minimum is
    printed beside it."""
    import numpy as np
    import torch
    from PIL import Image

    from imatch_tpu_torch.pipeline.embedder import ClipEmbedder

    cfg = w8a8.cfg
    frames = [np.asarray(Image.open(io.BytesIO(synthetic_png(400 + i))).convert("RGB")) for i in range(8)]
    size = cfg.vision.image_size
    noise = torch.from_numpy(
        np.random.default_rng(0).standard_normal((8, size, size, 3)).astype(np.float32)
    ).to("cuda")
    towers = {}
    for name, emb in (
        ("fp32", lambda: ClipEmbedder(cfg, device="cuda", compute_dtype=torch.float32)),
        ("bf16", lambda: ClipEmbedder(cfg, device="cuda")),
        ("w8a8", lambda: w8a8),
    ):
        e = emb()
        towers[name] = (
            e.embed_images(frames),
            e._embed_pixels(noise.to(e.compute_dtype)).cpu().numpy(),
        )
        del e
        torch.cuda.empty_cache()
    worst = 1.0
    for name in ("bf16", "w8a8"):
        for k, inputs in enumerate(("frames", "normal pixels")):
            got, want = towers[name][k], towers["fp32"][k]
            assert got.shape == want.shape and np.isfinite(got).all()
            raw, dev = _cosines(got, want)
            log(
                f"fidelity {cfg.name} {name} tower vs fp32 tower on the card, 8 {inputs}: "
                f"mean cosine {raw.mean():.7f}, min {raw.min():.7f}, "
                f"min deviation cosine {dev.min():.5f}"
            )
            if name == "w8a8":
                worst = min(worst, float(raw.mean()))
    if worst < 0.9995:
        raise AssertionError(f"the W8A8 tower strays from the fp32 tower: mean cosine {worst}")


# -- phase 10 ----------------------------------------------------------------


def phase_scripts():
    """The two experiment entry points on the card, with the K5, K6 and
    tensor-core K1 launch counts read around them; returns the counts and
    the scripts' JSON lines (printed by main before the kernels line)."""
    from imatch_tpu_torch.ops.kernels.int4_topk import int4_tile_max
    from imatch_tpu_torch.ops.kernels.topk import tile_max
    from imatch_tpu_torch.ops.kernels.topk_t import tile_max_t
    from imatch_tpu_torch.scripts import exp_int4_kernel, exp_pallas_search

    int4_tile_max.launches = 0
    tile_max_t.launches = 0
    tile_max.mma_launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        k5 = exp_int4_kernel.main("cuda")
        k6 = exp_pallas_search.main("cuda")
    launches = {
        "K5": int4_tile_max.launches,
        "K6": tile_max_t.launches,
        "K1_mma": tile_max.mma_launches,
    }
    log(f"scripts: ran in {time.perf_counter() - t0:.1f} s, launches {json.dumps(launches)}")
    if not (k5["kernel_matches_plain_torch"] and k6["transposed_matches"]):
        raise AssertionError("an experiment script's correctness check failed")
    if not (k6["transposed_528_matches"] and all(launches.values())):
        raise AssertionError(f"an experiment script failed: {launches}")
    return launches, buf.getvalue().strip().splitlines()


def phase_profile(device="cuda") -> dict:
    """``POST /api/profile/start`` and ``/stop`` around an upload and two
    searches on a small app (vit-b32, seeded weights, a fresh store): a
    stop without a start and a second start are 409s, and the trace
    written holds the port's kernels (K1's tile_max and K2's flash_fwd)
    among the card's kernel events. Last of all: a profiler session slows
    the host's later launches."""
    import shutil

    from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
    from imatch_tpu_torch.pipeline.state import AppState
    from imatch_tpu_torch.serving.app import create_app

    root = os.path.join("build", "chip_smoke_profile")
    shutil.rmtree(root, ignore_errors=True)
    trace_dir = os.path.abspath(os.path.join(root, "trace"))
    with environment(IMATCH_CAPTIONER="null"):
        state = AppState(root=root, embedder=ClipEmbedder("vit-b32", device=device), device=device)
    png = synthetic_png(77)
    with ServerThread(create_app(state), port := _free_port()):
        http = HttpClient(port)
        assert http.request("POST", "/api/upload", files=[("file", "p0.png", synthetic_png(76))])[0] == 200
        assert http.request("POST", "/api/profile/stop")[0] == 409
        status, body, _ = http.request("POST", "/api/profile/start", [("log_dir", trace_dir)])
        assert status == 200 and body == {"success": True, "trace_dir": trace_dir}, body
        assert http.request("POST", "/api/profile/start", [("log_dir", trace_dir)])[0] == 409
        assert http.request("POST", "/api/upload", files=[("file", "p.png", png)])[0] == 200
        assert http.request("POST", "/api/search/text", [("query", TEXT_QUERY)])[0] == 200
        assert http.request("POST", "/api/search/image", files=[("file", "q.png", png)])[0] == 200
        status, body, stop_ms = http.request("POST", "/api/profile/stop")
        assert status == 200 and body["trace_dir"] == trace_dir, body
        assert http.request("POST", "/api/profile/stop")[0] == 409
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    out = {
        "trace_bytes": os.path.getsize(os.path.join(trace_dir, "trace.json")),
        "events": len(events),
        "kernel_events": len(kernels),
        "tile_max_events": sum("tile_max" in k for k in kernels),
        "flash_fwd_events": sum("flash_fwd" in k for k in kernels),
        "stop_ms": stop_ms,
    }
    log("profile: " + json.dumps(out))
    del state
    gc.collect()
    shutil.rmtree(root, ignore_errors=True)
    if not (out["tile_max_events"] and out["flash_fwd_events"]):
        raise AssertionError(f"the profile trace holds none of the port's kernels: {out}")
    return out


def phase_profile_apart() -> None:
    """Phase 12 in a process of its own: its check reads the app's profiler
    trace, and this long process's late traces drop events (kernel_ab.py's
    ``trace``). The child loads the kernels phase 2 built."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--phase", "profile"],
        capture_output=True,
        text=True,
        timeout=600,
    )
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    log(f"phase 12 (own process): rc {proc.returncode}, {time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        raise AssertionError(f"phase 12 failed in its own process (rc {proc.returncode})")


def kernels_line(k2_rows, k1_rows, k1i8_rows, k34_rows, k5_rows, k6_rows, launches) -> dict:
    """One entry a kernel at the shapes its main path gives it: the image
    tower's attention for one upload, phase 1 of one search over the
    2^20-row store (bf16 and int8, the tilemax engine's 512-row tiles), K1
    bf16 at 16 queries (the tensor-core kernel), the W8A8 tower's quantizes
    in the bulk-ingest chunk of 64 images (bf16), and K5 and K6 at their
    scripts' shapes (8 queries over 2^20 rows, tile 2048). Launches are
    those of each path's HTTP requests: slices 1-3 for K1-K4 (slice 1's
    five searches, one of them the first after the uploads), phase 6b's
    requests and warm for K1 at Q = 1, the tensor-core K1 and K2 (with
    the int8 tier's device-resident folder for K2), the two experiment
    scripts for K5, K6 and the tensor-core K1 (exp_pallas_search's Q = 8
    row-major phase); and K2 at the Moondream vision tower's shape, with
    the Moondream slice's launches (phase 8b: its encodes' and its CLIP
    towers'); K3 and K4 at the W8A8 Moondream prefill's 16-image shape,
    with the launches of phase 8d's W8A8 caption and yes/no chunk. Phase
    8c's cutout requests add their K1 and K2 launches to the CLIP
    entries', phase 8e's sharded engine calls their K1 launches (P a call)
    and its HTTP requests their K2 launches."""

    def pick(table, **want):
        return next(r for r in table if all(r[k] == v for k, v in want.items()))

    k1 = pick(k1_rows, q=1, dtype="bfloat16", tile_n=512)
    k1q16 = pick(k1_rows, q=16, dtype="bfloat16", tile_n=512)
    k1i8 = pick(k1i8_rows, q=1)
    k2 = pick(k2_rows, shape=[1, 16, 257, 64], dtype="bfloat16")
    k2_md = pick(k2_rows, shape=[1, 16, 729, 72], dtype="bfloat16")
    k5 = pick(k5_rows, tile_n=2048)
    k6 = pick(k6_rows, dp=640, tile_n=2048)
    entries = []
    for name, row, source, replaces, key, shape in (
        (
            "K1 tile_max",
            k1,
            "imatch_tpu_torch/csrc/tile_max.cu",
            "imatch_tpu/ops/pallas/topk.py:84",
            "K1",
            f"Q=1 x {k1['n']}x{k1['d']} bf16, tile_n {k1['tile_n']}",
        ),
        (
            "K1 tile_max, bf16 Q>=2 (tensor cores)",
            k1q16,
            "imatch_tpu_torch/csrc/tile_max.cu",
            "imatch_tpu/ops/pallas/topk.py:84",
            "K1_mma",
            f"Q=16 x {k1q16['n']}x{k1q16['d']} bf16, tile_n 512; launches: the serving "
            "surface's batches, coalesced groups and warm (Q=2-256), and exp_pallas_search's "
            "Q=8 row-major phase",
        ),
        (
            "K1 tile_max_int8",
            k1i8,
            "imatch_tpu_torch/csrc/tile_max.cu",
            "imatch_tpu/index/search.py:99",
            "K1_int8",
            f"Q=1 x {k1i8['n']}x{k1i8['d']} int8, tile_n 512; launches: the int8 and "
            "tilemax-host tiers' searches",
        ),
        (
            "K2 flash_attention",
            k2,
            "imatch_tpu_torch/csrc/flash_attention.cu",
            "imatch_tpu/ops/pallas/flash_attention.py:26",
            "K2",
            "(1, 16, 257, 64) bf16, non-causal",
        ),
        (
            "K2 flash_attention, Moondream vision tower",
            k2_md,
            "imatch_tpu_torch/csrc/flash_attention.cu",
            "imatch_tpu/ops/pallas/flash_attention.py:26",
            "K2_md",
            "(1, 16, 729, 72) bf16, non-causal; launches: the Moondream slice's requests "
            "(27 a vision encode)",
        ),
        (
            "K3 quant_rows",
            pick(k34_rows, kernel="K3", d=4096, rows=64 * 257, dtype="bfloat16"),
            "imatch_tpu_torch/csrc/quantize.cu",
            "imatch_tpu/ops/pallas/quantize.py:74",
            "K3",
            "(16448, 4096) bf16: the MLP activation of a 64-image chunk",
        ),
        (
            "K4 ln_quant_rows",
            pick(k34_rows, kernel="K4", d=1024, rows=64 * 257, dtype="bfloat16"),
            "imatch_tpu_torch/csrc/quantize.cu",
            "imatch_tpu/ops/pallas/quantize.py:81",
            "K4",
            "(16448, 1024) bf16: ln1/ln2 of a 64-image chunk",
        ),
        (
            "K3 quant_rows, Moondream W8A8 prefill",
            pick(k34_rows, kernel="K3", d=8192, rows=MD_PREFILL_ROWS[1], dtype="bfloat16"),
            "imatch_tpu_torch/csrc/quantize.cu",
            "imatch_tpu/ops/pallas/quantize.py:74",
            "K3_md",
            f"({MD_PREFILL_ROWS[1]}, 8192) bf16: gelu(fc1) of a 16-image moondream2 caption prefill; "
            "launches: the W8A8 service's caption and yes/no chunk (2 a layer a prefill, D 2048 and 8192)",
        ),
        (
            "K4 ln_quant_rows, Moondream W8A8 prefill",
            pick(k34_rows, kernel="K4", d=2048, rows=MD_PREFILL_ROWS[1], dtype="bfloat16"),
            "imatch_tpu_torch/csrc/quantize.cu",
            "imatch_tpu/ops/pallas/quantize.py:81",
            "K4_md",
            f"({MD_PREFILL_ROWS[1]}, 2048) bf16: the residual stream of a 16-image moondream2 caption "
            "prefill; launches: the W8A8 service's caption and yes/no chunk (1 a layer a prefill)",
        ),
        (
            "K5 int4_tile_max",
            k5,
            "imatch_tpu_torch/csrc/int4_tile_max.cu",
            "scripts/exp_int4_kernel.py:79",
            "K5",
            "Q=8 x 1048576x512 int4 packed (N, 256) + rows 0-1 of the (8, N) bf16 side, tile_n 2048",
        ),
        (
            "K6 tile_max_t",
            k6,
            "imatch_tpu_torch/csrc/tile_max_t.cu",
            "scripts/exp_pallas_search.py:71",
            "K6",
            "Q=8 x (640, 1048576) bf16 transposed, tile_n 2048",
        ),
    ):
        entry = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[key],
            "max_abs_err": row["max_abs_err"],
            "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": shape,
        }
        # the card's time alone: events of back-to-back calls time the host
        # where it launches more slowly than the card runs (K2 at B = 1)
        entry["device_ms"] = row["device_ms"]
        entry["device_pct_of_bound"] = row["device_pct_of_bound"]
        if key in ("K2", "K2_md"):
            entry["library_device_ms"] = row["library_device_ms"]
        if key in ("K3", "K4", "K3_md", "K4_md"):
            entry["library_note"] = "no single PyTorch call computes a per-row int8 quantize"
        elif "library_note" in row:
            entry["library_note"] = row["library_note"]
        entries.append(entry)
    return {"kernels": entries}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    # phase 6b runs the app's warmup itself, timed: the apps' background
    # warmup would launch kernels inside the other phases' counted windows
    os.environ["IMATCH_WARMUP"] = "0"
    phase_identify()
    phase_build()
    k2_rows = phase_k2()
    k1_rows = phase_k1()
    k1i8_rows = phase_k1_int8()
    k34_rows = phase_k34()
    k5_rows = phase_k5()
    k6_rows = phase_k6()
    with environment(IMATCH_CAPTIONER="null"):  # the CLIP slices run without a captioner
        launches, embedder, surface = phase_slice()
        gc.collect()  # the first slice's app and 2^20-row store
        torch.cuda.empty_cache()
        w8a8_launches, w8a8 = phase_w8a8()
        launches.update(K3=w8a8_launches["K3"], K4=w8a8_launches["K4"])
        tiers = phase_tiers(embedder)
    launches["K1_int8"] = sum(c["K1_int8"] for c in tiers.values())
    # slice 8's requests: phase 6b, and its device ingest on the int8 tier
    launches["K1"] += surface["K1"]
    launches["K2"] += surface["K2"] + tiers["int8"]["K2_ingest"]
    gc.collect()
    torch.cuda.empty_cache()
    launches["K2_md"] = phase_moondream(embedder)["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    u2 = phase_u2net(embedder)["launches"]  # slice 9's cutouts and their searches
    launches["K1"] += u2["K1"]
    launches["K2"] += u2["K2"]
    gc.collect()
    torch.cuda.empty_cache()
    ivf = phase_ivf(embedder)["launches"]  # slice 10: the sharded engines' K1, the towers' K2
    launches["K1"] += ivf["K1"]
    launches["K2"] += ivf["K2"]
    del embedder
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase_md_int8()["launches"])
    gc.collect()
    torch.cuda.empty_cache()
    phase_reference()
    phase_w8a8_fidelity(w8a8)
    del w8a8
    gc.collect()
    torch.cuda.empty_cache()
    script_launches, script_lines = phase_scripts()
    launches.update(script_launches)
    launches["K1_mma"] += surface["K1_mma"] + u2["K1_mma"] + ivf["K1_mma"]
    traced = [r for rows in (k1_rows, k1i8_rows, k34_rows, k5_rows, k6_rows) for r in rows if "_trace" in r]
    phase_device(k2_rows, traced)
    phase_profile_apart()
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    for line in script_lines:
        print(line)
    print(json.dumps(kernels_line(k2_rows, k1_rows, k1i8_rows, k34_rows, k5_rows, k6_rows, launches)))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


def main_profile() -> int:
    """``--phase profile``: phase 12 alone, as ``phase_profile_apart`` runs it."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    os.environ["IMATCH_WARMUP"] = "0"
    phase_profile()
    return 0


if __name__ == "__main__":
    sys.exit(main_profile() if sys.argv[1:] == ["--phase", "profile"] else main())
