#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (imatch_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. Identify the card (nvidia-smi name and power limit, torch and CUDA
   versions, whether PIL is installed).
2. Build the CUDA kernels from imatch_tpu_torch/csrc/ with nvcc.
3. K2 (flash attention) against its plain PyTorch version at the CLIP
   towers' shapes, bf16 and fp32, with a fully masked case.
4. K1 (tile max) against its plain version, and the K1 engine against a
   full fp32 brute-force top-k, on a 2^20 x 768 corpus with tombstones and
   duplicate rows.
5. The slice end to end: the port's app at longclip-l14-248 (random
   weights from a seed) served over HTTP by the port's server, holding a
   2^20-row store; uploads, a duplicate, and text, image and multimodal
   searches, with the K1 and K2 launch counts read around them. Then a
   cut-depth vit-b32 tower on the card against the same weights on the CPU.

The line before the last is {"kernels": [...]} with each kernel's
measured and bound times; the last line is the device JSON. It imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import io
import json
import math
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / fp32 CUDA-core rate

# bf16 tolerance: 2 bf16 ulps at magnitude 1 (2 * 2^-7) absolute, plus half
# an ulp relative for outputs above 1, against fp32 math on the same inputs.
BF16_ATOL = 2 * 2.0**-7
BF16_RTOL = 2.0**-8
FP32_TOL = 2e-5  # tests/test_pallas.py's bar for the Pallas kernel


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    import torch

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


def bound_ms(n_bytes: float, n_ops: float, dtype_name: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 1 -----------------------------------------------------------------


def phase_identify() -> None:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
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


def k2_case(shape, causal, dtype, kv_len=None, seed=0) -> dict:
    import torch
    import torch.nn.functional as F

    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha, flash_mha_plain

    b, h, s, dh = shape
    kv_len = s if kv_len is None else kv_len
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (
        torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3)
    )
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
    ]
    rows = []
    for shape, causal, kv_len in cases:
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(k2_case(shape, causal, dtype, kv_len))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"K2 disagrees with its plain version in {len(bad)} cases")
    return rows


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


def k1_case(corpus, valid, nq, dtype, tile_n, k=10) -> dict:
    import torch

    from imatch_tpu_torch.index.search import prepare_device_corpus, tilemax_topk
    from imatch_tpu_torch.ops.kernels.topk import tile_max, tile_max_plain

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
        "max_score_err": score_err,
        "ok": err <= 1e-5 and ids_equal and score_err <= 1e-5,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "engine_ms": engine_ms,
        "bound_ms": bms,
        "bound_by": bound_by,
    }
    log("K1 " + json.dumps(row))
    del dc
    return row


def phase_k1() -> list:
    import torch

    corpus, valid = make_corpus(1 << 20, 768)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for nq in (1, 16):
            for tile_n in (512, 2048):  # the tilemax and pallas engines
                rows.append(k1_case(corpus, valid, nq, dtype, tile_n))
    del corpus, valid
    torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"K1 or its engine disagrees in {len(bad)} cases")
    return rows


# -- phase 5 -----------------------------------------------------------------

SLICE_CONFIG = "longclip-l14-248"
N_UPLOADS = 16
STORE_ROWS = 1 << 20  # rows in the store once the uploads are in
TEXT_QUERY = "a red drill on a wooden table"
MULTIMODAL_QUERY = "blue sky over the sea"


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
        import urllib.error
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
        if method == "POST":
            data = b"".join(parts) + f"--{boundary}--\r\n".encode()
            headers["Content-Type"] = f"multipart/form-data; boundary={boundary}"
        req = urllib.request.Request(self.base + path, data=data, headers=headers, method=method)
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


def phase_slice(device="cuda", config=SLICE_CONFIG, store_rows=STORE_ROWS) -> dict:
    """The app at longclip-l14-248 over HTTP; returns the launch counts.
    (A small config on the CPU rehearses the same control flow.)"""
    import shutil

    import torch

    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
    from imatch_tpu_torch.ops.kernels.topk import tile_max
    from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
    from imatch_tpu_torch.pipeline.state import AppState
    from imatch_tpu_torch.serving.app import create_app

    root = os.path.join("build", "chip_smoke_app")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    embedder = ClipEmbedder(config, device=device)
    state = AppState(root=root, embedder=embedder, device=device)
    cfg = embedder.cfg
    # A store at a real size: earlier images as random unit rows, so the
    # searches below score 2^20 rows through K1.
    n_pre = store_rows - N_UPLOADS
    g = torch.Generator(device=device).manual_seed(1)
    pre = torch.randn((n_pre, cfg.projection_dim), generator=g, device=device)
    pre = (pre / pre.norm(dim=1, keepdim=True)).cpu().numpy()
    state.store.add(
        ids=[f"pre_{i}" for i in range(n_pre)],
        embeddings=pre,
        metadatas=[{"id": f"pre_{i}"} for i in range(n_pre)],
    )
    del pre
    app = create_app(state)
    log(f"slice: {cfg.name} app with a {n_pre}-row store ready in {time.perf_counter() - t0:.1f} s")

    pngs = [synthetic_png(i) for i in range(N_UPLOADS)]
    port = _free_port()
    with ServerThread(app, port):
        http = HttpClient(port)
        _sync(device)
        tile_max.launches = 0
        flash_mha.launches = 0
        times = {}
        ids = []
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
        status, body, times["text_ms"] = http.request(
            "POST", "/api/search/text", [("query", TEXT_QUERY), ("limit", "5")]
        )
        assert status == 200 and len(body["results"]) == 5, body
        text_top = [r["id"] for r in body["results"]]
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
        assert status == 200 and health["images"] == store_rows, health
    breakdown(state, pngs[7], device)
    shutil.rmtree(root, ignore_errors=True)

    image_calls = N_UPLOADS + 2  # each upload, the image search, the multimodal search
    text_calls = 2  # the text search, the multimodal search (another text)
    expected = {
        "K1": 3,  # one phase-1 launch a search
        "K2": image_calls * cfg.vision.num_layers + text_calls * cfg.text.num_layers,
    }
    log(
        "slice: "
        + json.dumps(
            {
                "config": cfg.name,
                "store_rows": store_rows,
                "upload_ms": times["upload_ms"],
                "duplicate_ms": times["duplicate_ms"],
                "text_ms": times["text_ms"],
                "image_ms": times["image_ms"],
                "multimodal_ms": times["multimodal_ms"],
                "self_match_similarity": self_score,
                "text_top5": text_top,
                "multimodal_top5": multimodal_top,
                "launches": launches,
                "expected_launches": expected,
            }
        )
    )
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != what the requests imply {expected}")
    return launches


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


def device_busy(fn, wall_ms: float, iters: int = 5) -> dict:
    """Device time of one call from a torch.profiler trace: the sum of
    its kernel and copy intervals, the port's kernels by name, and the
    idle share against ``wall_ms``, the same call's host-clock time
    measured without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = 0.0
    by_kernel = {"flash_fwd_kernel": 0.0, "tile_max_kernel": 0.0}
    n_kernels = 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        busy += us
        n_kernels += 1
        for key in by_kernel:
            if key in evt.name:
                by_kernel[key] += us
    busy_ms = busy / iters / 1e3
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_call": n_kernels / iters,
        "K2_ms": by_kernel["flash_fwd_kernel"] / iters / 1e3,
        "K1_ms": by_kernel["tile_max_kernel"] / iters / 1e3,
    }


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


def kernels_line(k2_rows, k1_rows, launches) -> dict:
    """One entry a kernel at the shapes the slice's requests give it: the
    image tower's attention for one upload, and phase 1 of one search
    over the 2^20-row store (bf16, the tilemax engine's 512-row tiles)."""
    k2 = next(
        r for r in k2_rows if r["shape"] == [1, 16, 257, 64] and r["dtype"] == "bfloat16"
    )
    k1 = next(
        r for r in k1_rows if r["q"] == 1 and r["dtype"] == "bfloat16" and r["tile_n"] == 512
    )
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
            "K2 flash_attention",
            k2,
            "imatch_tpu_torch/csrc/flash_attention.cu",
            "imatch_tpu/ops/pallas/flash_attention.py:26",
            "K2",
            "(1, 16, 257, 64) bf16, non-causal",
        ),
    ):
        entries.append(
            {
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
        )
    return {"kernels": entries}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    phase_identify()
    phase_build()
    k2_rows = phase_k2()
    k1_rows = phase_k1()
    launches = phase_slice()
    phase_reference()
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernels_line(k2_rows, k1_rows, launches)))
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


if __name__ == "__main__":
    sys.exit(main())
