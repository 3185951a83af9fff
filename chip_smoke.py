#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (imatch_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py                 # every phase, the contract's lines
    python3 chip_smoke.py --phase NAME    # identify, build and one phase (PHASES below)

Phases, by number; any failure exits non-zero and prints no result. A
whole run takes them in number order up to 8h, then 10 and 11, then 8i,
whose launch B (four processes training, saving and restoring) runs on
while phase 12's process and phase 9 (neither reads a time) run beside
it; 8i (d) and phase 12 are read last. So every time the kernels line
prints (phases 3-5b, 10, 11) is taken on a quiet card:

1. Identify the card (nvidia-smi name and power limit, torch and CUDA
   versions, whether PIL is installed).
2. Build the CUDA kernels from imatch_tpu_torch/csrc/ with nvcc, one
   process a source, all started together.
3. K2 (flash attention) against its plain PyTorch version at the CLIP
   towers' shapes, bf16 and fp32, with a fully masked case, at the
   bulk-ingest chunk (64, 16, 257, 64), and at the Moondream vision
   tower's (1, 16, 729, 72) and (16, 16, 729, 72). bf16 runs the
   tensor-core kernel (flash_fwd_mma_kernel), fp32 the register-blocked
   CUDA-core one (flash_fwd_fp32_kernel).
4. K1 (tile max) against its plain version, and the K1 engine against a
   full fp32 brute-force top-k, on a 2^20 x 768 corpus with tombstones and
   duplicate rows, at Q = 1 and 16, tiles 512 and 2048 (bf16 at Q = 16
   runs the tensor-core kernel, tile_max_mma_kernel; fp32 at Q = 16 the
   register-blocked CUDA-core one, tile_max_fp32_kernel), bf16 also at Q =
   17 and 256, fp32 at Q = 17 and 256 (tiles 512 and 2048) and 64 (tile
   512); then K1's int8 variant, bit-identical to its plain version, and
   the int8 engine against the brute force, on the same corpus at Q = 1,
   8, 16.
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
   the fused chunk's stages timed (W8A8 beside the bf16 tower at B = 64);
   then the W8A8 tower against the fp32 tower on the card.
8. The third slice end to end: the app at longclip-l14-248 over a store of
   2^18 rows (2^20 until the scale phase came), once with IMATCH_SCORE_DTYPE=int8, once with
   IMATCH_INDEX_ENGINE=tilemax-host and once with IMATCH_SCORE_DTYPE=fp32
   (the fidelity tier); uploads that patch the built index,
   then text, image and multimodal searches over HTTP whose ids must equal
   a full fp32 brute force and the bf16 engine on the same rows, with the
   K1 and K1-int8 launch counts read around them (the fp32 tier also
   serves one /api/search/batch of 256 texts, one launch of K1's fp32
   multi-query kernel, ids equal to the brute force up to near-ties); 64 deletes and 64
   updates (patched, or on the host tier one rebuild for the updates)
   checked as in phase 6 with K1-int8; then an IMATCH_INDEX_ENGINE=auto
   store of 2^16 rows whose 256 MiB device budget makes its build
   escalate to tilemax-host.
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
   two a layer a prefill. Each stage's time is one warm call, then one
   timed (the decode: a warm decode of 8 tokens, then 48 timed).
8e. The tenth slice, the IVF tier and the sharded engines, on 2^17 rows
   of clustered unit vectors at LongCLIP's width (1448 centres plus noise,
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
   a k-means run. (c) Slice 1's app on that store over HTTP: two rounds
   of uploads, an image search whose first result is an upload after the
   first and a text search after the second; each round's uploads patched
   up to the first that lands in a pruned cluster (which drops the index
   for the round's search to repair, without a k-means run), and at least
   one upload patched; K2 held to the tower calls that hooks count, K1 to
   none. (d) ``sharded`` at P =
   1 and at 4 logical shards on the card, bf16 and fp32, at Q = 1 and 16:
   ids and distances bit for bit the ``tilemax`` engine's, K1 launched P
   times an engine call; patched adds, deletes and updates equal to a
   fresh build; ``ivf-sharded`` at a full probe bit for bit ``sharded``,
   across a sidecar restart at 4 shards. Where more than one card is
   visible the sharded checks run over every card; otherwise a line says
   that no multi-card run took place.
8f. The eleventh slice, the native decoder, client.py and the operations
   scripts, on slice 1's embedder after 8e. (a) The port's native decode
   pool (runtime/loader.py, built with g++ into build/): whether it is
   native, and if not what is missing (g++, the codec headers); a 16-bit
   gray PNG equal to its high byte in all three channels, and 8-bit RGB,
   RGBA, LA, palette with tRNS, 1-bit PNGs, a JPEG at quality 90 and a
   lossless WebP equal to PIL's pixels; 64 PNGs and 64 JPEGs at 240x320
   timed on the pool and on a PIL thread pool. (b) The app over HTTP
   driven by imatch_tpu_torch/client.py: health, an upload and its 409,
   the 16-bit PNG (its id the host pHash of its high byte), a batched
   folder of 32, text, image and multimodal searches, 16 texts and 8
   images in one request each, a metadata edit, a filter whose text holds
   a ``/`` added and deleted, reset; K1 and K2 held to the engine and
   tower calls. (c) The scripts through their ``main``: init_index twice,
   ingest_folder over 64 frames on disk (img/s), migrate_from_reference
   from a synthetic Chroma sqlite of 16384 WAL vectors x 768 and 64 rows
   pruned from the WAL that ``--reembed`` embeds on the card (K2), the
   migrated directory loaded on the card answering 16 queries with the
   brute force's ids; launches held as in (b). (d) stress_sharded_store at
   50_000 x 256 (the script's default 100_000 until the scale phase came) over 8 logical
   shards of cuda:0: every checkpoint equal to
   its numpy oracle at a full probe, with its time and peak memory.
8g. The twelfth slice, CLIP contrastive training (the step `train`),
   after 8d. (a) imatch_tpu_torch/scripts/train_clip.py through its
   ``train`` at vit-b32, bf16, batches of 64 drawn from 256 synthetic
   pairs: 4 steps with ``--ckpt-every 4`` (JAX's npz keys), then
   ``--resume`` to 5, with its log lines; the step ms (median after the
   first), the losses, each save's and the restore's seconds. The resumed
   run re-seeds its sampler, so its batch is the first run's first: the
   uninterrupted state (in memory) takes a step on it whose loss must
   equal the resumed run's (``TRAIN_RESUME_RTOL``), and one more each
   (``TRAIN_NEXT_RTOL``). (b) That state takes 10 steps on one fixed
   batch of 64 random pairs: the loss must fall by ``TRAIN_MIN_DROP``. (c) LongCLIP-L/14-248
   at full width and depth, bf16, 3 steps at B = 32: step ms, images/s,
   peak device memory; one more batch's gradients, every leaf finite and
   non-zero, each layer's q, k and v projections included. (d) K2's
   wrapper raises on card inputs that require grad and launches nothing;
   no K2 launch in (a)-(c): training takes ``mha_xla``.
8h. The thirteenth slice, the model axis (the step `parallel`), after
   8g, on logical shards of cuda:0 (the machine holds one card: no run
   over several real cards takes place). (a) K2 at a tensor-parallel
   shard's head count, bf16, against its plain version: (2, 8, 729, 72),
   (4, 8, 257, 64), causal (4, 6, 248, 64). (b) vit-b32 (phase 8i (d) steps
   LongCLIP-L/14-248 on the (2, 2) grid, in one process and across four)
   at full width and depth, one fp32 step (TF32 off) at B = 8 on a (2, 2) grid
   against one device from the same seed: the loss within
   ``PARALLEL_LOSS_RTOL``, the largest parameter difference printed. (c)
   3 bf16 steps at B = 32 on each: step ms, images/s, peak memory. (d)
   moondream2 bf16 over 2 model shards against one device: the prefill
   logits' cosine a row and argmax; K2's launches in the sharded encode
   counted (each at (2, 8, 729, 72)) and the first one's inputs held
   against ``flash_mha_plain``. (e) ``ClipEmbedder(mesh=["cuda"] * 2)``
   at LongCLIP, bf16 and W8A8, against one device on 24 frames: cosine,
   top-10 ids in a store equal for every frame, K2 (and K3/K4) launches
   a data shard at its 16 frames, the first launch of each (K3 at each
   width) captured and held against its plain version. (f) One more bf16
   step of (c)'s two states at B = 32 traced, on one device and on (2, 2):
   device busy ms, operations, idle share against (c)'s median step.
8i. The pipeline, sequence and process axes (the step `scale`), after
   8h, on logical shards of cuda:0; the processes are gloo processes sharing the card
   (imatch_tpu_torch/scripts/dryrun_multiprocess.py, each checking every
   path against what the same grid shape gives in one process, process 0
   computing that answer). Launch A, 2 processes x 2 shards:
   the ``sharded`` store and library call at 2^17 x 768 unit rows, 16
   queries, k 10, exact against float64 numpy in each, K1 launched in
   each, one query's ms and the all-gather's; then (a) the ``ivf-sharded``
   store at 2^17 x 768 rows round 1448 centres: at a full probe bit for
   bit ``sharded``, at IMATCH_IVF_NPROBE=8 the one-process 4-shard
   engine's ids, a sidecar each process saves reloaded and repaired in
   one process, an add through the append patch and a delete; query ms
   at Q = 1 and 16 and the gather's share; (b) LongCLIP-L/14-248's towers
   at mp = 2, one model shard a process, B = 16: K2 launched at (16, 8,
   257, 64) in each and held against ``flash_mha_plain`` on the captured
   input, cosine >= 0.9999 to the one-process mp = 2 forward and equal
   top-10 ids; (c) the embedder's data axis, one shard a process, 16
   frames: K2 at the data shard's (8, 16, 257, 64), top-10 ids equal to
   one device's; (e) causal ring attention at (32, 12, 248, 64) bf16 over
   4 positions (2 a process), output and gradient equal to the
   one-process ring's, and GPipe over the 24 image layers, one stage a
   process, B = 32, M = 4, equal to the one-process pipeline, K2 launched
   12 x 4 times a process, its refusal under autograd; each timed beside
   the one-process run. Launch B, (d), started with launch A: 4 processes
   on the (2, 2) grid, two DP + TP steps of LongCLIP-L at half its depth
   (12 image and 6 text layers, full width: the run's time limit) at B =
   32 (bf16, fp32 masters), every worker's losses within rtol 1e-6 of the
   one-process (2, 2) grid's from the same seed and batches (computed in
   this process while the workers start); a checkpoint saved there (JAX's
   keys, process 0 writing) restored by process 0 at mp = 1, equal to the
   saved state; step ms, save and restore s. Launch B runs on (its save
   and restore) beside phase 12's process and phase 9, and is read after
   them (the step `scale_train`).
   Beside launches A and B, in this process: dryrun_multichip over 8
   logical shards of the card, then ring
   attention causal bf16 at (32, 12, 248, 64), P = 4 and 8, against K2 on
   the whole sequence, the fp32 plain version and ``mha_xla``, and (1,
   16, 16384, 64) at P = 8 against K2 (each timed, K2 beside it, peak
   memory beside the (B, H, S, S) fp32 logits it never holds); GPipe
   over the 24 image layers in one process at (P, M) = (2, 4) and (4, 8)
   against the unpipelined encoder (cosine, K2 launched 24 x M times, the
   first launch at each microbatch shape held against its plain version,
   ms beside the unpipelined tower's, the bubble fraction). Every timing
   of the phase shares the card and the host with the parts running
   beside it.
9. A cut-depth vit-b32 tower on the card against the same weights on the
   CPU, bf16 and fp32; the fp32 towers' K2 launches are counted and the
   first at each shape held against the plain version (as in phase 7's
   fidelity check).
10. The two experiment entry points, python -m imatch_tpu_torch.scripts.
   exp_int4_kernel (K5) and exp_pallas_search (K6 beside K1), run to the
   end with the K5, K6 and tensor-core K1 launch counts read around them
   (exp_pallas_search's row-major phase runs K1 bf16 at Q = 8).
11. Every kernel's device time from torch.profiler traces (``device_ms``
   and ``device_pct_of_bound``): K2 and SDPA at each phase-3 case
   (``library_device_ms``), and every other kernels-line entry at its own
   shape (K1 bf16 Q = 1 and 16, K1 fp32 Q = 16 and 256, K1 int8, K3 and K4 at 16448 bf16 rows and at
   the Moondream prefill's 760 and 12160, K5 at each tile, K6). Events of back-to-back calls time the host where it
   launches more slowly than the card runs (K2 at B = 1). It runs in a
   process of its own (``chip_smoke.py --child device``) on inputs of the
   same shapes, after every CUDA-event time: a profiler session slows the
   host's later launches, and a long process's late traces drop events. A
   reading the traces lost is null: not measured. Phase 8h's split-head
   K2 cases are traced too.
12. POST /api/profile/start and /stop on a small app (vit-b32): 409s on
   misuse, and a trace file that holds K1's and K2's kernels. It runs in a
   process of its own (``chip_smoke.py --child profile``), whose first
   trace is whole, on the kernels phase 2 built; in a whole run it starts
   after phase 8i and runs beside launch B's save and restore and phase
   9 (it checks its own trace, not a time).

The device breakdowns attribute profiler events to K1-K6 by kernel
symbol (``kernel_key`` in imatch_tpu_torch/scripts/kernel_ab.py):
flash_fwd_fp32_kernel and flash_fwd_mma_kernel are K2, tile_max_kernel,
tile_max_mma_kernel and tile_max_fp32_kernel are K1,
int4_tile_max_mma_kernel is K5. The fp32 counters (K1's
``fp32_mq_launches``, K2's ``fp32_launches``) give the kernels line its two
fp32 entries.

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
import shutil
import signal
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


K2_CASES = [
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


def phase_k2() -> list:
    import torch

    rows = []
    for shape, causal, kv_len in K2_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(k2_case(shape, causal, dtype, kv_len))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"K2 disagrees with its plain version in {len(bad)} cases")
    return rows


# K3 and K4 cases of the kernels line: the bulk-ingest chunk's and the
# Moondream W8A8 prefill's rows, bf16
K34_TRACED = [
    *((64 * 257, kernel, d) for kernel, d in (("K3", 1024), ("K3", 4096), ("K4", 1024))),
    *((r, kernel, d) for r in (760, 16 * 760) for kernel, d in (("K3", 2048), ("K3", 8192), ("K4", 2048))),
]


def trace_specs() -> list:
    """Phase 11's calls, each a spec whose fields (but ``key``) name the
    phase 3-5b row it times: K2 (and SDPA where the row has a library
    time) at every phase-3 case, K1 bf16 at Q = 1 and 16 and fp32 at Q = 16
    and 256 with tile 512, K1
    int8 at Q = 1, K3 and K4 at K34_TRACED, K5 at each tile, K6 at (640,
    2048)."""
    specs = [
        {"key": "K2", "shape": list(shape), "causal": causal, "kv_len": shape[2] if kv_len is None else kv_len, "dtype": dname}
        for shape, causal, kv_len in K2_CASES
        for dname in ("bfloat16", "float32")
    ]
    specs += [
        {"key": "K2", "shape": list(shape), "causal": causal, "kv_len": shape[2], "dtype": "bfloat16"}
        for shape, causal in K2_TP_CASES
    ]
    specs += [{"key": "K1", "q": q, "dtype": dname, "tile_n": 512} for dname, qs in (("bfloat16", (1, 16)), ("float32", (16, N_BIG_BATCH))) for q in qs]
    specs.append({"key": "K1_int8", "q": 1})
    specs += [{"key": kernel, "kernel": kernel, "rows": r, "d": d, "dtype": "bfloat16"} for r, kernel, d in K34_TRACED]
    specs += [{"key": "K5", "tile_n": t} for t in (512, 1024, 2048)]
    specs.append({"key": "K6", "dp": 640, "tile_n": 2048})
    return specs


def trace_call(spec, cache):
    """The zero-argument call ``spec`` times, on inputs of its row's shapes
    built here (corpora shared through ``cache``)."""
    import torch

    from imatch_tpu_torch.index.search import _int8_queries, prepare_device_corpus
    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
    from imatch_tpu_torch.ops.kernels.int4_topk import int4_tile_max
    from imatch_tpu_torch.ops.kernels.topk import tile_max, tile_max_int8
    from imatch_tpu_torch.ops.kernels.topk_t import tile_max_t
    from imatch_tpu_torch.scripts.exp_pallas_search import make_data

    key = spec["key"]
    if key == "K2":
        q, k, v = _k2_inputs(tuple(spec["shape"]), getattr(torch, spec["dtype"]))
        return lambda: flash_mha(q, k, v, causal=spec["causal"], kv_len=spec["kv_len"])
    if key in ("K1", "K1_int8"):
        if "corpus" not in cache:
            cache["corpus"] = make_corpus(1 << 20, 768)
        corpus, valid = cache["corpus"]
        if key == "K1":
            dtype = getattr(torch, spec["dtype"])
            dc = prepare_device_corpus(corpus, valid, tile_n=spec["tile_n"], score_dtype=dtype, device="cuda")
            qs = corpus[: spec["q"]].to(dtype)
            return lambda: tile_max(qs, dc.scoring, dc.valid, spec["tile_n"])
        dc = prepare_device_corpus(corpus, valid, tile_n=512, score_dtype=torch.int8, margin=16, device="cuda")
        qi, qscale = _int8_queries(corpus[: spec["q"]].clone(), dc.scoring.shape[1])
        args = (qi, dc.scoring, qscale, dc.scale, dc.valid, dc.tile_n)
        return lambda: tile_max_int8(*args)
    if key in ("K3", "K4"):
        return _k34_calls(key, spec["rows"], spec["d"], torch.bfloat16, 0)[1]
    if key == "K5":
        if "k5" not in cache:
            cache.pop("corpus", None)
            cache["k5"] = _k5_inputs(1 << 20, 512, 8)
        qbf, packed, side = cache["k5"]
        return lambda: int4_tile_max(qbf, packed, side, spec["tile_n"])
    scoring, qs = make_data(1 << 20, spec["dp"], "cuda")
    st = scoring.T.contiguous()
    del scoring
    return lambda: tile_max_t(qs, st, spec["tile_n"])


def phase_device_child(out_path: str) -> None:
    """Phase 11 proper (``--child device``, a process of its own): each
    spec's device time (``device_ms``, its own kernel intervals a call in a
    torch.profiler trace) and, for K2, SDPA's on the same inputs
    (``library_device_ms``). Written to ``out_path`` as JSON. A reading the
    traces lost is None (``device_ms``)."""
    import torch
    import torch.nn.functional as F

    cache = {}
    readings = []
    for spec in trace_specs():
        fn = trace_call(spec, cache)
        reading = {"spec": spec, "device_ms": device_ms(fn, spec["key"])}
        if spec["key"] == "K2" and spec["kv_len"] == spec["shape"][2]:
            q, k, v = _k2_inputs(tuple(spec["shape"]), getattr(torch, spec["dtype"]))
            reading["library_device_ms"] = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=spec["causal"]))
        log(f"{spec['key']} device " + json.dumps(reading))
        readings.append(reading)
        del fn
    with open(out_path, "w") as f:
        json.dump(readings, f)


def phase_device(tables: dict) -> None:
    """Phase 11 in a process of its own (``chip_smoke.py --child device``):
    a profiler session slows every later launch of its process, and a long
    process's late traces drop events (a whole run in one process lost 14
    of its 18 SDPA readings), so the traces run on a fresh process's
    inputs of the same shapes after every CUDA-event time is taken. Each reading lands on the
    row its spec names in ``tables`` (key -> rows): ``device_ms``,
    ``device_pct_of_bound`` and, for K2, ``library_device_ms``; a lost
    reading is None, a row no spec names keeps None. A table the run has
    not filled (the phase run alone) takes no reading: the child's lines
    show them."""
    out_path = os.path.abspath(os.path.join("build", "chip_smoke_device.json"))
    if os.path.exists(out_path):
        os.remove(out_path)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", "device", "--out", out_path],
        capture_output=True,
        text=True,
        timeout=600,
    )
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    log(f"phase 11 (own process): rc {proc.returncode}, {time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        raise AssertionError(f"phase 11 failed in its own process (rc {proc.returncode})")
    with open(out_path) as f:
        readings = json.load(f)
    for rows in tables.values():
        for row in rows:
            row.setdefault("device_ms", None)
            row.setdefault("device_pct_of_bound", None)
    for reading in readings:
        spec = reading["spec"]
        match = {k: v for k, v in spec.items() if k != "key"}
        for row in tables.get("K34" if spec["key"] in ("K3", "K4") else spec["key"], ()):
            if all(row.get(k) == v for k, v in match.items()):
                row["device_ms"] = reading["device_ms"]
                row["device_pct_of_bound"] = (
                    None if reading["device_ms"] is None else 100 * row["bound_ms"] / reading["device_ms"]
                )
                if spec["key"] == "K2":
                    row["library_device_ms"] = reading.get("library_device_ms")


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
    return row


def phase_k1() -> list:
    import torch

    corpus, valid = make_corpus(1 << 20, 768)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for nq in (1, 16):
            for tile_n in (512, 2048):  # the tilemax and pallas engines
                rows.append(k1_case(corpus, valid, nq, dtype, tile_n))
    # the tensor-core kernel's later 16-query blocks (grid.y = ceil(Q/16)):
    # a partial second block, and the batch route's 256 queries
    for nq in (17, N_BIG_BATCH):
        for tile_n in (512, 2048):
            rows.append(k1_case(corpus, valid, nq, torch.bfloat16, tile_n))
    # fp32 (IMATCH_SCORE_DTYPE=fp32) past 16 queries: a partial second
    # chunk, a coalesced group's 64, and the batch route's 256
    for nq, tiles in ((17, (512, 2048)), (64, (512,)), (N_BIG_BATCH, (512, 2048))):
        for tile_n in tiles:
            rows.append(k1_case(corpus, valid, nq, torch.float32, tile_n))
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


def _k34_calls(kernel, rows, d, dtype, seed):
    """Inputs of (rows, d) with a zero row, then the kernel's call, its
    plain version's and the bar on differing codes."""
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
        return x, (lambda: quant_rows(x)), (lambda: quant_rows_plain(x)), 1e-3
    run = lambda: ln_quant_rows(x, gamma, beta, 1e-5)  # noqa: E731
    plain = lambda: ln_quant_rows_plain(x, gamma, beta, 1e-5)  # noqa: E731
    return x, run, plain, 2e-3


def k34_case(kernel, rows, d, dtype, seed=0) -> dict:
    """One K3 or K4 case against its plain version on the same inputs:
    codes within 1 LSB with under 1e-3 (K3) or 2e-3 (K4) of them
    differing, scales within rtol 1e-6 (tests/test_quant_kernel.py)."""
    import torch

    x, run, plain, frac_bar = _k34_calls(kernel, rows, d, dtype, seed)
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


def _k5_inputs(n, d, q):
    """8 unit bf16 queries and the packed int4 corpus (a tombstone every
    97th row) of scripts/exp_int4_kernel.py's shapes."""
    import torch

    from imatch_tpu_torch.ops.kernels.int4_topk import pack_int4

    corpus, _ = make_corpus(n, d, seed=5)
    valid = torch.arange(n, device="cuda") % 97 != 0
    packed, side, _, _ = pack_int4(corpus, valid)
    del corpus
    g = torch.Generator(device="cuda").manual_seed(6)
    qbf = torch.randn((q, d), generator=g, device="cuda")
    return (qbf / qbf.norm(dim=1, keepdim=True)).bfloat16(), packed, side


def phase_k5() -> list:
    """K5 at scripts/exp_int4_kernel.py's shapes: 8 bf16 queries of 512 over
    2^20 rows packed (N, 256), a tombstone every 97th row, tile_n 512, 1024
    and 2048; atol 1e-5 against the plain version (exact products, fp32
    sums in another order). Timed at every tile; tile 2048 is the kernels
    line's shape."""
    import torch

    from imatch_tpu_torch.ops.kernels.int4_topk import int4_tile_max, int4_tile_max_plain

    n, d, q = 1 << 20, 512, 8
    qbf, packed, side = _k5_inputs(n, d, q)
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
    ``want`` as before; a PUT /api/metadata before the snapshot persists
    across the second restart, and POST /api/reset leaves an empty store
    after a third."""
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
    routes = {}
    with ServerThread(create_app(state), port := _free_port()):
        http = HttpClient(port)
        status, body, routes["put_metadata_ms"] = http.request(
            "PUT", f"/api/metadata/{ids[0]}", [("description", "edited on the card")]
        )
        assert status == 200 and body["metadata"]["description"] == "edited on the card", body
        assert http.request("PUT", "/api/metadata/img_nope", [("description", "x")])[0] == 404
        assert http.request("PUT", f"/api/metadata/{ids[0]}", [("custom_metadata", "x")])[0] == 422
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
    routes["metadata_after_restart"] = state.image_metadata[ids[0]]["description"]
    assert routes["metadata_after_restart"] == "edited on the card", routes
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
        tile_max.launches = tile_max.mma_launches = tile_max.fp32_mq_launches = flash_mha.launches = 0
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
            "K1": tile_max.launches - tile_max.mma_launches - tile_max.fp32_mq_launches,
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
    app_mod.default_loader().decode_each(pngs24)
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
    "fp32": ({"IMATCH_SCORE_DTYPE": "fp32"}, "tilemax"),  # the fidelity tier: fp32 phase 1
}
N_TIER_UPLOADS = 4
# the tier apps' store rows (2^20 until the scale phase came: the run's time limit)
TIER_ROWS = 1 << 18
# the auto store's rows and device budget: a 2^16 x 768 tilemax build (bf16
# scores + the fp32 copy, 302 MB) outgrows half of 256 MiB and escalates
# (2^20 rows and 4 GiB until the training phase came, 2^18 and 1 GiB until
# the scale phase: the run's time limit)
AUTO_ROWS = 1 << 16
AUTO_BUDGET = 1 << 28


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


def _ids_up_to_ties(queries, store, got_ids, k=10) -> dict:
    """Each query's ids from the server against a full fp32 brute force
    over the store's rows: equal, or equal up to fp32 near-ties (each id a
    live row, once a row, whose full product is within 1e-5 of brute
    force's score at its rank; phase 4's rule past 16 queries)."""
    import torch

    from imatch_tpu_torch.ops.kernels.topk import NEG_INF

    n = store._n
    dev = queries.device
    rows = torch.from_numpy(store._emb[:n]).to(dev)
    alive = torch.from_numpy(store._alive[:n]).to(dev)
    bs, bi = brute_force_topk(queries.float(), rows, alive, k)
    slot = {id_: i for i, id_ in enumerate(store._ids[:n])}
    got = torch.tensor([[slot[i] for i in r] for r in got_ids], device=dev)
    full = torch.where(alive[None, :], queries.float() @ rows.T, NEG_INF).gather(1, got)
    distinct = bool((torch.sort(got, dim=1).values.diff(dim=1) != 0).all())
    return {
        "ids_equal_brute_force": bool(torch.equal(got, bi)),
        "ids_equal_brute_force_up_to_ties": bool(alive[got].all()) and distinct and float((full - bs).abs().max()) <= 1e-5,
    }


def phase_tiers(embedder, device="cuda", store_rows=TIER_ROWS) -> dict:
    """The int8 score tier, the tilemax-host tier and the fp32 (fidelity)
    tier, each an app over HTTP on ``embedder`` with a store of
    ``store_rows`` rows; then an auto store that escalates. The fp32 tier
    also serves one /api/search/batch of 256 texts (K1's fp32 multi-query
    kernel), whose ids must equal the brute force up to near-ties. Returns
    the K1, K1-int8 and K1-fp32 launch counts of each tier's searches. (A
    small config on the CPU rehearses the same control flow.)"""
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
            tile_max.launches = tile_max.fp32_mq_launches = 0
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
            if tier == "fp32":
                # the batch route at its limit: one fp32 phase 1 of 256 queries
                big = [f"query {i} {BATCH_TEXTS[i % 16]}" for i in range(N_BIG_BATCH)]
                status, body, times["batch256_ms"] = http.request_json(
                    "/api/search/batch", {"queries": big, "limit": 10}
                )
                _sync(device)
                assert status == 200 and len(body["results"]) == N_BIG_BATCH, status
                launches["K1_fp32"] = tile_max.fp32_mq_launches
                batch_ids, batch_q = _ids_of(body), seen.pop()
        assert tops["image"][0] == ids[1], tops["image"]
        uploads_patched = store.stats()["patched_mutations"]
        queries = torch.cat([q.to(device) for q in seen])
        brute, bf16 = _references(store, queries, device)
        equal = {
            name: tops[name] == brute[j] == bf16[j]
            for j, name in enumerate(("text", "image", "multimodal"))
        }
        batch = _ids_up_to_ties(batch_q.to(device), store, batch_ids) if tier == "fp32" else {}
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
            **({"batch256": batch} if batch else {}),
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
        # one int8 (or fp32) phase 1 a search on the card, the batch's 256
        # queries in one fp32 launch; the CPU runs plain versions
        on_card = torch.device(device).type == "cuda"
        expected = {"K1": 0, "K1_int8": 3} if tier != "fp32" else {"K1": 3, "K1_int8": 0, "K1_fp32": 1}
        if not on_card:
            expected = dict.fromkeys(expected, 0)
        # the uploads and the deletes patch; the updates patch, or rebuild once on the host tier
        want_patches = (N_TIER_UPLOADS + 1, 1) if engine == "tilemax-host" else (N_TIER_UPLOADS + 2, 0)
        if (
            first_build["engine"] != engine
            or not all(equal.values())
            or (batch and not batch["ids_equal_brute_force_up_to_ties"])
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
        auto.add(ids=pre_ids[:AUTO_ROWS], embeddings=pre[:AUTO_ROWS])
        got = auto.query(text_vec, n_results=10)["ids"]
    brute, _ = _references(auto, text_vec, device)
    stats = auto.stats()
    log(
        "tiers auto: "
        + json.dumps(
            {"engine": stats["engine"], "last_build": stats["last_build"], "budget": AUTO_BUDGET, "rows": auto.count()}
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
    clip_model.mha = lambda q, k, v, *, causal=False, impl="auto": flash_mha_plain(q, k, v, causal=causal)
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
        flash_mha.launches = tile_max.launches = tile_max.mma_launches = tile_max.fp32_mq_launches = 0
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
            "K1": tile_max.launches - tile_max.mma_launches - tile_max.fp32_mq_launches,
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
MD_WARM_DECODE = 8  # tokens of the warm decode before a mode's timed one
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
    caption prefill at B = 1 and 16 (the cache built; one warm call, one
    timed), one decode step (the mean of a 48-token greedy decode, after a
    warm decode of MD_WARM_DECODE tokens into a cache of the same size),
    the yes/no chunk of 64."""
    from imatch_tpu_torch.models.moondream.generate import greedy_generate

    t = {}
    _, t["prefill_b1_ms"] = _timed(lambda: svc._prefill(feats1, tokens1, 48), device, 1)
    _, t["prefill_b16_ms"] = _timed(lambda: svc._prefill(feats16, tokens16, 48), device, 1)
    state = {}

    def decode(max_new):
        logits, cache, pos = svc._prefill(feats1, tokens1, 48)
        _sync(device)
        t0 = time.perf_counter()
        result = greedy_generate(svc.model, logits, cache, pos, max_new=max_new)
        result.tokens.cpu()
        state["ms"] = (time.perf_counter() - t0) * 1e3
        state["steps"] = int(result.lengths.max()) - 1  # the first token comes from the prefill

    decode(MD_WARM_DECODE)
    decode(48)
    t["decode_step_ms"] = state["ms"] / max(1, state["steps"])
    t["decode_steps"] = state["steps"]
    q = "Yes or No: " + MD_FILTER
    _, t["yes_no_b64_ms"] = _timed(lambda: svc.query_yes_no_batch(batch64, q), device, 1)
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

# 2^17 rows (2^20 until the training phase came: the run's time limit);
# as many centres as the default rule's C there, 4 * sqrt(rows)
IVF_ROWS = 1 << 17
IVF_CENTRES = 1448
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


def _expected_patches(host, rows) -> tuple:
    """Which of ``rows``, uploaded one at a time onto a store whose IVF
    host state is ``host`` (its centroids and pruned map), land in a
    cluster pruned from the device table for having no member (their
    nearest centroid is ``assign_rows``'s), and how many are patched:
    those before the first such row. That row drops the index, as JAX's
    patch.py declines it, and the rows after it find none to patch until
    a search's build repairs it."""
    import numpy as np

    from imatch_tpu_torch.index import ivf as ivf_mod

    clusters = ivf_mod.assign_rows(np.asarray(rows, np.float32), host["cents"])
    pruned = [bool(host["pruned_map"][c] < 0) for c in clusters.tolist()]
    return pruned, pruned.index(True) if True in pruned else len(pruned)


def ivf_http_check(store, embedder, device, root) -> tuple:
    """(c) Slice 1's app with IMATCH_INDEX_ENGINE=ivf on ``store``: two
    rounds of IVF_UPLOADS uploads, each followed by a search (an image
    search whose first result is an upload of the first round, then a
    text search); K2's launches held to the tower calls that hooks count,
    K1 to none (IVF runs no K1). The uploads of a round are patched into
    the IVF index up to the first whose nearest centroid is pruned
    (``_expected_patches`` on the host state before the round); that one
    drops the index, and the round's search repairs it without a k-means
    run. The repair gives the clusters the first round landed in members,
    so the second round's uploads, of frames like the first's, find them
    live: at least one upload over HTTP must be patched."""
    import shutil

    import numpy as np
    import torch

    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
    from imatch_tpu_torch.ops.kernels.topk import tile_max
    from imatch_tpu_torch.pipeline.state import AppState
    from imatch_tpu_torch.serving.app import create_app

    shutil.rmtree(root, ignore_errors=True)
    with environment(IMATCH_INDEX_ENGINE="ivf", IMATCH_CAPTIONER="null"):
        state = AppState(root=root, embedder=embedder, device=device, autoload=False)
    state.store = store
    rounds = [[synthetic_png(8300 + 100 * r + i) for i in range(IVF_UPLOADS)] for r in range(2)]
    times, ids, hosts, stats = {}, [[], []], [], [store.stats()]
    counts_of = dict(clip_vision=embedder.model.vision, clip_text=embedder.model.text)
    with ServerThread(create_app(state), port := _free_port()), call_counts(**counts_of) as towers, counted_trains() as trains:
        http = HttpClient(port)
        _sync(device)
        flash_mha.launches = tile_max.launches = 0
        for r, pngs in enumerate(rounds):
            hosts.append({k: np.array(store._ivf_host[k]) for k in ("cents", "pruned_map")})
            for i, png in enumerate(pngs):
                status, body, times[f"upload_{r}_{i}_ms"] = http.request(
                    "POST", "/api/upload", files=[("file", f"r{r}i{i}.png", png)]
                )
                assert status == 200 and body["success"], body
                ids[r].append(body["metadata"]["id"])
            stats.append(store.stats())
            if r == 0:
                status, body, times["image_search_ms"] = http.request(
                    "POST", "/api/search/image", [("limit", "10")], [("file", "q.png", pngs[1])]
                )
                assert status == 200, body
                image_top = [rr["id"] for rr in body["results"]]
            else:
                status, body, times["text_search_ms"] = http.request(
                    "POST", "/api/search/text", [("query", TEXT_QUERY), ("limit", "10")]
                )
                assert status == 200, body
                text_n = len(body["results"])
            stats.append(store.stats())
        _sync(device)
        launches = {"K1": tile_max.launches, "K2": flash_mha.launches}
        tower_calls = dict(towers)
    nv, nt = embedder.cfg.vision.num_layers, embedder.cfg.text.num_layers
    expected = {"K1": 0, "K2": nv * tower_calls["clip_vision"] + nt * tower_calls["clip_text"]}
    if torch.device(device).type != "cuda":
        expected["K2"] = 0
    out = {**times, "image_top": image_top[:3], "upload_first": image_top[:1] == [ids[0][1]], "text_results": text_n}
    ok = out["upload_first"] and text_n == 10
    for r in range(2):
        rows = np.asarray(store.get(ids=ids[r], include=["embeddings"])["embeddings"], np.float32)
        lands_pruned, patchable = _expected_patches(hosts[r], rows)  # the state the round met
        before, uploaded, searched = stats[2 * r], stats[2 * r + 1], stats[2 * r + 2]
        dropped = patchable < IVF_UPLOADS
        rnd = {
            "uploads_land_in_pruned_cluster": lands_pruned,
            "uploads_patched": uploaded["patched_mutations"] - before["patched_mutations"],
            "expected_patched": patchable,
            "index_drops": uploaded["rebuild_mutations"] - before["rebuild_mutations"],
            "ivf_after_search": searched["ivf"],
        }
        out[f"round_{r}"] = rnd
        ok = ok and (
            rnd["uploads_patched"] == patchable
            and rnd["index_drops"] == dropped
            and (not dropped or searched["ivf"]["last_mode"] == "repair")
        )
    out["expected_patched"] = sum(out[f"round_{r}"]["expected_patched"] for r in range(2))
    out.update(k_means_runs=trains["n"], tower_calls=tower_calls, launches=launches, expected_launches=expected)
    del state
    gc.collect()
    shutil.rmtree(root, ignore_errors=True)
    ok = (
        ok
        and out["expected_patched"] >= 1
        and trains["n"] == 0
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
    out, ok, launches = {}, True, {"K1": 0, "K1_mma": 0, "K1_fp32": 0}

    def engine_check(store, ref_answers, tag, p):
        """The store's Q = 1 and 16 answers against ``ref_answers`` and its
        K1 launches an engine call (counted here for the kernels line)."""
        nonlocal ok
        store.query(queries[:1], n_results=10)  # the build
        row = {}
        for nq in (1, 16):
            _sync(device)
            k1, mma, f32 = tile_max.launches, tile_max.mma_launches, tile_max.fp32_mq_launches
            got = store.query(queries[:nq], n_results=10)
            _sync(device)
            calls = tile_max.launches - k1
            launches["K1_mma"] += tile_max.mma_launches - mma
            launches["K1_fp32"] += tile_max.fp32_mq_launches - f32
            launches["K1"] += calls - (tile_max.mma_launches - mma) - (tile_max.fp32_mq_launches - f32)
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
    return {"launches": {"K1": k1["K1"], "K1_mma": k1["K1_mma"], "K1_fp32": k1["K1_fp32"], "K2": http["launches"]["K2"]}}


# -- phase 8f ----------------------------------------------------------------

OPS_FOLDER = 32  # frames of the client's batched folder upload
OPS_INGEST = 64  # frames ingest_folder reads from disk
OPS_DECODE = 64  # frames a decode timing takes, PNG and JPEG each
OPS_MIGRATE_ROWS = 16384  # live Chroma rows with WAL vectors
OPS_MIGRATE_PRUNED = 64  # live rows pruned from the WAL: --reembed embeds them
# stress_sharded_store's rows (its default 100_000 until the scale phase
# came: the run's time limit) and its default width
OPS_STRESS = (50_000, 256)


def gray16_frame(h: int = 48, w: int = 64):
    """A 16-bit grayscale frame whose high byte spans the whole range."""
    import numpy as np

    rng = np.random.default_rng(16)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 65535 // max(w - 1, 1) + yy * 97).astype(np.int64)
    return np.clip(base + rng.integers(-300, 301, (h, w)), 0, 65535).astype(np.uint16)


def _encoded(img, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def decoder_check(device) -> tuple:
    """(a) The native decode pool: its state (and what is missing where it
    is not built); the format grid, each frame equal to PIL's pixels and
    the 16-bit PNG to its high byte in all three channels; 64 PNGs and 64
    JPEGs at 240x320 decoded by the pool and by a PIL thread pool."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    from imatch_tpu_torch.runtime import loader as loader_mod

    loader = loader_mod.NativeImageLoader()
    out = {"native": loader.native, "threads": loader.threads}
    log(f"decoder: NativeImageLoader().native = {loader.native}")
    if not loader.native:
        report = loader_mod.toolchain_report()
        missing = [h for h, ok in report["headers"].items() if not ok]
        log(
            "decoder: the native pool is not built here, uploads decode with PIL: "
            f"g++ {report['g++'] or 'missing'}, headers missing {missing or 'none'}, "
            f"build error {report['build_error']!r}"
        )
        out["toolchain"] = report
    rgb = np.asarray(Image.open(io.BytesIO(synthetic_png(110, 60, 80))).convert("RGB"))
    gray = rgb[..., 0]
    rgba = np.concatenate([rgb, rgb[..., :1]], axis=-1)
    pal = Image.fromarray(rgb).quantize(16)
    deep = gray16_frame()
    frames = {
        "gray16-png": _encoded(Image.fromarray(deep), "PNG"),
        "rgb-png": _encoded(Image.fromarray(rgb), "PNG"),
        "rgba-png": _encoded(Image.fromarray(rgba, "RGBA"), "PNG"),
        "la-png": _encoded(Image.fromarray(np.stack([gray, 255 - gray], -1), "LA"), "PNG"),
        "palette-trns-png": _encoded(pal, "PNG", transparency=3),
        "1bit-png": _encoded(Image.fromarray(gray > 127), "PNG"),
        "jpeg-q90": _encoded(Image.fromarray(rgb), "JPEG", quality=90),
        "webp-lossless": _encoded(Image.fromarray(rgb), "WEBP", lossless=True),
    }
    equal = {}
    for name, data in frames.items():
        got = loader.decode_batch([data], on_error="raise")[0]
        if name == "gray16-png" and loader.native:
            want = np.repeat((deep >> 8).astype(np.uint8)[..., None], 3, axis=-1)
        else:
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        equal[name] = got.shape == want.shape and bool((got == want).all())
    out["equal"] = equal

    pngs = [synthetic_png(9100 + i) for i in range(OPS_DECODE)]
    jpegs = [_encoded(Image.open(io.BytesIO(p)).convert("RGB"), "JPEG", quality=90) for p in pngs]

    def pil_rgb(data):
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))

    workers = min(8, os.cpu_count() or 1)
    with ThreadPoolExecutor(workers) as pool:
        for fmt, batch in (("png", pngs), ("jpeg", jpegs)):
            loader.decode_batch(batch[:4])  # warm
            list(pool.map(pil_rgb, batch[:4]))
            t0 = time.perf_counter()
            got = loader.decode_batch(batch, on_error="raise")
            out[f"{fmt}_pool_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / len(batch)
            t0 = time.perf_counter()
            want = list(pool.map(pil_rgb, batch))
            out[f"{fmt}_pil_threads_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / len(batch)
            out[f"{fmt}_batch_equal_pil"] = all(bool((a == b).all()) for a, b in zip(got, want))
    out["pil_threads"] = workers
    loader.close()
    ok = all(equal.values()) and out["png_batch_equal_pil"] and out["jpeg_batch_equal_pil"]
    return out, ok


@contextlib.contextmanager
def counted_tower_classes(vision_cls, text_cls):
    """Forward calls of every module of the two tower classes, counted for a
    ``with`` block (a global hook: the scripts build their own embedders)."""
    import torch

    counts = {"clip_vision": 0, "clip_text": 0}

    def hook(mod, _args):
        if type(mod) is vision_cls:
            counts["clip_vision"] += 1
        elif type(mod) is text_cls:
            counts["clip_text"] += 1

    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        yield counts
    finally:
        handle.remove()


def _launch_window(engine_qs, towers, cfg, device, launches) -> tuple:
    """The K1 and K2 launches a window's engine calls and tower calls imply,
    against the counts read (0 on the CPU, which runs the plain versions)."""
    import torch

    expected = {
        "K1": sum(q == 1 for q in engine_qs),
        "K1_mma": sum(q >= 2 for q in engine_qs),
        "K1_fp32": 0,  # bf16 stores
        "K2": cfg.vision.num_layers * towers["clip_vision"] + cfg.text.num_layers * towers["clip_text"],
    }
    if torch.device(device).type != "cuda":
        expected = dict.fromkeys(expected, 0)
    return expected, launches == expected


def _read_launches():
    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
    from imatch_tpu_torch.ops.kernels.topk import tile_max

    return {
        "K1": tile_max.launches - tile_max.mma_launches - tile_max.fp32_mq_launches,
        "K1_mma": tile_max.mma_launches,
        "K1_fp32": tile_max.fp32_mq_launches,
        "K2": flash_mha.launches,
    }


def _zero_launches():
    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
    from imatch_tpu_torch.ops.kernels.topk import tile_max

    flash_mha.launches = tile_max.launches = tile_max.mma_launches = tile_max.fp32_mq_launches = 0


def client_check(embedder, device, root) -> tuple:
    """(b) The port's app on ``embedder`` over HTTP, driven by the port's
    client.py: health, an upload and its 409, the 16-bit PNG (its id the
    host pHash of its high byte), a batched folder of 32, text, image and
    multimodal searches, 16 texts and 8 images in one request each, a
    metadata edit, a filter with a ``/`` added and deleted, reset. K1 and
    K2 launches held to the engine and tower calls."""
    import shutil

    import numpy as np
    from PIL import Image

    from imatch_tpu_torch.client import ImageMatchClient
    from imatch_tpu_torch.ops.phash import image_id
    from imatch_tpu_torch.pipeline.state import AppState
    from imatch_tpu_torch.runtime.loader import default_loader
    from imatch_tpu_torch.serving.app import create_app

    shutil.rmtree(root, ignore_errors=True)
    files_dir = os.path.join(root, "files")
    os.makedirs(files_dir)
    files = []
    for i in range(OPS_FOLDER + 1):
        path = os.path.join(files_dir, f"frame {i:02d}.png")
        with open(path, "wb") as f:
            f.write(synthetic_png(9200 + i))
        files.append(path)
    deep = gray16_frame()
    deep_path = os.path.join(files_dir, "deep16.png")
    Image.fromarray(deep).save(deep_path)
    if default_loader().native:
        deep_rgb = np.repeat((deep >> 8).astype(np.uint8)[..., None], 3, axis=-1)
    else:  # JAX's PIL fallback: PIL's pixels, stated in (a)
        deep_rgb = np.asarray(Image.open(deep_path).convert("RGB"))
    with environment(IMATCH_CAPTIONER="null"):
        state = AppState(root=os.path.join(root, "app"), embedder=embedder, device=device, autoload=False)
    store = state.store
    counts_of = dict(clip_vision=embedder.model.vision, clip_text=embedder.model.text)
    texts = [TEXT_QUERY] + [f"a photo number {i} of a tool" for i in range(15)]
    times, checks = {}, {}
    with environment(no_proxy="127.0.0.1,localhost", NO_PROXY="127.0.0.1,localhost"), ServerThread(
        create_app(state), port := _free_port()
    ), call_counts(**counts_of) as towers, engine_calls(store) as calls:
        c = ImageMatchClient(f"http://127.0.0.1:{port}", timeout=600)

        def timed(name, fn):
            t0 = time.perf_counter()
            r = fn()
            times[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
            return r

        _sync(device)
        _zero_launches()
        checks["health"] = timed("health", c.health)["status"] == "ok"
        first = timed("upload", lambda: c.upload(files[0], description="first"))
        again = timed("upload_again", lambda: c.upload(files[0]))
        checks["upload_then_409"] = bool(first["success"]) and again.get("duplicate") is True
        first_id = first["metadata"]["id"]
        got = timed("upload_16bit", lambda: c.upload(deep_path))
        checks["16bit_id_is_high_byte_phash"] = got["metadata"]["id"] == image_id(Image.fromarray(deep_rgb))
        folder = timed("folder", lambda: c.upload_folder_batched(files[1:]))
        checks["folder"] = folder["successful"] == OPS_FOLDER and folder["failed"] == 0
        folder_ids = {r["filename"]: r.get("id") for r in folder["results"]}
        text = timed("text_search", lambda: c.search_text(TEXT_QUERY, limit=10))
        image = timed("image_search", lambda: c.search_image(files[1], limit=5))
        checks["image_self_first"] = image[0]["id"] == folder_ids[os.path.basename(files[1])]
        mm = timed("multimodal_search", lambda: c.search_multimodal(files[2], MULTIMODAL_QUERY, limit=5))
        checks["text_and_multimodal"] = len(text) == 10 and len(mm) == 5
        tb = timed("text_batch_16", lambda: c.search_text_batch(texts, limit=10))
        checks["text_batch"] = len(tb) == 16 and [h["id"] for h in tb[0]] == [h["id"] for h in text]
        ib = timed("image_batch_8", lambda: c.search_image_batch(files[1:9], limit=3))
        checks["image_batch_self_first"] = len(ib) == 8 and all(
            row[0]["id"] == folder_ids[os.path.basename(p)] for row, p in zip(ib, files[1:9])
        )
        timed("edit", lambda: c.update_metadata(first_id, "edited"))
        checks["edit"] = c.image(first_id)["description"] == "edited"
        c.add_filter("indoor/outdoor scene")
        listed = "indoor/outdoor scene" in c.filters()
        c.delete_filter("indoor/outdoor scene")
        checks["filter_with_slash"] = listed and "indoor/outdoor scene" not in c.filters()
        timed("reset", c.reset)
        checks["reset"] = c.images() == [] and store.count() == 0
        _sync(device)
        launches = _read_launches()
        tower_calls = dict(towers)
        engine_qs = list(calls)
    expected, launches_ok = _launch_window(engine_qs, tower_calls, embedder.cfg, device, launches)
    out = {
        "checks": checks,
        "times": times,
        "engine_queries": engine_qs,
        "tower_calls": tower_calls,
        "launches": launches,
        "expected_launches": expected,
    }
    del state, store
    gc.collect()
    shutil.rmtree(root, ignore_errors=True)
    return out, all(checks.values()) and launches_ok


def _chroma_db(path, ids, vecs, pruned):
    """A reference deployment's chroma.sqlite3 (Chroma 0.4-0.6 layout): the
    live rows ``ids`` (each a filename), WAL adds with the ``vecs`` of all
    but the ``pruned`` ids."""
    import sqlite3

    os.makedirs(path, exist_ok=True)
    con = sqlite3.connect(os.path.join(path, "chroma.sqlite3"))
    con.executescript(
        """
        CREATE TABLE collections (id TEXT PRIMARY KEY, name TEXT, dimension INTEGER);
        CREATE TABLE segments (id TEXT PRIMARY KEY, type TEXT, scope TEXT, collection TEXT);
        CREATE TABLE embeddings (id INTEGER PRIMARY KEY AUTOINCREMENT, segment_id TEXT,
            embedding_id TEXT, seq_id BLOB, created_at TEXT);
        CREATE TABLE embedding_metadata (id INTEGER, key TEXT, string_value TEXT,
            int_value INTEGER, float_value REAL, bool_value INTEGER);
        CREATE TABLE embeddings_queue (seq_id INTEGER PRIMARY KEY, created_at TEXT,
            operation INTEGER, topic TEXT, id TEXT, vector BLOB, encoding TEXT, metadata TEXT);
        """
    )
    con.execute("INSERT INTO collections VALUES ('col-1', 'image-match', ?)", (vecs.shape[1],))
    con.execute("INSERT INTO segments VALUES ('seg-md', 'urn:chroma:segment/metadata/sqlite', 'METADATA', 'col-1')")
    rows = list(enumerate(ids, start=1))
    con.executemany("INSERT INTO embeddings (id, segment_id, embedding_id) VALUES (?, 'seg-md', ?)", rows)
    con.executemany(
        "INSERT INTO embedding_metadata VALUES (?, 'filename', ?, NULL, NULL, NULL)", [(pk, f"{i}.png") for pk, i in rows]
    )
    pruned = set(pruned)
    con.executemany(
        "INSERT INTO embeddings_queue VALUES (?, '', 0, 'persistent://default/default/col-1', ?, ?, 'FLOAT32', '{}')",
        [(pk, i, vecs[pk - 1].astype("<f4").tobytes()) for pk, i in rows if i not in pruned],
    )
    con.commit()
    con.close()


def scripts_check(embedder, device, root, config=SLICE_CONFIG, migrate_rows=OPS_MIGRATE_ROWS, pruned=OPS_MIGRATE_PRUNED) -> tuple:
    """(c) The operations scripts through their ``main``: init_index twice;
    ingest_folder over 64 frames on disk (its img/s); migrate_from_reference
    from a synthetic Chroma sqlite of ``migrate_rows`` WAL vectors and
    ``pruned`` rows pruned from the WAL, which ``--reembed`` embeds on
    ``device`` (K2); then the migrated directory loaded on ``device``
    answering 16 queries with the brute force's ids. K1 and K2 launches
    held to the engine and tower calls. The scripts run on their default
    device, the card (IMATCH_DEVICE=cpu where ``device`` is the CPU)."""
    import logging
    import shutil

    import numpy as np
    import torch

    from imatch_tpu_torch.index.store import VectorStore
    from imatch_tpu_torch.scripts import ingest_folder, init_index, migrate_from_reference

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out, checks = {}, {}
    device_env = {} if torch.device(device).type == "cuda" else {"IMATCH_DEVICE": "cpu"}
    # init_index, twice
    init_root = os.path.join(root, "init")
    for n in (1, 2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), environment(**device_env):
            rc = init_index.main([init_root])
        text = buf.getvalue()
        checks[f"init_index_{n}"] = rc == 0 and ("initialized empty index" if n == 1 else "existing index") in text
        log(f"init_index run {n}: " + " | ".join(text.strip().splitlines()))
    vision_cls, text_cls = type(embedder.model.vision), type(embedder.model.text)

    # ingest_folder over frames on disk, then migrate --reembed: one window
    frames_dir = os.path.join(root, "frames")
    os.makedirs(frames_dir)
    for i in range(OPS_INGEST):
        with open(os.path.join(frames_dir, f"f{i:03d}.png"), "wb") as f:
            f.write(synthetic_png(9300 + i))
    rng = np.random.default_rng(120)
    dim = embedder.cfg.projection_dim
    n_live = migrate_rows + pruned
    vecs = rng.standard_normal((n_live, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ids = [f"img_{i:06d}" for i in range(n_live)]
    pruned_ids = ids[migrate_rows:]
    mig_root = os.path.join(root, "deploy")
    processed = os.path.join(mig_root, "static", "processed")
    os.makedirs(processed)
    for j, id_ in enumerate(pruned_ids):
        with open(os.path.join(processed, f"{id_}.png"), "wb") as f:
            f.write(synthetic_png(9400 + j))
    _chroma_db(os.path.join(mig_root, "chroma_data"), ids, vecs, pruned_ids)

    ingest_log = []

    class Keep(logging.Handler):
        def emit(self, record):
            ingest_log.append(record.getMessage())

    handler = Keep(logging.INFO)
    ingest_logger = logging.getLogger("imatch.ingest_folder")
    ingest_logger.addHandler(handler)
    level = ingest_logger.level
    ingest_logger.setLevel(logging.INFO)
    env = dict(
        IMATCH_CLIP_CONFIG=config, IMATCH_CAPTIONER="null", IMATCH_SEGMENTER="null", IMATCH_DATA_DIR="index_data", **device_env
    )
    try:
        with environment(**env), counted_tower_classes(vision_cls, text_cls) as towers:
            _sync(device)
            _zero_launches()
            t0 = time.perf_counter()
            rc = ingest_folder.main(
                [frames_dir, "--root", os.path.join(root, "ingest"), "--batch", "64", "--captioner", "null"]
            )
            _sync(device)
            out["ingest_s"] = time.perf_counter() - t0
            out["ingest_img_per_s"] = OPS_INGEST / out["ingest_s"]
            checks["ingest_folder"] = rc == 0 and any(f"done: {OPS_INGEST} indexed, 0 duplicates, 0 errors" in m for m in ingest_log)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                migrate_from_reference.main(
                    ["--chroma-dir", os.path.join(mig_root, "chroma_data"), "--root", mig_root, "--reembed"]
                )
            _sync(device)
            out["migrate_s"] = time.perf_counter() - t0
            text = buf.getvalue()
            summary = json.loads(text[: text.index("\nDone")])
            out["migrate_summary"] = summary
            checks["migrate"] = (
                summary["rows_migrated"] == n_live
                and summary["vectors_from_wal"] == migrate_rows
                and summary["vectors_reembedded"] == pruned
            )
            _sync(device)
            t0 = time.perf_counter()
            store = VectorStore.load(summary["data_dir"], persist=False, device=device)
            _sync(device)
            out["load_s"] = time.perf_counter() - t0
            with engine_calls(store) as calls:
                queries = vecs[:16] + 0.05 * rng.standard_normal((16, dim)).astype(np.float32)
                queries /= np.linalg.norm(queries, axis=1, keepdims=True)
                t0 = time.perf_counter()
                got = store.query(queries, n_results=10)
                out["query16_ms"] = (time.perf_counter() - t0) * 1e3
            _sync(device)
            launches = _read_launches()
            tower_calls = dict(towers)
            engine_qs = list(calls)
    finally:
        ingest_logger.removeHandler(handler)
        ingest_logger.setLevel(level)
    log("ingest_folder: " + " | ".join(ingest_log[-2:]))
    held = store.get(include=["embeddings"])
    mat = torch.as_tensor(np.asarray(held["embeddings"], np.float32))
    brute_s, brute_i = brute_force_topk(torch.as_tensor(queries), mat, torch.ones(mat.shape[0], dtype=torch.bool), 10)
    want = [[held["ids"][j] for j in row] for row in brute_i.tolist()]
    checks["migrated_store_ids_equal_brute_force"] = got["ids"] == want
    checks["reembedded_rows_unit"] = bool(
        np.allclose(np.linalg.norm(mat[-pruned:].numpy(), axis=1), 1.0, atol=1e-3)
    )
    expected, launches_ok = _launch_window(engine_qs, tower_calls, embedder.cfg, device, launches)
    checks["launch_counts"] = launches_ok and (launches["K2"] > 0 or torch.device(device).type != "cuda")
    out.update(checks=checks, engine_queries=engine_qs, tower_calls=tower_calls, launches=launches, expected_launches=expected)
    del store, held, mat
    gc.collect()
    shutil.rmtree(root, ignore_errors=True)
    return out, all(checks.values())


def stress_check(device, n, d) -> tuple:
    """(d) stress_sharded_store at n x d over its 8 logical shards of one
    device: every checkpoint equal to the numpy oracle; its wall time
    and, on the card, its peak memory."""
    import torch

    from imatch_tpu_torch.scripts import stress_sharded_store

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    summary = stress_sharded_store.run(n, d, dev)
    log("stress: " + json.dumps(summary, default=str))
    return summary, summary["ok"]


def phase_ops(embedder, device="cuda", config=SLICE_CONFIG, migrate_rows=OPS_MIGRATE_ROWS, stress=OPS_STRESS) -> dict:
    """Phase 8f: the native decoder, client.py and the operations scripts,
    on slice 1's embedder: (a) the decoder, (b) the app over HTTP through
    the client, (c) init_index, ingest_folder, migrate_from_reference
    --reembed and the migrated store, (d) the sharded stress run. Returns
    the K1 and K2 launches of (b) and (c). (A small config, store and
    stress size on the CPU rehearse the same control flow.)"""
    t0 = time.perf_counter()
    dec, dec_ok = decoder_check(device)
    log("decoder: " + json.dumps(dec))
    cli, cli_ok = client_check(embedder, device, os.path.join("build", "chip_smoke_ops_client"))
    log("client: " + json.dumps(cli))
    scr, scr_ok = scripts_check(embedder, device, os.path.join("build", "chip_smoke_ops_scripts"), config, migrate_rows)
    log("scripts: " + json.dumps(scr))
    gc.collect()
    st, st_ok = stress_check(device, *stress)
    log(f"phase 8f: {time.perf_counter() - t0:.1f} s")
    failed = [name for name, ok in (("decoder", dec_ok), ("client", cli_ok), ("scripts", scr_ok), ("stress", st_ok)) if not ok]
    if failed:
        raise AssertionError(f"phase 8f failed: {failed}")
    launches = {k: cli["launches"][k] + scr["launches"][k] for k in ("K1", "K1_mma", "K2")}
    return {"launches": launches, "stress": st}


# -- phase 8g: training ------------------------------------------------------

TRAIN_CONFIG = "vit-b32"
TRAIN_LR = 1e-5  # the CLI's default
TRAIN_BATCH = 64
TRAIN_SYNTHETIC = 256  # random frames the CLI samples its batches from
TRAIN_STEPS = (4, 5)  # the first run (a checkpoint at 4), then --resume to 5
TRAIN_RESUME_RTOL = 1e-6  # the resumed run's first loss against the uninterrupted state's on its batch
TRAIN_NEXT_RTOL = 1e-4  # the loss one update later (the backward's sums may run in another order)
TRAIN_REPEAT = 10  # steps on one fixed batch of 64 random pairs
TRAIN_MIN_DROP = 1.0  # the repeated batch's loss must fall by at least this (nats)
LONG_BATCH = 32
LONG_STEPS = 3


@contextlib.contextmanager
def captured_log(name):
    """The INFO messages of logger ``name`` inside the block."""
    import logging

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    lg = logging.getLogger(name)
    handler, level = Keep(), lg.level
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)
    try:
        yield lines
    finally:
        lg.removeHandler(handler)
        lg.setLevel(level)


def random_pairs(cfg, batch, g, device) -> tuple:
    """``batch`` random pairs: standard-normal pixels and token ids drawn
    below the eos id, eos-padded from a random length on."""
    import torch

    size, s, eos = cfg.vision.image_size, cfg.text.max_positions, cfg.text.eos_token_id
    px = torch.randn((batch, size, size, 3), generator=g, device=device)
    tok = torch.randint(0, eos, (batch, s), generator=g, device=device)
    ends = torch.randint(2, s, (batch, 1), generator=g, device=device)
    return px, torch.where(torch.arange(s, device=device)[None] >= ends, eos, tok)


def train_cli_check(device, root, config=TRAIN_CONFIG, batch=TRAIN_BATCH) -> tuple:
    """(a) ``train_clip`` through ``train`` (the CLI's body) at vit-b32:
    TRAIN_STEPS[0] steps with ``--ckpt-every`` TRAIN_STEPS[0], then
    ``--resume`` to TRAIN_STEPS[1]. The resumed run re-seeds its sampler,
    so its batch is the first run's first: the uninterrupted state (the
    first run's, in memory) takes a step on that batch, whose loss must
    equal the resumed run's, and both take one more. (b) The uninterrupted
    state then takes TRAIN_REPEAT steps on one fixed batch of random
    pairs (``random_pairs``: the CLI's synthetic texts differ only in a
    number, and random-init towers map its noise frames close to one
    direction, so its loss starts at log(batch) and barely moves): the
    loss must fall by TRAIN_MIN_DROP."""
    import torch

    from imatch_tpu_torch.models.clip.configs import get_config
    from imatch_tpu_torch.parallel.train import make_optimizer, make_train_step
    from imatch_tpu_torch.scripts import train_clip

    ck = os.path.join(root, "ck")
    argv = [
        "--config", config, "--synthetic", str(TRAIN_SYNTHETIC), "--batch", str(batch),
        "--ckpt-every", str(TRAIN_STEPS[0]), "--lr", str(TRAIN_LR), "--ckpt-dir", ck, "--device", device,
    ]
    with captured_log("imatch.train") as lines:
        first = train_clip.train(train_clip.parse_args(argv + ["--steps", str(TRAIN_STEPS[0])]))
        ckpts = sorted(os.listdir(ck))
        args = train_clip.parse_args(argv + ["--steps", str(TRAIN_STEPS[1]), "--resume"])
        second = train_clip.train(args)
    out = {
        "config": config,
        "batch": batch,
        "lr": TRAIN_LR,
        "checkpoints": ckpts,
        "losses": first.losses + second.losses,
        "first_step_ms": 1e3 * first.step_s[0],
        "median_step_ms_after_first": 1e3 * _p50(first.step_s[1:] + second.step_s),
        "save_s": first.save_s + second.save_s,
        "restore_s": second.restore_s,
        "checkpoint_bytes": os.path.getsize(os.path.join(ck, ckpts[-1])),
        "log": [m for m in lines if m.startswith(("resumed", "done"))],
    }
    ok = (
        first.rc == second.rc == 0
        and ckpts == [f"step_{TRAIN_STEPS[0]:08d}.npz"]
        and f"resumed from step {TRAIN_STEPS[0]}" in lines
        and f"done at step {TRAIN_STEPS[1]}" in lines
        and second.state.step == TRAIN_STEPS[1]
        and all(math.isfinite(x) for x in out["losses"])
    )
    cfg = get_config(config)
    pixels, tokens = train_clip.batch_source(args, cfg, torch.device(device))()
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32  # the CLI's
    step = make_train_step(cfg, make_optimizer(lr=args.lr), dtype=dtype)
    state, loss = step(first.state, pixels, tokens)
    losses = [float(loss)]
    resumed, next_resumed = step(second.state, pixels, tokens)
    state, loss = step(state, pixels, tokens)
    losses.append(float(loss))
    with torch.no_grad():
        pairs = zip(state.params.parameters(), resumed.params.parameters())
        diff = max(float((p - q).abs().max()) for p, q in pairs)
    out["resume"] = {
        "loss": losses[0],
        "loss_resumed": second.losses[0],
        "next_loss": losses[1],
        "next_loss_resumed": float(next_resumed),
        "params_max_abs_diff_after_next": diff,
        "rtol": [TRAIN_RESUME_RTOL, TRAIN_NEXT_RTOL],
    }
    ok = ok and abs(losses[0] - second.losses[0]) <= TRAIN_RESUME_RTOL * abs(losses[0])
    ok = ok and abs(losses[1] - float(next_resumed)) <= TRAIN_NEXT_RTOL * abs(losses[1])
    del first, second, resumed
    pixels, tokens = random_pairs(cfg, batch, torch.Generator(device=device).manual_seed(12), device)
    repeat = []
    for _ in range(TRAIN_REPEAT):
        state, loss = step(state, pixels, tokens)
        repeat.append(float(loss))
    out["repeat"] = {"losses": repeat, "drop": repeat[0] - repeat[-1], "min_drop": TRAIN_MIN_DROP}
    ok = ok and out["repeat"]["drop"] >= TRAIN_MIN_DROP
    return out, ok


def long_train_check(device, config=SLICE_CONFIG, batch=LONG_BATCH, steps=LONG_STEPS) -> tuple:
    """(c) ``config`` at full width and depth, bf16, ``steps`` steps at
    ``batch``: the step ms, images/s and peak device memory; then every
    gradient of one more batch finite and non-zero, each layer's q, k and
    v projections included (K2 would leave them without a gradient)."""
    import torch

    from imatch_tpu_torch.models.clip.configs import get_config
    from imatch_tpu_torch.parallel.train import init_train_state, loss_and_grads, make_train_step

    cfg = get_config(config)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    state, tx = init_train_state(0, cfg, device=device)
    dtype = torch.bfloat16 if cuda else torch.float32
    step = make_train_step(cfg, tx, dtype=dtype)
    g = torch.Generator(device=device).manual_seed(13)

    def batch_of():
        return random_pairs(cfg, batch, g, device)

    times, losses = [], []
    for _ in range(steps):
        px, tok = batch_of()
        _sync(device)
        t0 = time.perf_counter()
        state, loss = step(state, px, tok)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    ms = 1e3 * _p50(times[1:])
    loss, grads = loss_and_grads(state.params, *batch_of(), dtype=dtype)
    bad = [n for n, t in grads.items() if not bool(torch.isfinite(t).all()) or not bool(t.any())]
    qkv_zero = []
    for tower in ("vision", "text"):
        d = getattr(cfg, tower).hidden_size
        for i in range(getattr(cfg, tower).num_layers):
            w = grads[f"{tower}.encoder.layers.{i}.qkv.weight"]
            qkv_zero += [f"{tower}.{i}.{'qkv'[j]}" for j in range(3) if not bool(w[j * d : (j + 1) * d].any())]
    out = {
        "config": config,
        "batch": batch,
        "dtype": str(dtype).replace("torch.", ""),
        "step_ms": [1e3 * t for t in times],
        "median_step_ms_after_first": ms,
        "images_per_s": batch / (ms / 1e3),
        "losses": losses + [float(loss)],
        "peak_memory_gb": (torch.cuda.max_memory_allocated() - base) / 1e9 if cuda else None,
        "card_memory_gb": torch.cuda.get_device_properties(0).total_memory / 1e9 if cuda else None,
        "grad_leaves": len(grads),
        "grads_not_finite_or_zero": bad,
        "qkv_grads_zero": qkv_zero,
    }
    ok = not bad and not qkv_zero and all(math.isfinite(x) for x in out["losses"])
    del state, grads
    return out, ok


def k2_grad_check(device) -> tuple:
    """(d) K2's wrapper raises on card inputs that require grad, launching
    nothing; under no_grad the same inputs launch it (a check's launch,
    not counted)."""
    import torch

    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha

    g = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((1, 16, 257, 64), generator=g, device=device, dtype=torch.bfloat16) for _ in range(3))
    k.requires_grad_(True)
    before = flash_mha.launches
    try:
        flash_mha(q, k, v)
        raised = False
    except RuntimeError as e:
        raised = "no backward" in str(e)
    refused = flash_mha.launches == before
    with torch.no_grad():
        out = flash_mha(q, k, v)
    out = {"raised_under_grad": raised, "launched_under_grad": not refused, "no_grad_launches": flash_mha.launches - before, "finite": bool(torch.isfinite(out).all())}
    return out, raised and refused and out["no_grad_launches"] == 1 and out["finite"]


def phase_train(device="cuda", config=TRAIN_CONFIG, batch=TRAIN_BATCH, long_config=SLICE_CONFIG, long_batch=LONG_BATCH) -> dict:
    """Phase 8g: CLIP training on the card — (a) and (b) ``train_cli_check``
    at vit-b32, (c) ``long_train_check`` at ``long_config``, (d)
    ``k2_grad_check``. No K2 launch in (a)-(c): training takes mha_xla.
    (A small config and batch on the CPU rehearse the same control flow.)"""
    import shutil

    import torch

    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha

    t0 = time.perf_counter()
    root = os.path.join("build", "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    before = flash_mha.launches
    cli, cli_ok = train_cli_check(device, root, config, batch)
    log("train cli: " + json.dumps(cli))
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    long, long_ok = long_train_check(device, long_config, long_batch)
    log("train long: " + json.dumps(long))
    k2_launches = flash_mha.launches - before
    k2, k2_ok = k2_grad_check(device) if torch.device(device).type == "cuda" else ({}, True)
    log("train k2: " + json.dumps({**k2, "launches_while_training": k2_launches}))
    log(f"phase 8g: {time.perf_counter() - t0:.1f} s")
    failed = [n for n, good in (("cli", cli_ok), ("long", long_ok), ("k2", k2_ok and k2_launches == 0)) if not good]
    if failed:
        raise AssertionError(f"phase 8g failed: {failed}")
    return {"cli": cli, "long": long}


# -- phase 8h: the model axis -------------------------------------------------

PARALLEL_GRID = (2, 2)  # (data, model): logical shards of cuda:0
PARALLEL_EQ_BATCH = 8  # the fp32 equality step's batch
PARALLEL_LOSS_RTOL = 2e-5  # the (2, 2) loss against one device's (tests/test_parallel.py's bar)
PARALLEL_BATCH = 32  # the bf16 timing's batch, phase 8g's one-device LongCLIP step's
PARALLEL_STEPS = 3
PARALLEL_MD_BATCH = 2
PARALLEL_MD_PROMPT = 12  # prompt ids after BOS
PARALLEL_MD_MIN_COSINE = 0.999  # per row, the mp = 2 prefill logits against one device's
PARALLEL_EMBED_IMAGES = 24
PARALLEL_EMBED_MIN_COSINE = 0.999  # per row, DP = 2 embeddings against one device's
PARALLEL_EMBED_ROWS = 4096  # random unit rows of the store beside the 24 images
PARALLEL_EMBED_SHARD_ROWS = 16  # the 24 frames pad to 32 (pow2_bucket): 16 a data shard
# K2 at a tensor-parallel shard's head count: the Moondream vision tower
# and the LongCLIP towers at mp = 2
K2_TP_CASES = [((2, 8, 729, 72), False), ((4, 8, 257, 64), False), ((4, 6, 248, 64), True)]


def parallel_train_check(device, config=SLICE_CONFIG) -> tuple:
    """(b) ``config`` at full width and depth, one fp32 step (TF32 off) at
    PARALLEL_EQ_BATCH on one device and on the PARALLEL_GRID grid from the
    same seed: the losses within PARALLEL_LOSS_RTOL, the largest parameter
    difference after the step. (c) Then PARALLEL_STEPS bf16 steps at
    PARALLEL_BATCH on each: the median step ms after the first, images/s,
    peak device memory."""
    import torch

    from imatch_tpu_torch.models.clip.configs import get_config
    from imatch_tpu_torch.parallel.mesh import make_mesh
    from imatch_tpu_torch.parallel.sharding import gather_named
    from imatch_tpu_torch.parallel.train import init_train_state, make_train_step

    cfg = get_config(config)
    dp, mp = PARALLEL_GRID
    grid = make_mesh(mp, [device] * (dp * mp))
    g = torch.Generator(device=device).manual_seed(21)
    eq_batch = random_pairs(cfg, PARALLEL_EQ_BATCH, g, device)
    batches = [random_pairs(cfg, PARALLEL_BATCH, g, device) for _ in range(PARALLEL_STEPS)]
    out, snap, kept = {}, None, {}
    for name, mesh in (("one_device", None), ("grid", grid)):
        _sync(device)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        state, tx = init_train_state(0, cfg, mesh=mesh, device=device)
        state, loss = make_train_step(cfg, tx, mesh=mesh)(state, *eq_batch)  # fp32
        row = {"fp32_loss": float(loss)}
        named = dict(state.params.named_parameters())
        if mesh is None:
            snap = {n: p.detach().clone() for n, p in named.items()}
        else:
            with torch.no_grad():
                full = gather_named(named, state.params, device=device)
                row["params_max_abs_diff"] = max(float((full[n] - snap[n]).abs().max()) for n in snap)
            del full
            snap = None
        step = make_train_step(cfg, tx, mesh=mesh, dtype=torch.bfloat16)
        times = []
        for px, tok in batches:
            _sync(device)
            t0 = time.perf_counter()
            state, loss = step(state, px, tok)
            row.setdefault("bf16_losses", []).append(float(loss))
            times.append(time.perf_counter() - t0)
        ms = 1e3 * _p50(times[1:])
        row.update(
            step_ms=[1e3 * t for t in times],
            median_step_ms_after_first=ms,
            images_per_s=PARALLEL_BATCH / (ms / 1e3),
            peak_memory_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
            model_shards=1 + len(state.params.peers),
        )
        out[name] = row
        kept[name] = [state, step]  # (f) traces one more step of each
        del state, named
        gc.collect()
        torch.cuda.empty_cache()
    one, two = out["one_device"]["fp32_loss"], out["grid"]["fp32_loss"]
    out.update(config=config, grid_shape=list(PARALLEL_GRID), rtol=PARALLEL_LOSS_RTOL, loss_rel_diff=abs(two - one) / abs(one))
    losses = out["one_device"]["bf16_losses"] + out["grid"]["bf16_losses"] + [one, two]
    ok = out["loss_rel_diff"] <= PARALLEL_LOSS_RTOL and all(math.isfinite(x) for x in losses)
    return out, ok, kept


def k2_held(q, k, v, causal=False) -> tuple:
    """K2 on inputs captured from a path, against ``flash_mha_plain`` in
    fp32 on the same inputs: (largest error, within the bf16 bar)."""
    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha, flash_mha_plain

    got = flash_mha(q, k, v, causal=causal)
    ref = flash_mha_plain(q.float(), k.float(), v.float(), causal=causal)
    err = (got.float() - ref).abs()
    return float(err.max()), bool((err <= BF16_ATOL + BF16_RTOL * ref.abs()).all())


def k34_held(kernel, args) -> dict:
    """K3 (``args`` = (x,)) or K4 (x, gamma, beta, eps) on inputs captured
    from a path, against its plain version on the same inputs, with
    ``k34_case``'s bars."""
    import torch

    from imatch_tpu_torch.ops.kernels import quantize

    if kernel == "K3":
        run, plain, frac_bar = quantize.quant_rows, quantize.quant_rows_plain, 1e-3
    else:
        run, plain, frac_bar = quantize.ln_quant_rows, quantize.ln_quant_rows_plain, 2e-3
    q, s = run(*args)
    torch.cuda.synchronize()
    qr, sr = plain(*args)
    diff = (q.int() - qr.int()).abs()
    row = {
        "kernel": kernel,
        "shape": list(args[0].shape),
        "max_abs_err": int(diff.max()),
        "codes_differing": float((diff != 0).float().mean()),
        "scale_max_rel_err": float(((s - sr).abs() / sr.abs()).max()),
    }
    row["ok"] = row["max_abs_err"] <= 1 and row["codes_differing"] < frac_bar and row["scale_max_rel_err"] <= 1e-6
    return row


def parallel_md_check(device, config=MD_CONFIG) -> tuple:
    """(d) ``config`` bf16 (seeded weights) over 2 logical model shards
    against one device: the vision tower, projector and prefill at
    PARALLEL_MD_BATCH; the last logits' per-row cosine and argmax. K2's
    launches in the sharded encode are counted (each at (B, 16 / 2, 729,
    72)); the first launch's inputs, captured, are held against
    ``flash_mha_plain`` after the count."""
    import torch

    from imatch_tpu_torch.models.moondream.configs import get_md_config
    from imatch_tpu_torch.models.moondream.generate import prefill
    from imatch_tpu_torch.models.moondream.model import encode_image_features, init_random
    from imatch_tpu_torch.ops import attention
    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
    from imatch_tpu_torch.parallel.sharding import shard_model

    cfg = get_md_config(config)
    one = init_random(cfg, seed=0, device=device, dtype=torch.bfloat16)
    tp = shard_model(one, [device, device])
    g = torch.Generator(device=device).manual_seed(31)
    size = cfg.vision.image_size
    px = torch.randn((PARALLEL_MD_BATCH, size, size, 3), generator=g, device=device)
    tok = torch.randint(0, cfg.text.vocab_size, (PARALLEL_MD_BATCH, 1 + PARALLEL_MD_PROMPT), generator=g, device=device)
    tok[:, 0] = cfg.text.bos_token_id
    shapes, captured = set(), []
    served = attention.flash_mha

    def watch(q, k, v, **kw):
        shapes.add(tuple(q.shape))
        if not captured:
            captured.append((q.clone(), k.clone(), v.clone()))
        return served(q, k, v, **kw)

    def run(model):
        return prefill(model, encode_image_features(model, px), tok)[0]

    attention.flash_mha = watch
    try:
        flash_mha.launches = 0
        got = run(tp)
        _sync(device)
        launches = flash_mha.launches
    finally:
        attention.flash_mha = served
    want = run(one)
    k2_err, k2_ok = k2_held(*captured[0])
    _, tp_ms = _timed(lambda: run(tp), device, iters=2)
    _, one_ms = _timed(lambda: run(one), device, iters=2)
    cos = torch.nn.functional.cosine_similarity(got.float(), want.float(), dim=-1)
    out = {
        "config": config,
        "model_shards": 2,
        "batch": PARALLEL_MD_BATCH,
        "logits_cosine": [float(c) for c in cos],
        "argmax_equal": bool(torch.equal(got.argmax(-1), want.argmax(-1))),
        "k2_launches": launches,
        "k2_shapes": sorted(map(list, shapes)),
        "k2_max_abs_err_on_path_inputs": k2_err,
        "encode_prefill_ms": {"mp2": tp_ms, "one_device": one_ms},
    }
    ok = (
        bool(torch.isfinite(got).all())
        and float(cos.min()) >= PARALLEL_MD_MIN_COSINE
        and k2_ok
        and launches == 2 * cfg.vision.num_layers
        and shapes == {(PARALLEL_MD_BATCH, cfg.vision.num_heads // 2, cfg.vision.num_patches, cfg.vision.head_dim)}
    )
    del one, tp
    return out, ok


def parallel_embed_check(device, config=SLICE_CONFIG) -> tuple:
    """(e) ``ClipEmbedder(mesh=[device] * 2)`` against one device at
    ``config``, bf16 and W8A8, on PARALLEL_EMBED_IMAGES photo frames: the
    per-row cosine, and the top-10 ids of each frame's query in a store of
    the one-device embeddings and PARALLEL_EMBED_ROWS random unit rows,
    equal for every frame. K2 (and K3/K4 for W8A8) launch on each data
    shard at PARALLEL_EMBED_SHARD_ROWS frames; the first launch of each
    kernel (and of K3 at each width) is captured and held against its
    plain version after the count."""
    import numpy as np
    import torch

    from imatch_tpu_torch.index.store import VectorStore
    from imatch_tpu_torch.models.clip import quant as w8a8
    from imatch_tpu_torch.ops import attention
    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
    from imatch_tpu_torch.ops.kernels.quantize import ln_quant_rows, quant_rows
    from imatch_tpu_torch.pipeline.embedder import ClipEmbedder

    frames = [photo_frame(600 + i, 240, 320) for i in range(PARALLEL_EMBED_IMAGES)]
    out, ok, launches = {}, True, {"K2": 0, "K3": 0, "K4": 0}
    served = {"K2": attention.flash_mha, "K3": w8a8.quant_rows_int8, "K4": w8a8.ln_quant_rows_int8}
    for quant in ("", "int8"):
        one = ClipEmbedder(config, device=device, quant=quant)
        dp = ClipEmbedder(config, mesh=[device, device], quant=quant)
        shapes, captured = {k: set() for k in served}, {}

        def watcher(kernel):
            def watch(*args, **kw):
                x = args[0]
                shapes[kernel].add(tuple(x.shape))
                key = (kernel, x.shape[-1])
                if key not in captured:
                    captured[key] = ([a.clone() if torch.is_tensor(a) else a for a in args], kw)
                return served[kernel](*args, **kw)

            return watch

        attention.flash_mha = watcher("K2")
        w8a8.quant_rows_int8, w8a8.ln_quant_rows_int8 = watcher("K3"), watcher("K4")
        try:
            flash_mha.launches = quant_rows.launches = ln_quant_rows.launches = 0
            got = dp.embed_images(frames)
            _sync(device)
            counts = {"K2": flash_mha.launches, "K3": quant_rows.launches, "K4": ln_quant_rows.launches}
        finally:
            attention.flash_mha = served["K2"]
            w8a8.quant_rows_int8, w8a8.ln_quant_rows_int8 = served["K3"], served["K4"]
        held = []
        for (kernel, width), (args, kw) in sorted(captured.items()):
            if kernel == "K2":
                err, good = k2_held(*args, **kw)
                held.append({"kernel": "K2", "shape": list(args[0].shape), "max_abs_err": err, "ok": good})
            else:
                held.append(k34_held(kernel, args))
        want = one.embed_images(frames)
        cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
        rng = np.random.default_rng(5)
        noise = rng.standard_normal((PARALLEL_EMBED_ROWS, want.shape[1])).astype(np.float32)
        noise /= np.linalg.norm(noise, axis=1, keepdims=True)
        store = VectorStore(dim=want.shape[1], device=device, score_dtype="float32")
        store.add(ids=[f"r{i}" for i in range(len(noise) + len(want))], embeddings=np.concatenate([want, noise]))
        ids = [store.query(e, n_results=10)["ids"] for e in (got, want)]
        same = [a == b for a, b in zip(*ids)]
        top1 = all(r[0] == f"r{i}" for i, r in enumerate(ids[0]))
        name = quant or "bf16"
        vc = dp.cfg.vision
        layers = vc.num_layers
        rows = PARALLEL_EMBED_SHARD_ROWS
        want_shapes = {"K2": {(rows, vc.num_heads, vc.seq_len, vc.head_dim)}}
        want_counts = {"K2": 2 * layers}  # one tower call a data shard
        if quant:  # ln1, ln2 (K4); the attention output, gelu(fc1) (K3): per layer
            want_shapes.update(K3={(rows, vc.seq_len, vc.hidden_size), (rows, vc.seq_len, vc.mlp_size)}, K4={(rows, vc.seq_len, vc.hidden_size)})
            want_counts.update(K3=2 * 2 * layers, K4=2 * 2 * layers)
        row_ok = (
            float(cos.min()) >= PARALLEL_EMBED_MIN_COSINE
            and all(same)
            and top1
            and all(counts[k] == n for k, n in want_counts.items())
            and all(shapes[k] == v for k, v in want_shapes.items())
            and len(held) == sum(len(v) for v in want_shapes.values())
            and all(h["ok"] for h in held)
        )
        out[name] = {
            "min_cosine": float(cos.min()),
            "mean_cosine": float(cos.mean()),
            "top10_ids_equal": sum(same),
            "top1_is_self": top1,
            "launches": counts,
            "launch_shapes": {k: sorted(map(list, v)) for k, v in shapes.items() if v},
            "held_on_path_inputs": held,
            "ok": row_ok,
        }
        ok = ok and row_ok
        for k in launches:
            launches[k] += counts[k]
        del one, dp, store, captured
        gc.collect()
        torch.cuda.empty_cache()
    out["images"] = PARALLEL_EMBED_IMAGES
    return out, ok, launches


def parallel_trace_check(device, train, kept, config=SLICE_CONFIG) -> dict:
    """(f) Where a bf16 step's time goes on one device and on the
    PARALLEL_GRID grid: one more step at PARALLEL_BATCH of (c)'s states
    (``kept``: each state and its bf16 step) traced (``device_busy``), its
    device busy ms, device operations, the idle share against (c)'s median
    step ms and the five kernels that take the most time. Last in the
    phase: a profiler session slows the host's later launches."""
    import torch

    from imatch_tpu_torch.models.clip.configs import get_config

    cfg = get_config(config)
    px, tok = random_pairs(cfg, PARALLEL_BATCH, torch.Generator(device=device).manual_seed(22), device)
    out = {}
    for name in ("one_device", "grid"):
        holder = kept.pop(name)

        def one_step():
            holder[0], _ = holder[1](holder[0], px, tok)

        out[name] = device_busy(one_step, train[name]["median_step_ms_after_first"], iters=1, top=5)
        del holder
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_parallel(device="cuda") -> dict:
    """Phase 8h: the model axis on logical shards of the card. (a) K2 at
    the split-head shapes (K2_TP_CASES) against its plain version; (b, c)
    ``parallel_train_check``; (d) ``parallel_md_check``; (e)
    ``parallel_embed_check``; (f) ``parallel_trace_check``. No run over
    several real cards takes place: the machine holds one."""
    import torch

    t0 = time.perf_counter()
    seconds = {}

    def mark(part):
        seconds[part] = round(time.perf_counter() - t0 - sum(seconds.values()), 1)

    k2_rows = [k2_case(shape, causal, torch.bfloat16) for shape, causal in K2_TP_CASES]
    mark("a")
    # vit-b32: phase 8i (d) steps LongCLIP-L on the (2, 2) grid
    train, train_ok, kept = parallel_train_check(device, config=TRAIN_CONFIG)
    log("parallel train: " + json.dumps(train))
    mark("b, c")
    md, md_ok = parallel_md_check(device)
    log("parallel moondream: " + json.dumps(md))
    gc.collect()
    torch.cuda.empty_cache()
    mark("d")
    embed, embed_ok, launches = parallel_embed_check(device)
    log("parallel embedder: " + json.dumps(embed))
    mark("e")
    log("parallel trace: " + json.dumps(parallel_trace_check(device, train, kept, config=TRAIN_CONFIG)))
    mark("f")
    log(f"phase 8h: {time.perf_counter() - t0:.1f} s (by part: {seconds}); {torch.cuda.device_count()} "
        "card(s) visible, so no run over several real cards took place")
    failed = [
        n
        for n, good in (
            ("k2", all(r["ok"] for r in k2_rows)),
            ("train", train_ok),
            ("moondream", md_ok),
            ("embedder", embed_ok),
        )
        if not good
    ]
    if failed:
        raise AssertionError(f"phase 8h failed: {failed}")
    return {"k2_rows": k2_rows, "launches": {**launches, "K2_tp": md["k2_launches"]}}


# -- phase 8i: the pipeline, sequence and process axes ------------------------

SCALE_RING_CASES = [((32, 12, 248, 64), (4, 8)), ((1, 16, 16384, 64), (8,))]  # (B, H, S, Dh), ring sizes
SCALE_PIPE = [(2, 4), (4, 8)]  # (stages, microbatches)
SCALE_PIPE_BATCH = 32
SCALE_PIPE_MIN_COSINE = 0.9999  # per (image, token) row, pipelined against the unpipelined encoder
# launch A: the sharded store, ivf-sharded, the TP forward, the embedder, the ring and GPipe
SCALE_MP = {
    "procs": 2, "local-devices": 2, "rows": 1 << 17, "dim": 768, "queries": 16, "k": 10,
    "paths": "sharded,ivf,tp,embed,ring,gpipe", "centres": 1448, "config": "longclip-l14-248",
    "batch": 16, "mp": 2, "ring": "32,12,248,64", "pipe-batch": 32, "microbatches": 4,
}  # fmt: skip
# launch B: two DP + TP steps on the (2, 2) grid and the checkpoint, at
# half LongCLIP-L's depth (12 image, 6 text layers; full width): the run's
# time limit
SCALE_TRAIN = {
    "procs": 4, "paths": "train", "config": "longclip-l14-248", "train-layers": "12,6", "train-batch": 32,
    "steps": 2, "mp": 2, "reference": "caller",
}  # fmt: skip
SCALE_TRAIN_SEED = 0  # the dryrun's --seed: its init and clip_batch(..., seed + 100 + step)
SCALE_TRAIN_RTOL = 1e-6  # launch B's losses against the one-process (2, 2) grid's
SCALE_MP_TIMEOUT = 300
SCALE_MULTICHIP_SHARDS = 8


def _within(got, ref, scale=1.0) -> tuple:
    """(largest error, within ``scale`` times the bf16 bar of ``ref``)."""
    err = (got.float() - ref.float()).abs()
    return float(err.max()), bool((err <= scale * (BF16_ATOL + BF16_RTOL * ref.float().abs())).all())


def ring_check(device) -> tuple:
    """(a) Causal bf16 ring attention over P logical shards of the card.
    At SCALE_RING_CASES' first shape: against the fp32 plain version (the
    bf16 bar), K2 on the whole sequence (the bar: both round the same fp32
    function to bf16) and ``mha_xla`` (twice the bar: its logits and
    probabilities are rounded to bf16). At the long shape, whose fp32
    logits would not be held, against K2. Each case timed (CUDA events),
    K2 beside it, and the ring's peak memory above its inputs."""
    import torch

    from imatch_tpu_torch.ops.attention import mha_xla
    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha, flash_mha_plain
    from imatch_tpu_torch.parallel import make_mesh, ring_attention

    rows, ok = [], True
    for shape, sizes in SCALE_RING_CASES:
        g = torch.Generator(device=device).manual_seed(41)
        q, k, v = (torch.randn(shape, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
        k2 = flash_mha(q, k, v, causal=True)
        exact = flash_mha_plain(q.float(), k.float(), v.float(), causal=True) if shape[2] <= 1024 else None
        k2_ms = time_ms(lambda: flash_mha(q, k, v, causal=True), iters=5)
        logits_gb = shape[0] * shape[1] * shape[2] ** 2 * 4 / 1e9
        for p in sizes:
            mesh = make_mesh(p, [device] * p)

            def ring():
                return ring_attention(q, k, v, mesh=mesh, axis="model", causal=True)

            _sync(device)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            got = ring()
            _sync(device)
            peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
            row = {"shape": list(shape), "ring_size": p, "causal": True, "dtype": "bfloat16"}
            row["max_abs_err_vs_k2"], good = _within(got, k2)
            if exact is not None:
                row["max_abs_err_vs_fp32"], g1 = _within(got, exact)
                row["max_abs_err_vs_mha_xla"], g2 = _within(got, mha_xla(q, k, v, causal=True), scale=2.0)
                good = good and g1 and g2
            row.update(
                ring_ms=time_ms(ring, iters=3, warmup=1),
                k2_whole_ms=k2_ms,
                peak_memory_gb=peak_gb,
                full_logits_fp32_gb=logits_gb,
                finite=bool(torch.isfinite(got).all()),
                ok=good and bool(torch.isfinite(got).all()),
            )
            ok = ok and row["ok"]
            rows.append(row)
            del got
        del q, k, v, k2, exact
        torch.cuda.empty_cache()
    return rows, ok


def gpipe_check(device, config=SLICE_CONFIG) -> tuple:
    """(b) The image tower's encoder layers of ``config`` (seeded bf16
    weights), no grad, on SCALE_PIPE_BATCH random rows: unpipelined, then
    ``gpipe_scan`` over each SCALE_PIPE (stages, microbatches) on logical
    shards of the card. K2's launches in each pipelined run are counted
    (the main path's) and must be layers x M; the first launch at each
    microbatch shape is captured and held against its plain version."""
    import torch

    from imatch_tpu_torch.models.clip.configs import get_config
    from imatch_tpu_torch.models.clip.model import init_random
    from imatch_tpu_torch.ops import attention
    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
    from imatch_tpu_torch.parallel import gpipe_scan, make_mesh

    cfg = get_config(config)
    vc = cfg.vision
    g = torch.Generator(device=device).manual_seed(43)
    encoder = init_random(cfg, device=device, dtype=torch.bfloat16, generator=g).vision.encoder
    x = torch.randn((SCALE_PIPE_BATCH, vc.seq_len, vc.hidden_size), generator=g, device=device).to(torch.bfloat16)

    def body(h, layer):
        return layer(h, False), None

    out, ok, launches = {"config": config, "layers": vc.num_layers, "batch": SCALE_PIPE_BATCH}, True, 0
    with torch.no_grad():
        ref, out["unpipelined_ms"] = _timed(lambda: encoder(x, causal=False), device)
        served, captured = attention.flash_mha, {}

        def watch(q, k, v, **kw):
            captured.setdefault(tuple(q.shape), (q.clone(), k.clone(), v.clone(), kw))
            return served(q, k, v, **kw)

        for p, m in SCALE_PIPE:
            mesh = make_mesh(p, [device] * p)

            def pipe():
                return gpipe_scan(body, x, encoder.layers, mesh=mesh, axis="model", microbatches=m)

            attention.flash_mha = watch
            try:
                flash_mha.launches = 0
                got = pipe()
                _sync(device)
                n = flash_mha.launches
            finally:
                attention.flash_mha = served
            launches += n
            cos = torch.nn.functional.cosine_similarity(got.float().flatten(0, 1), ref.float().flatten(0, 1), dim=-1)
            shape = (SCALE_PIPE_BATCH // m, vc.num_heads, vc.seq_len, vc.head_dim)
            q, k, v, kw = captured[shape]
            err, held = k2_held(q, k, v, **kw)
            row = {
                "stages": p,
                "microbatches": m,
                "k2_launches": n,
                "k2_launches_want": vc.num_layers * m,
                "k2_shape": list(shape),
                "k2_max_abs_err_on_path_inputs": err,
                "min_cosine": float(cos.min()),
                "max_abs_diff": float((got.float() - ref.float()).abs().max()),
                "ms": _timed(pipe, device)[1],
                "bubble_fraction": (p - 1) / (m + p - 1),
            }
            row["ok"] = n == vc.num_layers * m and held and row["min_cosine"] >= SCALE_PIPE_MIN_COSINE
            ok = ok and row["ok"]
            out[f"p{p}_m{m}"] = row
            del got
    del encoder, x, ref
    return out, ok, launches


def _max_rss_gb() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _scale_out(cfg) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", f"chip_smoke_scale_{cfg['procs']}")


def multiprocess_start(cfg=SCALE_MP):
    """A launch of the port's multi-process dryrun on the card, started:
    its launcher and workers load the kernels phase 2 built, and keep
    their files (launch B's checkpoint) under build/. The launcher stops
    its workers at SCALE_MP_TIMEOUT."""
    cmd = [sys.executable, "-m", "imatch_tpu_torch.scripts.dryrun_multiprocess", "--device", "cuda"]
    cmd += [a for key, val in cfg.items() for a in ((f"-{key}" if key == "k" else f"--{key}"), str(val))]
    cmd += ["--timeout", str(SCALE_MP_TIMEOUT), "--out", _scale_out(cfg)]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, start_new_session=True
    )
    proc.session = True  # ``_stop`` kills its workers with it
    return proc


def _stop(proc) -> None:
    """``proc`` killed if it still runs; a launch (a session of its own,
    ``multiprocess_start``) with every process in it, so that no worker
    outlives this script."""
    if getattr(proc, "session", False):
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:  # the launch and its workers are gone
            pass
    elif proc.poll() is None:
        proc.kill()
    proc.wait()


def _held_at(row, shape) -> bool:
    """K2 launched on the path, and its launch at ``shape`` held against
    its plain version."""
    held = row.get("k2_held", {}).get("x".join(map(str, shape)))
    return row.get("k2_launches", 0) > 0 and held is not None and held["ok"]


def _paths_ok(w) -> bool:
    """Launch A's paths as the contract reads them, beside the worker's
    own checks: K1 in the sharded path, K2 at the TP shard's, the
    embedder's data shard's and GPipe's microbatch shapes, GPipe's launch
    count, the ring's equality."""
    vc_heads, seq = 16, 257  # LongCLIP-L/14-248's image tower
    per = SCALE_MP["batch"] // SCALE_MP["procs"]
    mb = SCALE_MP["pipe-batch"] // SCALE_MP["microbatches"]
    return (
        w["k1_launches"] + w["k1_mma_launches"] > 0
        and w["ivf"]["sidecar_modes"] == ["repair", "repair"]
        and _held_at(w["tp"], (SCALE_MP["batch"], vc_heads // SCALE_MP["mp"], seq, 64))
        and w["tp"]["min_cosine"] >= 0.9999 and w["tp"]["top10_equal"]
        and _held_at(w["embed"], (per, vc_heads, seq, 64)) and w["embed"]["top10_equal_one_device"]
        and w["ring"]["equal"]
        and w["gpipe"]["equal"] and w["gpipe"]["grad_refused"]
        and _held_at(w["gpipe"], (mb, vc_heads, seq, 64))
        and w["gpipe"]["k2_launches"] == 24 // SCALE_MP["procs"] * SCALE_MP["microbatches"]
    )  # fmt: skip


def multiprocess_finish(proc, cfg=SCALE_MP, keep=False) -> tuple:
    """A launch's output read: each worker's JSON line, and whether it
    passed (rc 0, the OK line, every worker's line, and for launch A the
    paths' launches and checks, ``_paths_ok``). Its files are removed
    unless ``keep``."""
    try:
        stdout, stderr = proc.communicate(timeout=SCALE_MP_TIMEOUT + 60)
    finally:
        _stop(proc)
        if not keep:
            shutil.rmtree(_scale_out(cfg), ignore_errors=True)
    workers = {}
    for line in stdout.splitlines():
        if line.startswith("[proc ") and "] {" in line:
            head, body = line.split("] ", 1)
            workers[int(head[len("[proc ") :])] = json.loads(body)
    ok = (
        proc.returncode == 0
        and "MULTIPROCESS DRYRUN OK" in stdout
        and sorted(workers) == list(range(cfg["procs"]))
        and (cfg is not SCALE_MP or all(_paths_ok(w) for w in workers.values()))
    )
    if not ok:  # each worker's errors, then the end of the output
        log("\n".join(line for line in stdout.splitlines() if "Error" in line or "exited" in line)[-6000:])
        log(stdout[-4000:] + stderr[-4000:])
    return {"rc": proc.returncode, "config": cfg, "workers": workers}, ok


def scale_train_reference(device) -> tuple:
    """(d)'s one-process answer: SCALE_TRAIN's steps on the (2, 2) grid of
    logical shards of the card, from launch B's seed and batches (the
    dryrun's ``clip_batch``), bf16 over fp32 masters. Returns its losses
    and step ms."""
    import torch

    from imatch_tpu_torch.parallel import init_train_state, make_train_step
    from imatch_tpu_torch.parallel.mesh import Grid
    from imatch_tpu_torch.parallel.train import make_optimizer
    from imatch_tpu_torch.scripts.dryrun_multiprocess import clip_batch, train_config

    cfg, mp = train_config(SCALE_TRAIN["config"], SCALE_TRAIN["train-layers"]), SCALE_TRAIN["mp"]
    tx = make_optimizer()
    grid = Grid([device] * SCALE_TRAIN["procs"], mp)
    state, _ = init_train_state(SCALE_TRAIN_SEED, cfg, tx, mesh=grid)
    step = make_train_step(cfg, tx, mesh=grid, dtype=torch.bfloat16)
    out = {"losses": [], "step_ms": []}
    for i in range(SCALE_TRAIN["steps"]):
        px, tok = clip_batch(cfg, SCALE_TRAIN["train-batch"], SCALE_TRAIN_SEED + 100 + i)
        t = time.perf_counter()
        state, loss = step(state, px, tok)
        out["losses"].append(float(loss))
        out["step_ms"].append((time.perf_counter() - t) * 1e3)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def scale_train_finish(proc, ref) -> tuple:
    """(d) read, after the phases that run while launch B saves and
    restores: its workers' lines (process 0's restore at mp = 1 held to
    the saved state bit for bit, their own check), and every worker's
    losses within SCALE_TRAIN_RTOL of the one-process grid's ``ref``."""
    train, ok = multiprocess_finish(proc, SCALE_TRAIN)
    losses = [w["train"]["losses"] for w in train["workers"].values()]
    ok = ok and bool(losses) and all(
        abs(a - b) <= SCALE_TRAIN_RTOL * abs(b) for got in losses for a, b in zip(got, ref["losses"])
    )
    train["one_process"] = ref
    return train, ok


def phase_scale(ctx, device="cuda") -> dict:
    """Phase 8i: launches A and B started together; in this process while
    they run, ``scale_train_reference``, dryrun_multichip over
    SCALE_MULTICHIP_SHARDS logical shards of the card (its K1 and K2
    launches counted; launch A's log says whether its timings began after
    it ended), ``ring_check`` and ``gpipe_check``; launch A read. Launch B
    runs on through the next phases (its save and restore) and is read by
    the step ``scale_train`` (``ctx["scale_train"]``: its process and the
    one-process answer). Every timing in the phase shares the card and the
    host with the other parts running then. Each part raises on failure;
    none is caught."""
    import torch

    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
    from imatch_tpu_torch.ops.kernels.topk import tile_max
    from imatch_tpu_torch.scripts._common import card
    from imatch_tpu_torch.scripts.dryrun_multichip import dryrun_multichip

    t0 = time.perf_counter()
    log(f"phase 8i on {card(torch.device(device))}; this process's peak host memory so far {_max_rss_gb():.2f} GB")
    proc, train_proc = multiprocess_start(), multiprocess_start(SCALE_TRAIN)
    ctx["background"].append(train_proc)  # stopped by main if a later phase fails
    try:
        try:
            # while the workers start: (d)'s one-process answer, then dryrun_multichip
            ref = scale_train_reference(torch.device(device))
            ref["seconds"] = time.perf_counter() - t0
            before = (tile_max.launches, tile_max.mma_launches, flash_mha.launches)
            chip = dryrun_multichip(SCALE_MULTICHIP_SHARDS, device)
            _sync(device)
            chip_ended = time.time()
            chip["seconds"] = time.perf_counter() - t0
            k1, k1_mma, k2 = (a - b for a, b in zip((tile_max.launches, tile_max.mma_launches, flash_mha.launches), before))
            ring, ring_ok = ring_check(device)
            log("scale ring: " + json.dumps(ring))
            gc.collect()
            torch.cuda.empty_cache()
            pipe, pipe_ok, k2_pipe = gpipe_check(device)
            log("scale gpipe: " + json.dumps(pipe))
        finally:
            mp, mp_ok = multiprocess_finish(proc)
        chip.update(k1_launches=k1, k1_mma_launches=k1_mma, k2_launches=k2)
        log("scale multichip: " + json.dumps(chip))
        if k1 + k1_mma == 0 or k2 == 0:
            raise AssertionError("phase 8i failed: dryrun_multichip launched no K1 or no K2")
        mp["seconds"] = time.perf_counter() - t0
        mp["timings_after_multichip"] = all(w.get("timing_started_at", 0) > chip_ended for w in mp["workers"].values())
        log("scale multiprocess: " + json.dumps(mp))
        if not mp_ok:
            raise AssertionError("phase 8i (a)-(c), (e) failed: launch A of the multi-process dryrun")
    except BaseException:
        multiprocess_finish(train_proc, SCALE_TRAIN)
        raise
    ctx["scale_train"] = (train_proc, ref, t0)
    if not ring_ok:
        raise AssertionError("phase 8i failed: ring attention in one process")
    if not pipe_ok:
        raise AssertionError("phase 8i failed: gpipe in one process")
    log(f"phase 8i: {time.perf_counter() - t0:.1f} s, launch B running on; {torch.cuda.device_count()} card(s) visible")
    workers = mp["workers"].values()
    k2_mp = sum(w[p]["k2_launches"] for w in workers for p in ("tp", "embed", "gpipe"))
    return {
        "K1": k1 + sum(w["k1_launches"] for w in workers),
        "K1_mma": k1_mma + sum(w["k1_mma_launches"] for w in workers),
        "K2": k2_pipe + k2 + k2_mp,
    }


@contextlib.contextmanager
def fp32_k2_window():
    """K2's fp32 kernel in a ``with`` block: the yielded dict gets its
    launches there (``launches``) and, for the first launch at each shape,
    the captured inputs run again and held against ``flash_mha_plain`` at
    FP32_TOL (``held``: shape, causal, largest error, ok); those launches
    are not counted."""
    import torch

    from imatch_tpu_torch.ops import attention
    from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha, flash_mha_plain

    out, served, captured = {}, attention.flash_mha, {}

    def watch(q, k, v, **kw):
        if q.dtype == torch.float32:
            captured.setdefault((tuple(q.shape), bool(kw.get("causal"))), (q.clone(), k.clone(), v.clone(), kw))
        return served(q, k, v, **kw)

    attention.flash_mha = watch
    before = flash_mha.fp32_launches
    try:
        yield out
    finally:
        attention.flash_mha = served
    out["launches"] = flash_mha.fp32_launches - before
    out["held"] = []
    for (shape, causal), (q, k, v, kw) in captured.items():
        ref = flash_mha_plain(q, k, v, **kw)
        err = (flash_mha(q, k, v, **kw) - ref).abs()
        ok = bool((err <= FP32_TOL + FP32_TOL * ref.abs()).all())
        out["held"].append({"shape": list(shape), "causal": causal, "max_abs_err": float(err.max()), "ok": ok})


def phase_reference() -> int:
    """vit-b32 (depth cut to 2 layers a tower) on the card, bf16 and fp32,
    against the same weights in fp32 on the CPU: per-row cosine of the
    embeddings, and of their deviations from the CPU mean (random-init
    towers map every image close to one direction). The fp32 towers run
    K2's fp32 kernel: its launches are counted (returned) and the first at
    each shape held against the plain version."""
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
        with fp32_k2_window() as k2:
            got = np.concatenate([emb.embed_images(frames), emb.embed_texts(texts)])
        assert got.shape == want.shape and np.isfinite(got).all()
        if dtype == torch.float32:
            log("reference fp32 K2: " + json.dumps(k2))
            if not k2["launches"] or not k2["held"] or not all(h["ok"] for h in k2["held"]):
                raise AssertionError(f"the fp32 towers' K2 launched no fp32 kernel or strays from its plain version: {k2}")
            fp32_launches = k2["launches"]
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
    return fp32_launches


def _cosines(got, want):
    """Per-row cosine of unit embeddings, and of their deviations from the
    reference's mean (random-init towers map every input close to one
    direction, which the raw cosine hides)."""
    import numpy as np

    raw = (got * want).sum(1)
    a, b = got - want.mean(0), want - want.mean(0)
    dev = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    return raw, dev


def phase_w8a8_fidelity(w8a8) -> int:
    """The W8A8 tower (bf16 compute, as served) against the full-fp32
    tower on the same seed's weights, on the card, for 8 frames and for
    the 8 standard-normal pixel inputs the JAX tier's measurement used
    (scripts/exp_w8a8_vit.py); the bf16 tower beside it as the yardstick.
    The gate is the JAX tier's figure as that script computes it: the mean
    cosine over the 8 >= 0.9995, for both input sets; the minimum is
    printed beside it. The fp32 tower runs K2's fp32 kernel: its launches
    are counted (returned) and the first at each shape held against the
    plain version."""
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
        with fp32_k2_window() as k2:
            towers[name] = (
                e.embed_images(frames),
                e._embed_pixels(noise.to(e.compute_dtype)).cpu().numpy(),
            )
        if name == "fp32":
            log(f"fidelity {cfg.name} fp32 tower's K2: " + json.dumps(k2))
            if not k2["launches"] or not k2["held"] or not all(h["ok"] for h in k2["held"]):
                raise AssertionError(f"the fp32 tower's K2 launched no fp32 kernel or strays from its plain version: {k2}")
            fp32_launches = k2["launches"]
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
    return fp32_launches


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


def profile_start(ctx) -> None:
    """Phase 12's process started, to run beside launch B's save and
    restore and phase 9 (its checks read its own app's trace, not a
    time); the step ``profile`` reads it."""
    cmd = [sys.executable, os.path.abspath(__file__), "--child", "profile"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ctx["background"].append(proc)
    ctx["profile"] = (proc, time.perf_counter())


def phase_profile_apart(ctx) -> None:
    """Phase 12 in a process of its own: its check reads the app's profiler
    trace, and this long process's late traces drop events (kernel_ab.py's
    ``trace``). The child loads the kernels phase 2 built; it is the one
    ``profile_start`` started, or one started here."""
    if "profile" not in ctx:
        profile_start(ctx)
    proc, t0 = ctx.pop("profile")
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        _stop(proc)
    sys.stdout.write(stdout)
    sys.stderr.write(stderr[-4000:])
    log(f"phase 12 (own process): rc {proc.returncode}, {time.perf_counter() - t0:.1f} s since its start")
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
    and its HTTP requests their K2 launches. Phase 8h's sharded Moondream
    encode gives the tensor-parallel K2 entry (a shard's (2, 8, 729, 72))
    its launches, and its data-parallel embedder adds its K2, K3 and K4
    launches to those entries. The fp32 kernels (the fidelity paths) have
    entries of their own: K1 at Q >= 2 in fp32 at the batch route's 256
    queries, with the fp32 tier's batch and phase 8e's fp32 sharded calls;
    K2 in fp32 at the image tower's (32, 16, 257, 64), with the launches of
    the fp32 towers of phases 7 (the fidelity check) and 9. An entry whose
    kernel its path never launched fails the run."""

    def pick(table, **want):
        return next(r for r in table if all(r[k] == v for k, v in want.items()))

    k1 = pick(k1_rows, q=1, dtype="bfloat16", tile_n=512)
    k1q16 = pick(k1_rows, q=16, dtype="bfloat16", tile_n=512)
    k1f32 = pick(k1_rows, q=N_BIG_BATCH, dtype="float32", tile_n=512)
    k2f32 = pick(k2_rows, shape=[32, 16, 257, 64], dtype="float32")
    k1i8 = pick(k1i8_rows, q=1)
    k2 = pick(k2_rows, shape=[1, 16, 257, 64], dtype="bfloat16")
    k2_md = pick(k2_rows, shape=[1, 16, 729, 72], dtype="bfloat16")
    k2_tp = pick(k2_rows, shape=list(K2_TP_CASES[0][0]), dtype="bfloat16")
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
            "K1 tile_max, fp32 Q>=2 (CUDA cores)",
            k1f32,
            "imatch_tpu_torch/csrc/tile_max.cu",
            "imatch_tpu/ops/pallas/topk.py:84",
            "K1_fp32",
            f"Q={N_BIG_BATCH} x {k1f32['n']}x{k1f32['d']} fp32, tile_n 512 (IMATCH_SCORE_DTYPE=fp32); "
            "launches: the fp32 tier's /api/search/batch of 256 texts and phase 8e's sharded "
            "engine in fp32 at Q=16",
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
            "K2 flash_attention, fp32 (CUDA cores)",
            k2f32,
            "imatch_tpu_torch/csrc/flash_attention.cu",
            "imatch_tpu/ops/pallas/flash_attention.py:26",
            "K2_fp32",
            "(32, 16, 257, 64) fp32, non-causal (ClipEmbedder(compute_dtype=torch.float32)); "
            "launches: the fp32 towers of phase 9 (vit-b32, 2 layers) and of the W8A8 "
            "fidelity check (LongCLIP-L/14-248's image tower, 8 frames twice)",
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
            "K2 flash_attention, tensor-parallel shard",
            k2_tp,
            "imatch_tpu_torch/csrc/flash_attention.cu",
            "imatch_tpu/ops/pallas/flash_attention.py:26",
            "K2_tp",
            f"{tuple(K2_TP_CASES[0][0])} bf16, non-causal: a model shard of the Moondream vision "
            "tower at mp = 2; launches: phase 8h's sharded encode (one a shard a layer)",
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
        if not launches.get(key):
            raise AssertionError(f"{name} was launched no time on its path")
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
        if key in ("K2", "K2_md", "K2_tp", "K2_fp32"):
            entry["library_device_ms"] = row["library_device_ms"]
        if key in ("K3", "K4", "K3_md", "K4_md"):
            entry["library_note"] = "no single PyTorch call computes a per-row int8 quantize"
        elif "library_note" in row:
            entry["library_note"] = row["library_note"]
        entries.append(entry)
    return {"kernels": entries}


# -- the run ----------------------------------------------------------------
#
# Each step below is one phase with its own setup, on a context that the
# steps before it filled: the kernel tables (``rows``), the launch counts
# of the main path (``launches``), slice 1's embedder and the experiment
# scripts' lines. ``main`` runs them all in order; ``--phase NAME`` runs
# identify, build and the one step on a fresh context, so it calls what
# the whole run calls, and a step that needs slice 1's embedder builds it
# as phase 6 does.


def _add_launches(ctx, **counts) -> None:
    for k, v in counts.items():
        ctx["launches"][k] = ctx["launches"].get(k, 0) + v


def _slice_embedder(ctx):
    """Slice 1's embedder: phase 6's, or (a phase run alone) the same
    config's seeded weights built here."""
    if "embedder" not in ctx:
        from imatch_tpu_torch.pipeline.embedder import ClipEmbedder

        ctx["embedder"] = ClipEmbedder(SLICE_CONFIG, device="cuda")
    return ctx["embedder"]


def step_table(key, phase):
    def step(ctx):
        ctx["rows"][key] = phase()

    return step


def step_slice(ctx) -> None:
    with environment(IMATCH_CAPTIONER="null"):  # the CLIP slices run without a captioner
        launches, ctx["embedder"], surface = phase_slice()
    # slice 8's requests (phase 6b) beside slice 1's
    _add_launches(
        ctx, K1=launches["K1"] + surface["K1"], K2=launches["K2"] + surface["K2"], K1_mma=surface["K1_mma"]
    )


def step_w8a8(ctx) -> None:
    with environment(IMATCH_CAPTIONER="null"):
        launches, w8a8 = phase_w8a8()
    _add_launches(ctx, K3=launches["K3"], K4=launches["K4"])
    _add_launches(ctx, K2_fp32=phase_w8a8_fidelity(w8a8))


def step_tiers(ctx) -> None:
    with environment(IMATCH_CAPTIONER="null"):
        tiers = phase_tiers(_slice_embedder(ctx))
    # the int8 tier's device-resident folder adds its K2; the fp32 tier's
    # single searches run K1 (fp32, Q = 1), its batch the fp32 multi-query K1
    _add_launches(
        ctx,
        K1_int8=sum(c["K1_int8"] for c in tiers.values()),
        K2=tiers["int8"]["K2_ingest"],
        K1=tiers["fp32"]["K1"],
        K1_fp32=tiers["fp32"]["K1_fp32"],
    )


def step_moondream(ctx) -> None:
    _add_launches(ctx, K2_md=phase_moondream(_slice_embedder(ctx))["launches"])


def step_clip_path(phase):
    """Slices 9-11 (the cutouts and their searches, the sharded engines'
    K1 and the towers' K2, the client's and the scripts' K1 and K2)."""

    def step(ctx):
        launches = phase(_slice_embedder(ctx))["launches"]
        _add_launches(ctx, **{k: launches.get(k, 0) for k in ("K1", "K1_mma", "K1_fp32", "K2")})

    return step


def step_md_int8(ctx) -> None:
    import torch

    ctx.pop("embedder", None)  # slice 1's embedder is done with
    gc.collect()
    torch.cuda.empty_cache()
    _add_launches(ctx, **phase_md_int8()["launches"])


def step_parallel(ctx) -> None:
    out = phase_parallel()
    # the split-head rows join phase 3's table: phase 11 traces them too
    ctx["rows"].setdefault("K2", []).extend(out["k2_rows"])
    _add_launches(ctx, **out["launches"])


def step_scale(ctx) -> None:
    _add_launches(ctx, **phase_scale(ctx))


def step_scale_train(ctx) -> None:
    """Phase 8i (d), launch B, read where it ran beside the later phases."""
    if "scale_train" not in ctx:
        raise RuntimeError("the step scale_train reads the launch the step scale started: run --phase scale")
    proc, ref, t0 = ctx.pop("scale_train")
    train, ok = scale_train_finish(proc, ref)
    train["seconds_since_phase_8i"] = time.perf_counter() - t0
    log("scale train over processes: " + json.dumps(train))
    if not ok:
        raise AssertionError("phase 8i (d) failed: launch B, DP + TP training over 4 processes")


def step_scripts(ctx) -> None:
    launches, ctx["script_lines"] = phase_scripts()
    _add_launches(ctx, **launches)


PHASES = {
    "identify": lambda ctx: phase_identify(),
    "build": lambda ctx: phase_build(),
    "k2": step_table("K2", phase_k2),
    "k1": step_table("K1", phase_k1),
    "k1_int8": step_table("K1_int8", phase_k1_int8),
    "k34": step_table("K34", phase_k34),
    "k5": step_table("K5", phase_k5),
    "k6": step_table("K6", phase_k6),
    "slice": step_slice,
    "w8a8": step_w8a8,
    "tiers": step_tiers,
    "moondream": step_moondream,
    "u2net": step_clip_path(phase_u2net),
    "ivf": step_clip_path(phase_ivf),
    "ops": step_clip_path(phase_ops),
    "md_int8": step_md_int8,
    "train": lambda ctx: phase_train(),
    "parallel": step_parallel,
    # phases 10 and 11 on a quiet card, before phase 8i starts its launches
    "scripts": step_scripts,
    "device": lambda ctx: phase_device(ctx["rows"]),
    "scale": step_scale,
    # beside phase 8i's launch B, which runs on: phase 12's own process and
    # phase 9 (neither reads a time)
    "profile_start": profile_start,
    "reference": lambda ctx: _add_launches(ctx, K2_fp32=phase_reference()),
    "scale_train": step_scale_train,
    "profile": phase_profile_apart,
}
# a step that reads what another started runs with it
FOLLOWS = {"scale": ("scale_train",), "profile_start": ("profile",)}


def main(only=None) -> int:
    """Every phase in order, then the contract's lines; with ``only``,
    identify, build and that phase, and no contract line."""
    import torch

    if only is not None and only not in PHASES:
        print(f"chip_smoke: unknown phase {only!r}; one of {', '.join(PHASES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    # phase 6b runs the app's warmup itself, timed: the apps' background
    # warmup would launch kernels inside the other phases' counted windows
    os.environ["IMATCH_WARMUP"] = "0"
    ctx = {"rows": {}, "launches": {}, "background": []}
    names = list(PHASES) if only is None else list(dict.fromkeys(("identify", "build", only, *FOLLOWS.get(only, ()))))
    try:
        for name in names:
            t_phase = time.perf_counter()
            PHASES[name](ctx)
            gc.collect()  # each phase's apps and stores
            torch.cuda.empty_cache()
            log(f"chip_smoke step {name}: {time.perf_counter() - t_phase:.1f} s")
    finally:
        for proc in ctx["background"]:  # a launch a failed phase left running
            _stop(proc)
    if only is not None:
        log(f"chip_smoke --phase {only}: passed in {time.perf_counter() - t0:.1f} s")
        return 0
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    rows = ctx["rows"]
    for line in ctx["script_lines"]:
        print(line)
    print(json.dumps(kernels_line(rows["K2"], rows["K1"], rows["K1_int8"], rows["K34"], rows["K5"], rows["K6"], ctx["launches"])))
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


def child(name: str, out_path=None) -> int:
    """``--child device|profile``: phase 11 or 12 proper, in the process
    of its own that phase_device or phase_profile_apart starts, on the
    kernels phase 2 built."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    os.environ["IMATCH_WARMUP"] = "0"
    if name == "device":
        phase_device_child(out_path)
    else:
        phase_profile()
    return 0


def _cli(argv) -> int:
    if not argv:
        return main()
    if len(argv) == 2 and argv[0] == "--phase":
        return main(argv[1])
    if argv == ["--child", "profile"]:
        return child("profile")
    if len(argv) == 4 and argv[:2] == ["--child", "device"] and argv[2] == "--out":
        return child("device", argv[3])
    print("usage: chip_smoke.py [--phase NAME]", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(_cli(sys.argv[1:]))
