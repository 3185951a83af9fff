"""Launcher: ``python -m imatch_tpu_torch``, the PyTorch port's run.py.

Env config (the same names as run.py):
  PORT                    server port (default 8000)
  IMATCH_ROOT             app data root (static/, index_data/) (default .)
  IMATCH_DATA_DIR         the store's snapshot and journal, under the root
                          unless absolute (default index_data)
  IMATCH_CLIP_CONFIG      vit-b32 | vit-l14 | longclip-l14-248 (default vit-b32)
  IMATCH_CLIP_CHECKPOINT  local HF checkpoint dir for real weights
  IMATCH_PROFILE          latency | throughput | capacity: fills in a group
                          of the variables below (utils/profiles.py)
  IMATCH_INDEX_ENGINE     auto (default, as run.py: sharded over every
                          visible card, else tilemax) | tilemax | pallas |
                          tilemax-host | sharded | ivf | ivf-sharded
  IMATCH_IVF_NPROBE       clusters an ivf / ivf-sharded query probes
                          (default 8)
  IMATCH_IVF_REBUILD_FRAC live-set growth past which an IVF build retrains
                          instead of repairing (default 0.3)
  IMATCH_SCORE_DTYPE      bf16 (default) | fp32 | int8
  IMATCH_STORE_CAPACITY   store slots to reserve up front (default 0: grow
                          by doubling from 1024)
  IMATCH_INCREMENTAL      0 drops the device index on every mutation
                          instead of patching it (default 1)
  IMATCH_JOURNAL_FSYNC    0 skips the fsync after each journaled batch
                          (default 1)
  IMATCH_EMBED_QUANT      int8 for the W8A8 image tower (default unset)
  IMATCH_WARMUP           0 skips the background warmup at start (default 1)
  IMATCH_COALESCE         1 lets concurrent single searches share one engine
                          call, on the card (default off)
  IMATCH_DEVICE_INGEST    1 keeps a folder's embeddings on the card into the
                          index (default off; IMATCH_DEVICE_INGEST_FLUSH=0
                          defers the mirror and journal to the next drain)
  IMATCH_SAMPLES_DIR      the directory /upload-samples ingests (default
                          images/ under the root)
  IMATCH_CAPTIONER        auto (default) | moondream | cloud | null
  IMATCH_MD_CONFIG        tiny-md (default) | moondream2 (the captioner)
  IMATCH_MD_CHECKPOINT    a moondream2 checkpoint for real weights
  IMATCH_MD_QUANT         int8: int8 decoder and LM-head weights (default unset)
  IMATCH_MD_CACHE         int8: an int8 KV cache with per-slot scales
  IMATCH_MD_ACT           int8: the W8A8 prefill through K3/K4 (needs
                          IMATCH_MD_QUANT=int8)
  IMATCH_SEGMENTER        auto (default: U²-Net only with a checkpoint) |
                          u2net | null (background removal for remove_bg)
  IMATCH_U2_CONFIG        u2net (default with a checkpoint) | u2netp | tiny-u2
  IMATCH_U2_CHECKPOINT    a released u2net.pth state dict
  IMATCH_U2_CHUNK         frames a segmenter forward in bulk ingest (default 8)
  IMATCH_DEVICE           cuda (default) | cpu

On ``cuda`` the CUDA kernels are built (nvcc, ops/kernels/_build.py) and
the CLIP, captioner and segmenter weights loaded before the server starts listening,
so the first request pays neither. The store loads from IMATCH_DATA_DIR at start; a
restart with the same directory serves the same images. SIGTERM and
SIGINT compact the journal into a snapshot before exit (status 0, or 1 if
the snapshot failed).
"""

from __future__ import annotations

import logging
import os
import signal
import sys


def main() -> None:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    # the profile first: the serving stack reads the profiled environment
    from imatch_tpu_torch.utils.profiles import apply_profile

    apply_profile()
    # every card for the index (the row-sharded exact engine), one card
    # tilemax; an explicit IMATCH_INDEX_ENGINE wins
    os.environ.setdefault("IMATCH_INDEX_ENGINE", "auto")
    from imatch_tpu_torch.device import resolve_device
    from imatch_tpu_torch.serving.app import create_app
    from imatch_tpu_torch.serving.server import serve

    device = resolve_device(os.environ.get("IMATCH_DEVICE") or None)
    if device.type == "cuda":
        from imatch_tpu_torch.ops.kernels import _build

        _build.build()
    app = create_app(root=os.environ.get("IMATCH_ROOT", "."), device=device)
    app.state.get_embedder()

    def _graceful(signum, frame):
        # Every completed op is already in the journal, so no data is at
        # risk; the snapshot makes the next start one npy read instead of
        # a replay. It waits on the store lock, draining an in-flight
        # bulk mutation first.
        log = logging.getLogger("imatch.run")
        log.info("signal %d: snapshotting before exit", signum)
        ok = True
        try:
            app.state.snapshot(force=True)
        except Exception as e:
            ok = False
            log.error("shutdown snapshot failed: %s", e)
        # a supervisor watching exit codes sees a failed compaction
        sys.exit(0 if ok else 1)

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    serve(app, port=int(os.environ.get("PORT", "8000")))


if __name__ == "__main__":
    main()
