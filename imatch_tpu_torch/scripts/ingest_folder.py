"""Bulk-ingest a directory of images from the command line.

Port of ``scripts/ingest_folder.py``. The reference app's /upload-samples
ingests its bundled corpus; this CLI takes any directory and runs the
batched pipeline without a server: the native decode pool
(runtime/loader.py), pHash dedup, captions and filters, optional
background removal, the CLIP image tower (K2) in device batches, the
index add, then the snapshot.

Usage:
  python -m imatch_tpu_torch.scripts.ingest_folder /path/to/images \\
      --root approot [--batch 64] [--remove-bg] [--captioner null] \\
      [--device cpu]

It logs a progress line a batch (``done/total (rate img/s) ok= skip=
err=``) and a last line ``done: N indexed, N duplicates, N errors in
Ts``; the exit status is 1 if any file failed to decode, 2 if the
directory holds no image. The state runs on ``cuda`` unless ``--device``
or IMATCH_DEVICE asks for the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

logger = logging.getLogger("imatch.ingest_folder")

EXTS = {".jpg", ".jpeg", ".png", ".webp", ".avif", ".bmp", ".gif"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("directory")
    ap.add_argument("--root", default=".", help="app state root")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--remove-bg", action="store_true")
    ap.add_argument("--captioner", default=None, help="override IMATCH_CAPTIONER")
    ap.add_argument(
        "--device",
        default=os.environ.get("IMATCH_DEVICE") or None,
        help="cuda (default) or cpu; IMATCH_DEVICE sets the default",
    )
    args = ap.parse_args(argv)

    if args.captioner:
        os.environ["IMATCH_CAPTIONER"] = args.captioner

    from imatch_tpu_torch.pipeline.ingest import process_batch
    from imatch_tpu_torch.pipeline.state import AppState
    from imatch_tpu_torch.runtime.loader import default_loader

    paths = sorted(
        os.path.join(args.directory, f)
        for f in os.listdir(args.directory)
        if os.path.splitext(f)[1].lower() in EXTS
    )
    if not paths:
        logger.error("no images found in %s", args.directory)
        return 2

    state = AppState(root=args.root, device=args.device)
    loader = default_loader()
    if not loader.native:
        logger.warning("native decode pool unavailable: decoding with PIL")
    totals = {"success": 0, "skipped": 0, "error": 0}
    t0 = time.time()
    for lo in range(0, len(paths), args.batch):
        chunk = paths[lo : lo + args.batch]
        arrays = loader.decode_batch(chunk)  # None entries: failed decodes
        images, names = [], []
        for p_, a in zip(chunk, arrays):
            if a is None:
                totals["error"] += 1
                logger.error("decode failed: %s", p_)
            else:
                images.append(a)
                names.append(os.path.basename(p_))
        for r in process_batch(state, images, names, remove_bg=args.remove_bg):
            totals[r["status"]] = totals.get(r["status"], 0) + 1
        done = lo + len(chunk)
        rate = done / max(time.time() - t0, 1e-9)
        logger.info(
            "%d/%d (%.1f img/s) ok=%d skip=%d err=%d",
            done,
            len(paths),
            rate,
            totals["success"],
            totals["skipped"],
            totals["error"],
        )
    state.snapshot()
    logger.info(
        "done: %d indexed, %d duplicates, %d errors in %.1fs",
        totals["success"],
        totals["skipped"],
        totals["error"],
        time.time() - t0,
    )
    return 0 if totals["error"] == 0 else 1


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    raise SystemExit(main())
