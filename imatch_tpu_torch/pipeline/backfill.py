"""Background filter back-fill job.

Counterpart of ``imatch_tpu/pipeline/backfill.py``
``process_filter_on_all_images``: applies a new filter to every indexed
image through the VLM, updating per-image metadata and a progress dict
polled over /api/filter-progress, with the same keys and final record.

When the captioner exposes the batched yes/no fast path
(``MoondreamTorch.query_yes_no_batch``: one prefill a batch, a logit
comparison instead of a decode loop), the cached encodings go through in
batches of IMATCH_BACKFILL_BATCH (64); the reference app decodes one
answer per image per filter. An image without a cached encoding is
skipped, as in the JAX package. Per-image error isolation is kept: a
failed batch retries image by image, so one bad encoding costs one image,
and the final progress record carries an ``errors`` count.
"""

from __future__ import annotations

import logging
import os

from imatch_tpu_torch.pipeline.captioner import load_encoded
from imatch_tpu_torch.pipeline.filters import format_filter_query, merge_filter_result
from imatch_tpu_torch.pipeline.state import AppState

logger = logging.getLogger("imatch.backfill")


def _batch_size() -> int:
    return int(os.environ.get("IMATCH_BACKFILL_BATCH", "64"))


def _query_batched(state: AppState, encs, formatted):
    """Answers for a batch of encodings; fast path when available."""
    fast = getattr(state.captioner, "query_yes_no_batch", None)
    if fast is not None:
        return [
            "Yes" if y else "No" for y in fast(encs, formatted)
        ]
    return [
        state.captioner.query(e, formatted)["answer"] for e in encs
    ]


def _answers_isolated(state: AppState, ids, encs, formatted):
    """Batch query with per-image fallback: the batched call is the fast
    path, but ONE bad encoding (torn cache file, backend-mismatched
    payload) must cost one image, not the whole batch. Returns
    (kept_ids, answers, n_failed)."""
    try:
        return ids, _query_batched(state, encs, formatted), 0
    except Exception as e:  # noqa: BLE001
        logger.warning(
            "batched filter query failed (%s); retrying per image", e
        )
    kept, answers, failed = [], [], 0
    for image_id, enc in zip(ids, encs):
        try:
            answers.extend(_query_batched(state, [enc], formatted))
            kept.append(image_id)
        except Exception as ee:  # noqa: BLE001
            failed += 1
            logger.warning("filter query failed for %s: %s", image_id, ee)
    return kept, answers, failed


def process_filter_on_all_images(state: AppState, filter_query: str) -> None:
    try:
        if not getattr(state.captioner, "available", False):
            state.filter_progress[filter_query] = {
                "status": "error",
                "message": "Model not available",
                "progress": 0,
            }
            return

        formatted = format_filter_query(filter_query)
        with state.lock:
            # snapshot under the lock: a concurrent ingest inserting
            # into the dict mid-list() is a RuntimeError that would
            # abort the whole backfill
            all_ids = list(state.image_metadata.keys())
        total = len(all_ids)
        state.filter_progress[filter_query] = {
            "status": "processing",
            "progress": 0,
            "current_image": "",
            "processed": 0,
            "total": total,
        }

        done = 0
        failed = 0
        skipped = 0  # no cached encoding, or deleted mid-backfill
        batch = _batch_size()
        for lo in range(0, total, batch):
            batch_ids = all_ids[lo : lo + batch]
            try:
                state.filter_progress[filter_query] = {
                    "status": "processing",
                    "progress": int(done / total * 100) if total else 0,
                    "current_image": batch_ids[0],
                    "processed": done,
                    "total": total,
                }
                ids, encs = [], []
                for image_id in batch_ids:
                    encoded = load_encoded(state.encoded_dir, image_id)
                    if encoded is None:
                        # reference skips images without a cached encoding
                        logger.warning(
                            "no encoded image for %s, skipping", image_id
                        )
                        skipped += 1
                        continue
                    ids.append(image_id)
                    encs.append(encoded)
                if not ids:
                    done += len(batch_ids)
                    continue
                ids, answers, n_fail = _answers_isolated(
                    state, ids, encs, formatted
                )
                failed += n_fail
                with state.lock:
                    updates = []
                    for image_id, raw in zip(ids, answers):
                        answer = (
                            raw.strip() if isinstance(raw, str) else raw
                        )
                        if image_id not in state.image_metadata:
                            skipped += 1
                            logger.warning(
                                "image %s vanished during backfill", image_id
                            )
                            continue
                        md = dict(state.image_metadata[image_id])
                        updates.append(
                            (image_id, merge_filter_result(md, filter_query, answer))
                        )
                    # ONE batched store.update per chunk: one journal
                    # write + fsync instead of one per image (a 100k
                    # backfill paid 100k fsyncs while holding
                    # state.lock). store FIRST, mirror after: writing
                    # the mirror first resurrected deleted images as
                    # ghost records.
                    try:
                        if updates:
                            state.store.update(
                                ids=[u[0] for u in updates],
                                metadatas=[u[1] for u in updates],
                            )
                            for image_id, md in updates:
                                state.image_metadata[image_id] = md
                    except KeyError:
                        # some id deleted between the mirror check and
                        # the store write: fall back to per-image so one
                        # vanished row doesn't discard the whole chunk
                        for image_id, md in updates:
                            try:
                                state.store.update(
                                    ids=[image_id], metadatas=[md]
                                )
                                state.image_metadata[image_id] = md
                            except KeyError:
                                skipped += 1
                                logger.warning(
                                    "image %s vanished during backfill",
                                    image_id,
                                )
            except Exception as e:
                logger.error("filter error for batch at %d: %s", lo, e)
                failed += len(batch_ids)
            done += len(batch_ids)

        # Persist the per-image results: the snapshot makes them survive a
        # restart.
        state.snapshot()
        final = {
            "status": "completed",
            "progress": 100,
            "processed": total - failed - skipped,
            "total": total,
        }
        if failed:
            # honest completion: the poller sees how many images the
            # filter could not be applied to instead of a clean 100%
            final["errors"] = failed
            if failed >= total and total:
                final["status"] = "error"
                final["message"] = "every image failed"
        if skipped:
            # also honest: images with no cached encoding (or deleted
            # mid-run) did NOT get the filter applied — counting them as
            # processed hid that they silently drop out of every
            # filtered search
            final["skipped"] = skipped
        state.filter_progress[filter_query] = final
    except Exception as e:
        logger.exception("error processing filter: %s", e)
        state.filter_progress[filter_query] = {
            "status": "error",
            "message": str(e),
            "progress": 0,
        }
