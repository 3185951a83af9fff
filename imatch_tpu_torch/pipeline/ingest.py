"""Ingest: the reference app's ``process_image`` chain, one upload or a
batch.

Counterparts of ``process_image`` and ``process_batch`` in
``imatch_tpu/pipeline/ingest.py``:

- ``process_image``: pHash id -> duplicate check -> caption + vision
  encoding (cached to ``static/encoded/<id>.npz``) -> save the processed
  PNG -> description fallback -> caption into ``custom_metadata`` -> CLIP
  embedding -> the saved filters' answers -> ``store.add``, returning
  ``(metadata, is_new_upload)``; a duplicate returns the stored metadata.
- ``process_batch``: bulk ingest through the embedder's fused stream (one
  device upload per geometry chunk gives the pHash ids and the
  embeddings), a batched duplicate check per streamed chunk, saves on a
  host pool overlapping the device work, batched captions and filter
  answers (``encode_image_batch``, ``caption_batch``,
  ``query_yes_no_batch``), one ``store.add``, per-file results.

A caption or filter failure is logged and costs the image its caption or
answers, not its upload, as in the JAX package. With the
``NullCaptioner`` there is no caption and no filter pass; the port has no
segmenter, so no background removal.
"""

from __future__ import annotations

import datetime
import io
import json
import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from imatch_tpu_torch.ops.phash import image_id as phash_image_id
from imatch_tpu_torch.pipeline.captioner import save_encoded
from imatch_tpu_torch.pipeline.filters import format_filter_query
from imatch_tpu_torch.pipeline.state import AppState
from imatch_tpu_torch.utils.batching import to_rgb

logger = logging.getLogger("imatch.ingest")

# Host fan-out pools for bulk ingest (PIL, scipy and zlib release the GIL),
# shared by every request of the process as the host's cores are. Two on
# purpose, as in the JAX package: the fallback pHash is on the critical
# path, while the saves are deferrable and must not queue in front of it.
_HOST_POOL: Optional[ThreadPoolExecutor] = None
_SAVE_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def _host_pool() -> ThreadPoolExecutor:
    global _HOST_POOL
    with _POOL_LOCK:
        if _HOST_POOL is None:
            _HOST_POOL = ThreadPoolExecutor(
                max_workers=min(16, os.cpu_count() or 4), thread_name_prefix="imatch-ingest"
            )
        return _HOST_POOL


def _save_pool() -> ThreadPoolExecutor:
    global _SAVE_POOL
    with _POOL_LOCK:
        if _SAVE_POOL is None:
            _SAVE_POOL = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 4), thread_name_prefix="imatch-save"
            )
        return _SAVE_POOL


def _now_iso() -> str:
    return datetime.datetime.now().isoformat()


def _caption_and_encode(state: AppState, image_np: np.ndarray):
    """The reference app's generate_image_caption: (caption, encoding),
    or (None, None) without a captioner or on failure."""
    cap = state.captioner
    if not getattr(cap, "available", False):
        return None, None
    try:
        encoded = cap.encode_image(image_np)
        caption = cap.caption(encoded)["caption"]
        return caption, encoded
    except Exception as e:
        logger.exception("error generating caption: %s", e)
        return None, None


def _apply_existing_filters(state: AppState, encoded) -> Optional[Dict[str, str]]:
    """Every saved filter's answer for a new image; "error" where one
    failed."""
    if encoded is None or not getattr(state.captioner, "available", False):
        return None
    filters = state.load_filters()
    if not filters:
        return None
    results: Dict[str, str] = {}
    for fq in filters:
        try:
            ans = state.captioner.query(encoded, format_filter_query(fq))["answer"]
            results[fq] = ans.strip() if isinstance(ans, str) else ans
        except Exception as e:
            logger.exception("error applying filter %r: %s", fq, e)
            results[fq] = "error"
    return results


def process_image(
    state: AppState,
    image: Image.Image,
    filename: str,
    description: Optional[str] = None,
    custom_metadata: Optional[str] = None,
) -> Tuple[dict, bool]:
    """Single-image ingest with the reference app's semantics."""
    image = image.convert("RGB") if image.mode != "RGB" else image
    img_id = phash_image_id(image)

    existing = state.store.get(ids=[img_id], include=["metadatas"])
    if existing["ids"]:
        logger.info("image %s already exists, skipping", img_id)
        return existing["metadatas"][0], False

    image_np = np.asarray(image)
    caption, encoded = _caption_and_encode(state, image_np)
    if encoded is not None:
        save_encoded(state.encoded_dir, img_id, encoded)

    processed_path = os.path.join(state.processed_dir, f"{img_id}.png")
    Image.fromarray(image_np).save(processed_path)

    if not description:
        description = os.path.splitext(filename)[0]

    processed_custom = custom_metadata or ""
    if caption:
        if processed_custom:
            processed_custom += "\n\n"
        processed_custom += caption

    embedding = state.get_embedder().embed_image(image_np)

    url = f"/static/processed/{img_id}.png"
    metadata = {
        "id": img_id,
        "filename": filename,
        "description": description,
        "custom_metadata": processed_custom,
        "url": url,
        "thumbnail_url": url,
        "processed_url": processed_path,
        "created_at": _now_iso(),
    }
    filter_results = _apply_existing_filters(state, encoded)
    if filter_results:
        metadata["filter_results_json"] = json.dumps(filter_results)
    with state.lock:
        try:
            state.store.add(
                ids=[img_id],
                embeddings=[embedding],
                metadatas=[metadata],
                documents=[description],
            )
        except ValueError:
            # lost a duplicate race: another handler thread added this id
            # between the early check and here
            existing = state.store.get(ids=[img_id], include=["metadatas"])
            return existing["metadatas"][0], False
        state.image_metadata[img_id] = metadata
    return metadata, True


def _caption_and_filter_batch(state: AppState, fresh, arrays, ids):
    """Captions and saved-filter answers for a batch's fresh files, batched
    on the device where the captioner can (MoondreamTorch: chunked vision
    encodes, a shared decode loop a chunk, one yes/no prefill a filter),
    else image by image. Returns ({index: caption}, {index: {filter:
    answer}}); a failure is logged and leaves both empty."""
    captions: Dict[int, str] = {}
    filter_results: Dict[int, Dict[str, str]] = {}
    cap = state.captioner
    if not getattr(cap, "available", False):
        return captions, filter_results
    try:
        if hasattr(cap, "encode_image_batch"):
            encs = cap.encode_image_batch([arrays[i] for i in fresh])
            caps = (
                cap.caption_batch(encs)
                if hasattr(cap, "caption_batch")
                else [cap.caption(e)["caption"] for e in encs]
            )
            for i, enc, text in zip(fresh, encs, caps):
                save_encoded(state.encoded_dir, ids[i], enc)
                if text:
                    captions[i] = text
            saved_filters = state.load_filters()
            if saved_filters and hasattr(cap, "query_yes_no_batch"):
                for fq in saved_filters:
                    answers = cap.query_yes_no_batch(encs, format_filter_query(fq))
                    for i, yes in zip(fresh, answers):
                        filter_results.setdefault(i, {})[fq] = "Yes" if yes else "No"
        else:
            for i in fresh:
                caption, encoded = _caption_and_encode(state, arrays[i])
                if encoded is not None:
                    save_encoded(state.encoded_dir, ids[i], encoded)
                    fr = _apply_existing_filters(state, encoded)
                    if fr:
                        filter_results[i] = fr
                if caption:
                    captions[i] = caption
    except Exception as e:
        logger.exception("batched caption/filter error: %s", e)
    return captions, filter_results


# formats browsers render natively: safe to store the original bytes
# verbatim instead of re-encoding a PNG of the identical pixels
_RAW_EXTS = {".jpg", ".jpeg", ".png", ".webp", ".avif", ".gif"}


def _raw_bytes_render_identical(data: bytes) -> bool:
    """True when the encoded file renders the pixels that were hashed and
    embedded: no EXIF rotation (browsers rotate raw JPEGs, the decoded
    array is unrotated) and a single frame. A header parse only."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            if getattr(im, "n_frames", 1) > 1:
                return False
            exif = im.getexif()
            if exif and exif.get(0x0112, 1) not in (None, 1):
                return False
    except Exception:
        return False
    return True


def _reap_orphan_saves(state, results, ids, save_futs, save_ext):
    """Delete processed files written for items later demoted to error or
    skipped (embed failure, add-race collision, failed save), keeping any
    path a surviving record points at."""
    keep = set()
    for i in save_futs:
        r = results[i]
        if r is not None and r.get("status") == "success":
            keep.add(os.path.join(state.processed_dir, f"{ids[i]}{save_ext[i]}"))
    for i in list(save_futs):
        r = results[i]
        if r is None or r.get("status") == "success":
            continue
        try:
            save_futs[i].result()
        except Exception:
            pass  # a save that failed left nothing, or a partial file removed below
        path = os.path.join(state.processed_dir, f"{ids[i]}{save_ext[i]}")
        if path in keep:
            continue
        with state.lock:
            winner = state.image_metadata.get(ids[i])
        if winner and winner.get("processed_url") == path:
            continue  # a concurrent winner owns this exact file
        try:
            os.unlink(path)
        except OSError:
            pass


def process_batch(
    state: AppState,
    images: Sequence,
    filenames: Sequence[str],
    remove_bg: bool = False,
    raw_bytes: Optional[Sequence[Optional[bytes]]] = None,
) -> List[dict]:
    """Batched ingest: ids and embeddings from the fused device stream
    instead of the reference app's per-file serial loop.

    ``images`` are PIL Images or decoded uint8 arrays. ``raw_bytes``, when
    given, are the original files: without background removal the
    processed image is the upload, so (IMATCH_SAVE_ORIGINAL=1, the default)
    renderable originals are stored verbatim under their own extension and
    the rest as PNGs at zlib level IMATCH_PNG_COMPRESS (default 1). The port
    has no segmenter, so ``remove_bg`` only selects the PNG save, as it does
    in the JAX package without one.

    Returns per-file results ``{"filename", "status": success|skipped|error,
    "id"?, "metadata"?, "message"?, "error"?}``. A stream that fails is
    logged, counted in ``process_batch.stream_failures`` and demoted: the
    files it did not reach hash on the host and embed on the plain path, so
    one bad file costs only itself. As in the JAX package, when one batch
    holds pHash-identical files in different geometry buckets the kept copy
    follows stream order (device buckets first), not file order.
    """
    n = len(images)
    results: List[Optional[dict]] = [None] * n
    fresh: List[int] = []
    ids: List[Optional[str]] = [None] * n
    arrays: List[Optional[np.ndarray]] = [None] * n
    pool = _host_pool()

    for i, (im, name) in enumerate(zip(images, filenames)):
        try:
            if isinstance(im, np.ndarray):
                arrays[i] = to_rgb(im)
            else:
                arrays[i] = np.asarray(im.convert("RGB") if im.mode != "RGB" else im)
        except Exception as e:
            results[i] = {"filename": name, "status": "error", "error": str(e)}

    png_level = int(os.environ.get("IMATCH_PNG_COMPRESS", "1"))
    save_original = (
        os.environ.get("IMATCH_SAVE_ORIGINAL", "1") != "0"
        and not remove_bg
        and raw_bytes is not None
    )
    save_futs: Dict[int, object] = {}
    save_ext: Dict[int, str] = {}

    def _ext_for(i) -> str:
        if save_original and raw_bytes[i] is not None:
            ext = os.path.splitext(filenames[i])[1].lower()
            if ext in _RAW_EXTS and _raw_bytes_render_identical(raw_bytes[i]):
                return ext
        return ".png"

    def _save(i):
        path = os.path.join(state.processed_dir, f"{ids[i]}{save_ext[i]}")
        if save_ext[i] != ".png":
            with open(path, "wb") as f:
                f.write(raw_bytes[i])
        else:
            Image.fromarray(arrays[i]).save(path, compress_level=png_level)

    def _submit_save(i):
        save_ext[i] = _ext_for(i)
        save_futs[i] = _save_pool().submit(_save, i)

    seen_batch = set()
    checked = [False] * n

    def _dup_check(idx_list):
        """Classify hashed images as fresh or duplicate with ONE batched
        store lookup; fresh files' saves start at once (their frames are
        final), overlapping the device work of later chunks."""
        todo = []
        for i in idx_list:
            checked[i] = True
            if results[i] is None:
                todo.append(i)
        q_ids = [ids[i] for i in todo if ids[i] is not None]
        present = set(state.store.get(ids=q_ids, include=[])["ids"]) if q_ids else set()
        for i in todo:
            if ids[i] in seen_batch or ids[i] in present:
                results[i] = {
                    "filename": filenames[i],
                    "status": "skipped",
                    "id": ids[i],
                    "message": "Duplicate image detected",
                }
                arrays[i] = None
                continue
            seen_batch.add(ids[i])
            fresh.append(i)
            _submit_save(i)

    def _host_hash(idxs):
        def one(i):
            try:
                ids[i] = phash_image_id(Image.fromarray(arrays[i]))
            except Exception as e:
                results[i] = {"filename": filenames[i], "status": "error", "error": str(e)}

        list(pool.map(one, idxs))

    emb_by_idx: Dict[int, np.ndarray] = {}
    try:
        for idxs, ids_c, e in state.get_embedder().ids_and_embed_images_stream(arrays, pool=pool):
            for j, i in enumerate(idxs):
                ids[i] = ids_c[j]
                emb_by_idx[i] = e[j]
            _dup_check(idxs)
    except Exception as e:
        # Files already streamed keep their ids and embeddings; the rest
        # hash on the host and embed on the plain path below.
        process_batch.stream_failures += 1
        logger.exception("fused ingest stream failed, host fallback: %s", e)
        _host_hash(
            [
                i
                for i, a in enumerate(arrays)
                if a is not None and results[i] is None and ids[i] is None
            ]
        )
    # what the stream never reached: dup-check in file order now
    _dup_check([i for i in range(n) if not checked[i] and results[i] is None])
    if not fresh:
        return results
    captions, filter_results = _caption_and_filter_batch(state, fresh, arrays, ids)

    missing = [i for i in fresh if i not in emb_by_idx]
    if missing:
        try:
            more = state.get_embedder().embed_images([arrays[i] for i in missing])
            for j, i in enumerate(missing):
                emb_by_idx[i] = more[j]
        except Exception as e:
            logger.error("batch embed failed: %s", e)
            for i in missing:
                results[i] = {
                    "filename": filenames[i],
                    "status": "error",
                    "error": f"embedding failed: {e}",
                }
            dropped = set(missing)
            fresh = [i for i in fresh if i not in dropped]
            if not fresh:
                _reap_orphan_saves(state, results, ids, save_futs, save_ext)
                return results

    # saves land before results return (the metadata URLs point at them);
    # a failed save demotes that file to an error
    save_failed = set()
    for i in fresh:
        try:
            save_futs[i].result()
        except Exception as e:
            logger.error("processed save failed for %s: %s", ids[i], e)
            save_failed.add(i)
            results[i] = {"filename": filenames[i], "status": "error", "error": f"save failed: {e}"}

    add_ids, add_embs, add_mds, add_docs = [], [], [], []
    for i in fresh:
        if i in save_failed:
            continue
        img_id, name = ids[i], filenames[i]
        description = os.path.splitext(name)[0]
        url = f"/static/processed/{img_id}{save_ext[i]}"
        metadata = {
            "id": img_id,
            "filename": name,
            "description": description,
            "custom_metadata": captions.get(i, ""),
            "url": url,
            "thumbnail_url": url,
            "processed_url": os.path.join(state.processed_dir, f"{img_id}{save_ext[i]}"),
            "created_at": _now_iso(),
        }
        if i in filter_results:
            metadata["filter_results_json"] = json.dumps(filter_results[i])
        add_ids.append(img_id)
        add_embs.append(emb_by_idx[i])
        add_mds.append(metadata)
        add_docs.append(description)
        results[i] = {"filename": name, "status": "success", "id": img_id, "metadata": metadata}

    if not add_ids:
        _reap_orphan_saves(state, results, ids, save_futs, save_ext)
        return results

    with state.lock:
        inserted = set(add_ids)
        try:
            state.store.add(ids=add_ids, embeddings=add_embs, metadatas=add_mds, documents=add_docs)
        except ValueError:
            # a concurrent upload added one of these ids after the dup
            # check: add one by one, reclassifying the collisions
            inserted = set()
            for j, img_id in enumerate(add_ids):
                try:
                    state.store.add(
                        ids=[img_id],
                        embeddings=[add_embs[j]],
                        metadatas=[add_mds[j]],
                        documents=[add_docs[j]],
                    )
                    inserted.add(img_id)
                except ValueError:
                    for r in results:
                        if r and r.get("id") == img_id:
                            r["status"] = "skipped"
                            r["message"] = "Duplicate image detected"
        for md in add_mds:
            if md["id"] in inserted:
                state.image_metadata[md["id"]] = md
    _reap_orphan_saves(state, results, ids, save_futs, save_ext)
    return results


process_batch.stream_failures = 0
