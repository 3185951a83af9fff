"""Ingest: the reference app's ``process_image`` chain for one upload.

Counterpart of ``process_image`` in ``imatch_tpu/pipeline/ingest.py``:
pHash id -> duplicate check -> save the processed PNG -> description
fallback -> CLIP embedding -> ``store.add``, returning ``(metadata,
is_new_upload)``; a duplicate returns the stored metadata. With the
``NullCaptioner`` and no segmenter of this slice there is no caption,
no background removal and no filter pass. The batched ``process_batch``
(bulk ingest with the device pHash) is the next slice (ROADMAP.md).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Tuple

import numpy as np
from PIL import Image

from imatch_tpu_torch.ops.phash import image_id as phash_image_id
from imatch_tpu_torch.pipeline.state import AppState

logger = logging.getLogger("imatch.ingest")


def _now_iso() -> str:
    return datetime.datetime.now().isoformat()


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
    processed_path = os.path.join(state.processed_dir, f"{img_id}.png")
    Image.fromarray(image_np).save(processed_path)

    if not description:
        description = os.path.splitext(filename)[0]

    embedding = state.get_embedder().embed_image(image_np)

    url = f"/static/processed/{img_id}.png"
    metadata = {
        "id": img_id,
        "filename": filename,
        "description": description,
        "custom_metadata": custom_metadata or "",
        "url": url,
        "thumbnail_url": url,
        "processed_url": processed_path,
        "created_at": _now_iso(),
    }
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
