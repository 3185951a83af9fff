"""Search: similarity, text, image, multimodal, listing.

Counterpart of ``imatch_tpu/pipeline/search.py``. Similarity is the v2
mapping ``1 - distance/2``; ``limit <= 0`` caps at 1000. The query
embedding stays on the device from the tower into the store's engine, so
a search pays one device-to-host copy (the top-k result).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from PIL import Image

from imatch_tpu_torch.pipeline.state import AppState

ALL_LIMIT = 1000


def search_similar(state: AppState, embedding, limit: int = 10) -> List[dict]:
    """Vector search returning metadata dicts with ``similarity_score``;
    ``embedding`` is a (D,) tensor on the device or a numpy vector."""
    actual_limit = ALL_LIMIT if limit <= 0 else limit
    if isinstance(embedding, torch.Tensor):
        qe = embedding[None] if embedding.ndim == 1 else embedding
    else:
        qe = [np.asarray(embedding, dtype=np.float32)]
    res = state.store.query(
        query_embeddings=qe,
        n_results=actual_limit,
        include=["metadatas", "distances"],
    )
    if not res["ids"] or not res["ids"][0]:
        return []
    return _result_row(res, 0)


def _result_row(res: dict, qi: int) -> List[dict]:
    """Row ``qi`` of a chroma-shaped query result -> metadata dicts with
    ``similarity_score`` (``1 - distance/2``)."""
    out = []
    for img_id, md, dist in zip(
        res["ids"][qi], res["metadatas"][qi], res["distances"][qi]
    ):
        md = dict(md or {})
        md["similarity_score"] = 1 - (dist / 2)
        md.setdefault("url", f"/static/processed/{img_id}.png")
        md.setdefault("thumbnail_url", f"/static/processed/{img_id}.png")
        out.append(md)
    return out


def search_by_text(state: AppState, query_text: str, limit: int = 10) -> List[dict]:
    emb = state.get_embedder().embed_text_device(query_text)
    return search_similar(state, emb, limit)


def search_by_image(state: AppState, image: Image.Image, limit: int = 10) -> List[dict]:
    image = image.convert("RGB") if image.mode != "RGB" else image
    emb = state.get_embedder().embed_image_device(np.asarray(image))
    return search_similar(state, emb, limit)


def combine_embeddings(image_emb, text_emb, weight_image: float):
    """Normalized weighted blend of the two unit embeddings."""
    i = image_emb / torch.linalg.vector_norm(image_emb)
    t = text_emb / torch.linalg.vector_norm(text_emb)
    c = weight_image * i + (1.0 - weight_image) * t
    return c / torch.linalg.vector_norm(c)


def search_multimodal(
    state: AppState,
    image: Image.Image,
    query_text: str,
    weight_image: float = 0.5,
    limit: int = 10,
) -> List[dict]:
    image = image.convert("RGB") if image.mode != "RGB" else image
    embedder = state.get_embedder()
    img_emb = embedder.embed_image_device(np.asarray(image))
    txt_emb = embedder.embed_text_device(query_text)
    combined = combine_embeddings(img_emb, txt_emb, weight_image)
    return search_similar(state, combined, limit)


def get_all_images_with_limit(state: AppState, limit: int = 10) -> List[dict]:
    """Newest-first listing (the empty query + filters search)."""
    with state.lock:  # ingest inserts concurrently
        values = list(state.image_metadata.values())
    items = sorted(values, key=lambda m: m.get("created_at", ""), reverse=True)
    if limit > 0:
        items = items[:limit]
    return [dict(md) for md in items]
