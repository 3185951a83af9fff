"""Search: similarity, text, image, multimodal, batched, listing, and
the caption-enhanced query.

Counterpart of ``imatch_tpu/pipeline/search.py``. Similarity is the v2
mapping ``1 - distance/2``; ``limit <= 0`` caps at 1000. The query
embedding stays on the device from the tower into the store's engine, so
a search pays one device-to-host copy (the top-k result). The batched
forms run one tower call for all the queries (chunked as the embedder
chunks) and one store query of Q rows. Building the result dicts from
the store's rows is the ``search.rows`` timer.
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np
import torch
from PIL import Image

from imatch_tpu_torch.pipeline.state import AppState
from imatch_tpu_torch.utils.metrics import METRICS

logger = logging.getLogger("imatch.search")

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
    with METRICS.timer("search.rows"):
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


def search_by_text_batch(state: AppState, queries: List[str], limit: int = 10) -> List[List[dict]]:
    """Q text searches: one text-tower call at B = Q and one store query
    of Q rows (K1 on the tensor cores at Q >= 2). Each row is the result
    the same text gets from ``search_by_text``."""
    if not queries:
        return []
    embs = state.get_embedder().embed_texts_device(queries)
    return _query_rows(state, embs, len(queries), limit)


def _query_rows(state: AppState, embs, n: int, limit: int) -> List[List[dict]]:
    # store.query returns exactly n rows, empty ones for an empty store
    res = state.store.query(
        query_embeddings=embs,
        n_results=ALL_LIMIT if limit <= 0 else limit,
        include=["metadatas", "distances"],
    )
    with METRICS.timer("search.rows"):
        return [_result_row(res, qi) for qi in range(n)]


def search_by_image(state: AppState, image: Image.Image, limit: int = 10) -> List[dict]:
    image = image.convert("RGB") if image.mode != "RGB" else image
    emb = state.get_embedder().embed_image_device(np.asarray(image))
    return search_similar(state, emb, limit)


def search_by_image_batch(
    state: AppState, images: List[Image.Image], limit: int = 10
) -> List[List[dict]]:
    """N image searches: the frames through the image tower in chunks of
    IMATCH_QUERY_PIXEL_BUDGET source pixels, then one store query of N
    rows. Each row is the result of ``search_by_image`` on that image."""
    if not images:
        return []
    arrays = [np.asarray(im.convert("RGB") if im.mode != "RGB" else im) for im in images]
    embs = state.get_embedder().embed_images_device(arrays)
    return _query_rows(state, embs, len(images), limit)


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


def enhance_query_with_caption(
    state: AppState,
    image: Image.Image,
    query_text: str,
    max_tokens: int = 248,
    chars_per_token: int = 4,
) -> str:
    """Caption the query image and append as much of the caption as the
    text tower's token budget holds, cut at a word boundary. Without a
    captioner, or when it fails, the query is returned as it is."""
    cap = state.captioner
    if not getattr(cap, "available", False):
        return query_text
    try:
        encoded = cap.encode_image(np.asarray(image.convert("RGB")))
        caption = cap.caption(encoded)["caption"]
    except Exception as e:
        logger.error("caption enhancement failed: %s", e)
        return query_text
    budget_chars = max_tokens * chars_per_token - len(query_text) - 2
    if budget_chars <= 0 or not caption:
        return query_text
    if len(caption) > budget_chars:
        cut = caption[:budget_chars]
        if " " in cut:
            cut = cut.rsplit(" ", 1)[0]
        caption = cut
    return f"{query_text}. {caption}" if query_text else caption
