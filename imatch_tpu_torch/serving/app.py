"""REST API application — the reference app's v2 contract.

Counterpart of ``imatch_tpu/serving/app.py`` ``create_app``, every route
of it: ``/api/upload``, ``/api/upload-folder``, ``/api/search/text`` (POST
and GET), ``/api/search/image``, ``/api/search/multimodal``, the batched
``/api/search/batch`` (JSON, at most 256 queries) and
``/api/search/image-batch``, ``/api/images``, ``/api/image/{id}``, ``PUT
/api/metadata/{id}``, the filter routes (``GET``/``POST /api/filters``,
``POST /api/filters/batch``, ``DELETE /api/filters/{filter_query}``,
``GET /api/filter-progress``; a new filter is back-filled over every
stored image in a background task), ``/api/reset``, ``/api/health``, the
legacy ``/search`` (text, image or multimodal by its inputs, with
``enhance_with_caption``) and ``/upload-samples``, ``/api/metrics``,
``/api/profile/start`` and ``/stop`` (409 on misuse), and the web UI at
``/`` and ``/manage`` (serving/ui.py). The responses are the JAX app's
(ids, 409 on a duplicate, 422 for string fields sent as file parts and for
malformed batches, ``limit=0`` -> up to 1000, per-file statuses and counts,
progress records). ``remove_bg`` cuts the background out with the state's
segmenter (U²-Net, models/u2net/runtime.py) where one is configured: of
the stored image on ``/api/upload`` and ``/api/upload-folder``, of the
query image on ``/api/search/image``, ``/api/search/multimodal`` and each
frame of ``/api/search/image-batch``; a query whose cutout fails is logged
and searched as sent.

At start a background thread warms the serving path (IMATCH_WARMUP,
default on, as in JAX): the towers at B = 1 and a store query at each k
and Q bucket, so the kernels are built and loaded and the first request
pays neither.

Uploads decode where the JAX app decodes them, through the port's copy of
its native pool (runtime/loader.py, libjpeg-turbo/libpng/libwebp on C++
worker threads): a single upload and each query image through
``decode_image_bytes``, a batch's files through ``decode_each`` (all
submitted, then each waited in order), the samples directory by path.
Both apps give the same pixels (a 16-bit PNG is reduced to its high
byte, not clipped as PIL's ``convert`` does) and so the same ids. The
loader falls back to PIL for AVIF and where g++ or the codec headers are
missing, as JAX's does (a batch's fallbacks on a thread pool), and logs
it. A new upload, a folder with at least one success and a metadata edit
end at ``state.snapshot()``, as in the JAX app: the journal already holds
each op, and the snapshot compacts it once it has grown.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional

import numpy as np
from PIL import Image

from imatch_tpu_torch.device import DeviceLike
from imatch_tpu_torch.pipeline import search as search_mod
from imatch_tpu_torch.pipeline.backfill import process_filter_on_all_images
from imatch_tpu_torch.pipeline.filters import passes_filters
from imatch_tpu_torch.pipeline.ingest import process_batch, process_image
from imatch_tpu_torch.pipeline.state import AppState
from imatch_tpu_torch.runtime.loader import decode_image_bytes, default_loader
from imatch_tpu_torch.serving.asgi import App, JSONResponse, UploadFile
from imatch_tpu_torch.serving.ui import register_ui
from imatch_tpu_torch.utils import profiler
from imatch_tpu_torch.utils.metrics import METRICS

logger = logging.getLogger("imatch.api")

CORS_ORIGINS = [
    "http://localhost:3000",
    "http://127.0.0.1:3000",
    "http://localhost:8000",
    "*",
]

class _FieldTypeError(ValueError):
    def __init__(self, field: str):
        super().__init__(f"field {field!r} must be a string")
        self.field = field


def _form_str(form, key: str, default=None):
    """A string form field: absent -> default; sent as a file part ->
    _FieldTypeError (a 422), never an opaque 500."""
    v = form.get(key)
    if v is None:
        return default
    if isinstance(v, str):
        return v
    raise _FieldTypeError(key)


def _parse_int(v, default: int) -> int:
    try:
        return int(v)
    except (TypeError, ValueError):
        return default


def _parse_float(v, default: float) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def _open_upload(file: UploadFile) -> Image.Image:
    """One upload or query image, decoded by the native pool (JAX
    app.py:82-87); ``Image.fromarray`` copies the RGB pixels out of the
    pool's buffer."""
    return Image.fromarray(decode_image_bytes(file.content))


def _maybe_remove_query_bg(state: AppState, image: Image.Image) -> Image.Image:
    """The query image's cutout, RGB, where the state has a segmenter (the
    legacy ``remove_bg`` form flag); the image itself without one or when
    the cutout fails."""
    if state.segmenter is None:
        return image
    try:
        arr = state.segmenter.remove_background(np.asarray(image))
        return Image.fromarray(arr[..., :3])
    except Exception as e:
        logger.exception("query background removal failed: %s", e)
        return image


def _parse_bool(v, default=False) -> bool:
    if v is None:
        return default
    return str(v).strip().lower() in ("true", "1", "yes", "on")


def apply_search_filters(results: List[dict], filters: List[str]) -> List[dict]:
    """Route-level AND post-pass over search results
    (pipeline/filters.py ``passes_filters``)."""
    if not filters:
        return results
    return [r for r in results if passes_filters(r, filters)]


def _warmup(state: AppState):
    """Run the hot request shapes once on a background thread: one text
    and one 64x64 image through the towers, and, over a non-empty store,
    every k bucket of the limit select, one search, one Q = 16 text batch
    and the coalescer's Q buckets. The kernels are built and loaded there
    (nvcc, once per source) and the allocator holds the buffers, so the
    first user request pays neither."""
    t0 = time.time()
    try:
        emb = state.get_embedder()
        emb.embed_texts(["warmup"])
        emb.embed_images([np.zeros((64, 64, 3), np.uint8)])
        if state.store.count():
            state.store.warm()
            state.store.query([emb.embed_text("warmup")], n_results=1)
            state.store.query(emb.embed_texts_device(["warmup"] * 16), n_results=10)
            coal = state.store._coalescer  # one read
            if coal is not None:
                qc = [b for b in (2, 4, 8, 16, 32, 64) if b <= coal.max_batch]
                state.store.warm(n_results_list=(10,), q_counts=qc)
        logger.info("warmup done in %.1fs", time.time() - t0)
    except Exception as e:
        logger.warning("warmup failed: %s", e)


def create_app(
    state: Optional[AppState] = None, root: str = ".", device: DeviceLike = None
) -> App:
    if state is None:
        state = AppState(root=root, device=device)
    app = App(cors_origins=CORS_ORIGINS)
    app.state = state
    app.mount_static("/static", state.static_dir)

    if _parse_bool(os.environ.get("IMATCH_WARMUP"), default=True):
        app.add_background_task(_warmup, state)

    @app.post("/api/upload")
    def upload(req):
        form = req.form()
        file = form.get("file")
        if not isinstance(file, UploadFile):
            return JSONResponse({"success": False, "error": "file field required"}, 422)
        try:
            description = _form_str(form, "description")
            custom_metadata = _form_str(form, "custom_metadata")
        except _FieldTypeError as e:
            return JSONResponse({"success": False, "error": str(e)}, 422)
        try:
            metadata, is_new = process_image(
                state,
                image=_open_upload(file),
                filename=file.filename,
                description=description,
                custom_metadata=custom_metadata,
                remove_bg=_parse_bool(form.get("remove_bg")),
            )
        except Exception as e:
            logger.error("upload error: %s", e)
            return JSONResponse({"success": False, "error": str(e)}, 500)
        if is_new:
            state.snapshot()
            return {"success": True, "metadata": metadata}
        return JSONResponse(
            {
                "success": False,
                "error": "Duplicate image",
                "message": "This image already exists in the database",
                "metadata": metadata,
            },
            409,
        )

    @app.post("/api/upload-folder")
    def upload_folder(req):
        form = req.form()
        files = [f for f in form.getlist("files") if isinstance(f, UploadFile)]
        results = []
        todo = []
        for f in files:
            if not f.content:
                results.append({"filename": f.filename, "status": "skipped", "reason": "Empty file"})
            else:
                todo.append(f)
        images, names, raws = [], [], []
        for f, img in zip(todo, default_loader().decode_each([f.content for f in todo])):
            if isinstance(img, Exception):
                results.append(
                    {"filename": f.filename, "status": "error", "reason": f"Cannot open image: {img}"}
                )
            else:
                images.append(img)
                names.append(f.filename)
                raws.append(f.content)
        batch = process_batch(
            state, images, names, remove_bg=_parse_bool(form.get("remove_bg")), raw_bytes=raws
        )
        for r in batch:
            entry = {"filename": r["filename"], "status": r["status"]}
            if r["status"] == "success":
                entry["id"] = r["id"]
            elif r["status"] == "skipped":
                entry["reason"] = r.get("message", "Duplicate image")
                entry["id"] = r.get("id")
            else:
                entry["reason"] = r.get("error", "error")
            results.append(entry)
        successful = sum(r["status"] == "success" for r in results)
        if successful:
            state.snapshot()
        return {
            "success": True,
            "total": len(files),
            "successful": successful,
            "skipped": sum(r["status"] == "skipped" for r in results),
            "failed": sum(r["status"] == "error" for r in results),
            "results": results,
        }

    @app.post("/api/search/image")
    def search_image(req):
        form = req.form()
        file = form.get("file")
        if not isinstance(file, UploadFile):
            return JSONResponse({"success": False, "error": "file field required"}, 422)
        filters = form.getlist("filters")
        limit = _parse_int(form.get("limit"), 10)
        image = _open_upload(file)
        if _parse_bool(form.get("remove_bg")):
            image = _maybe_remove_query_bg(state, image)
        results = search_mod.search_by_image(state, image, limit=limit)
        return {"results": apply_search_filters(results, filters)}

    def _text_results(query: str, filters: List[str], limit: int) -> dict:
        if not query.strip() and filters:
            # empty query + filters -> every image, newest first
            results = search_mod.get_all_images_with_limit(state, limit=limit)
        else:
            results = search_mod.search_by_text(state, query, limit=limit)
        return {"results": apply_search_filters(results, filters)}

    @app.post("/api/search/text")
    def search_text(req):
        form = req.form()
        try:
            query = _form_str(form, "query", "")
        except _FieldTypeError as e:
            return JSONResponse({"success": False, "error": str(e)}, 422)
        return _text_results(
            query, form.getlist("filters"), _parse_int(form.get("limit"), 10)
        )

    @app.get("/api/search/text")
    def search_text_get(req):
        return _text_results(
            req.query_param("query", ""),
            req.query.get("filters", []),
            _parse_int(req.query_param("limit"), 10),
        )

    @app.post("/api/search/multimodal")
    def search_multimodal(req):
        form = req.form()
        file = form.get("file")
        if not isinstance(file, UploadFile):
            return JSONResponse({"success": False, "error": "file field required"}, 422)
        try:
            query = _form_str(form, "query", "")
        except _FieldTypeError as e:
            return JSONResponse({"success": False, "error": str(e)}, 422)
        weight_image = _parse_float(form.get("weight_image"), 0.5)
        filters = form.getlist("filters")
        limit = _parse_int(form.get("limit"), 10)
        image = _open_upload(file)
        if _parse_bool(form.get("remove_bg")):
            image = _maybe_remove_query_bg(state, image)
        results = search_mod.search_multimodal(
            state, image, query, weight_image=weight_image, limit=limit
        )
        return {"results": apply_search_filters(results, filters)}

    @app.post("/api/search/batch")
    def search_batch(req):
        """Batched text search: JSON ``{"queries": [...], "limit": 10,
        "filters": [...]}`` -> ``{"results": [[...], ...]}``, one row per
        query shaped like /api/search/text's results, from one tower call
        and one store query."""
        try:
            body = req.json()
        except Exception:
            return JSONResponse({"success": False, "error": "JSON body required"}, 422)
        queries = body.get("queries") if isinstance(body, dict) else None
        if not isinstance(queries, list) or not all(isinstance(q, str) for q in queries):
            return JSONResponse(
                {"success": False, "error": "queries must be a list of strings"}, 422
            )
        if len(queries) > 256:
            return JSONResponse({"success": False, "error": "at most 256 queries per batch"}, 422)
        filters = body.get("filters") or []
        if not isinstance(filters, list) or not all(isinstance(f, str) for f in filters):
            return JSONResponse(
                {"success": False, "error": "filters must be a list of strings"}, 422
            )
        limit = _parse_int(body.get("limit"), 10)
        # per query as /api/search/text: an empty query WITH filters lists
        # every image newest first; the others share one batched search
        rows: list = [None] * len(queries)
        embed_idx = [i for i, q in enumerate(queries) if q.strip() or not filters]
        embedded = search_mod.search_by_text_batch(
            state, [queries[i] for i in embed_idx], limit=limit
        )
        for i, r in zip(embed_idx, embedded):
            rows[i] = r
        listing = None
        for i in range(len(queries)):
            if rows[i] is None:
                if listing is None:  # one lock and sort for every empty query
                    listing = search_mod.get_all_images_with_limit(state, limit=limit)
                rows[i] = [dict(md) for md in listing]
        return {"results": [apply_search_filters(r, filters) for r in rows]}

    @app.post("/api/search/image-batch")
    def search_image_batch(req):
        """Batched image search: multipart ``files`` (repeated), ``limit``,
        ``filters``, ``remove_bg`` -> ``{"results": [[...], ...]}``, one row
        per file in order, shaped like /api/search/image's results."""
        form = req.form()
        files = [f for f in form.getlist("files") if isinstance(f, UploadFile)]
        if not files:
            return JSONResponse({"success": False, "error": "files field required"}, 422)
        if len(files) > 256:
            return JSONResponse({"success": False, "error": "at most 256 files per batch"}, 422)
        filters = form.getlist("filters")
        limit = _parse_int(form.get("limit"), 10)
        remove_bg = _parse_bool(form.get("remove_bg"))
        images = []
        for f, img in zip(files, default_loader().decode_each([f.content for f in files])):
            if isinstance(img, Exception):
                return JSONResponse(
                    {"success": False, "error": f"Cannot open image {f.filename!r}: {img}"}, 422
                )
            image = Image.fromarray(img)
            if remove_bg:
                image = _maybe_remove_query_bg(state, image)
            images.append(image)
        rows = search_mod.search_by_image_batch(state, images, limit=limit)
        return {"results": [apply_search_filters(r, filters) for r in rows]}

    @app.get("/api/images")
    def get_images(req):
        with state.lock:
            return {"images": list(state.image_metadata.values())}

    @app.get("/api/image/{image_id}")
    def get_image(req, image_id):
        md = state.image_metadata.get(image_id)
        if md is None:
            return JSONResponse({"success": False, "error": "Image not found"}, 404)
        return {"success": True, "image": md}

    @app.put("/api/metadata/{image_id}")
    def update_metadata(req, image_id):
        form = req.form()
        description = form.get("description")
        if description is None:
            # required, as the reference's Form(...): a partial PUT must
            # not null the stored description
            return JSONResponse({"success": False, "error": "description field required"}, 422)
        if not isinstance(description, str):
            return JSONResponse({"success": False, "error": "description must be a string"}, 422)
        custom_metadata = form.get("custom_metadata")
        if custom_metadata is not None and not isinstance(custom_metadata, str):
            return JSONResponse({"success": False, "error": "custom_metadata must be a string"}, 422)
        with state.lock:
            # existence checked inside the lock (a concurrent reset), and
            # the store written first, so a vanished id leaves no ghost
            # record in the mirror
            current = state.image_metadata.get(image_id)
            if current is None:
                return JSONResponse({"success": False, "error": "Image not found"}, 404)
            metadata = dict(current)
            metadata["description"] = description
            # an omitted custom_metadata clears the stored one (reference)
            metadata["custom_metadata"] = custom_metadata
            try:
                # the full record persists, not the reference's 3 fields
                state.store.update(ids=[image_id], metadatas=[metadata])
            except KeyError:
                return JSONResponse({"success": False, "error": "Image not found"}, 404)
            state.image_metadata[image_id] = metadata
        state.snapshot()
        return {"success": True, "metadata": metadata}

    # -- filters -------------------------------------------------------------

    @app.get("/api/filters")
    def get_filters(req):
        return {"filters": state.load_filters()}

    @app.post("/api/filters")
    def add_filter(req):
        form = req.form()
        try:
            filter_query = _form_str(form, "filter_query")
        except _FieldTypeError as e:
            return JSONResponse({"success": False, "error": str(e)}, 422)
        if not filter_query:
            return JSONResponse({"success": False, "error": "filter_query required"}, 422)
        # handlers run on a thread pool: the load -> append -> save must be
        # atomic, or one of two simultaneous adds is lost
        with state.lock:
            filters = state.load_filters()
            if filter_query in filters:
                return {"success": True, "message": "Filter already exists", "filters": filters}
            filters.append(filter_query)
            state.save_filters(filters)
        app.add_background_task(process_filter_on_all_images, state, filter_query)
        return {"success": True, "filters": filters}

    @app.post("/api/filters/batch")
    def add_filters_batch(req):
        """Comma-separated batch add."""
        form = req.form()
        try:
            raw = _form_str(form, "filter_queries", "")
        except _FieldTypeError as e:
            return JSONResponse({"success": False, "error": str(e)}, 422)
        queries = [q.strip() for q in raw.split(",") if q.strip()]
        with state.lock:
            filters = state.load_filters()
            added = []
            for q in queries:
                if q not in filters:
                    filters.append(q)
                    added.append(q)
            state.save_filters(filters)
        for q in added:
            app.add_background_task(process_filter_on_all_images, state, q)
        return {"success": True, "added": added, "filters": filters}

    @app.delete("/api/filters/{filter_query}")
    def delete_filter(req, filter_query):
        with state.lock:
            filters = state.load_filters()
            if filter_query in filters:
                filters.remove(filter_query)
                state.save_filters(filters)
                return {"success": True, "filters": filters}
        return JSONResponse({"success": False, "error": "Filter not found"}, 404)

    @app.get("/api/filter-progress")
    def filter_progress(req):
        q = req.query_param("filter_query")
        if q not in state.filter_progress:
            return {"status": "not_found"}
        return state.filter_progress[q]

    @app.post("/api/reset")
    def reset(req):
        try:
            state.reset()
        except Exception as e:
            return JSONResponse({"success": False, "error": str(e)}, 500)
        return {"success": True}

    # -- legacy capabilities -------------------------------------------------

    @app.post("/search")
    def unified_search(req):
        """Text, image or multimodal search, chosen by which inputs are
        present; ``enhance_with_caption`` appends the query image's caption
        to a multimodal query."""
        form = req.form()
        file = form.get("file")
        try:
            query = (_form_str(form, "query") or "").strip()
        except _FieldTypeError as e:
            return JSONResponse({"success": False, "error": str(e)}, 422)
        weight_image = _parse_float(form.get("weight_image"), 0.5)
        limit = _parse_int(form.get("limit"), 10)
        filters = form.getlist("filters")
        enhance = _parse_bool(form.get("enhance_with_caption"))
        has_image = isinstance(file, UploadFile) and file.content
        if has_image and query:
            image = _open_upload(file)
            if enhance:
                query = search_mod.enhance_query_with_caption(state, image, query)
            results = search_mod.search_multimodal(
                state, image, query, weight_image=weight_image, limit=limit
            )
            mode = "multimodal"
        elif has_image:
            results = search_mod.search_by_image(state, _open_upload(file), limit=limit)
            mode = "image"
        elif query:
            results = search_mod.search_by_text(state, query, limit=limit)
            mode = "text"
        else:
            return JSONResponse({"success": False, "error": "provide a query or an image"}, 422)
        return {"mode": mode, "results": apply_search_filters(results, filters)}

    @app.post("/upload-samples")
    def upload_samples(req):
        """Bulk ingest of a samples directory: IMATCH_SAMPLES_DIR, or
        ``images/`` under the app root. An undecodable file is reported as
        an error of its own."""
        samples_dir = os.environ.get("IMATCH_SAMPLES_DIR", os.path.join(state.root, "images"))
        if not os.path.isdir(samples_dir):
            return JSONResponse({"success": False, "error": "no samples directory"}, 404)
        files = sorted(os.listdir(samples_dir))
        images, names, failed_decode = [], [], []
        for f, img in zip(files, default_loader().decode_each([os.path.join(samples_dir, f) for f in files])):
            if isinstance(img, Exception):
                failed_decode.append({"filename": f, "status": "error", "error": str(img)})
            else:
                images.append(img)
                names.append(f)
        results = process_batch(state, images, names) + failed_decode
        state.snapshot()
        return {
            "success": True,
            "total": len(files),
            "successful": sum(r["status"] == "success" for r in results),
            "skipped": sum(r["status"] == "skipped" for r in results),
            "failed": sum(r["status"] == "error" for r in results),
            "results": results,
        }

    @app.get("/api/health")
    def health(req):
        return {
            "status": "ok",
            "images": state.store.count(),
            "captioner": getattr(state.captioner, "available", False),
            "model": state.embedder.cfg.name if state.embedder else None,
        }

    # -- observability -------------------------------------------------------

    @app.get("/api/metrics")
    def metrics(req):
        snap = METRICS.snapshot()
        snap["index_count"] = state.store.count()
        snap["index"] = state.store.stats()
        return snap

    @app.post("/api/profile/start")
    def profile_start(req):
        try:
            return {"success": True, "trace_dir": profiler.start_trace(req.form().get("log_dir"))}
        except RuntimeError as e:
            return JSONResponse({"success": False, "error": str(e)}, 409)

    @app.post("/api/profile/stop")
    def profile_stop(req):
        try:
            return {"success": True, "trace_dir": profiler.stop_trace()}
        except RuntimeError as e:
            return JSONResponse({"success": False, "error": str(e)}, 409)

    register_ui(app)  # GET / (search) and GET /manage
    return app
