"""REST API application — the reference app's v2 contract, the routes
ported so far.

Counterpart of ``imatch_tpu/serving/app.py`` ``create_app`` for
``/api/upload``, ``/api/upload-folder``, ``/api/search/text`` (POST and
GET), ``/api/search/image``, ``/api/search/multimodal``, ``/api/images``,
``/api/image/{id}``, ``PUT /api/metadata/{id}``, the filter routes
(``GET``/``POST /api/filters``, ``POST /api/filters/batch``, ``DELETE
/api/filters/{filter_query}``, ``GET /api/filter-progress``; a new filter
is back-filled over every stored image in a background task),
``/api/reset`` and ``/api/health``, with the same responses (ids, 409 on a
duplicate, 422 for string fields sent as file parts, ``limit=0`` -> up to
1000, the folder's per-file statuses and counts, the progress records).
The other routes of the JAX app answer 501 and name the ROADMAP.md item
that will bring them.

Uploads decode with PIL, a folder's files on a thread pool: the JAX app's
loader takes this path where its C++ decoder is not built, and both give
the same pixels for lossless formats. A new upload, a folder with at
least one success and a metadata edit end at ``state.snapshot()``, as in
the JAX app: the journal already holds each op, and the snapshot compacts
it once it has grown.
"""

from __future__ import annotations

import io
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
from PIL import Image

from imatch_tpu_torch.device import DeviceLike
from imatch_tpu_torch.pipeline import search as search_mod
from imatch_tpu_torch.pipeline.backfill import process_filter_on_all_images
from imatch_tpu_torch.pipeline.filters import passes_filters
from imatch_tpu_torch.pipeline.ingest import process_batch, process_image
from imatch_tpu_torch.pipeline.state import AppState
from imatch_tpu_torch.serving.asgi import App, JSONResponse, UploadFile

logger = logging.getLogger("imatch.api")

CORS_ORIGINS = [
    "http://localhost:3000",
    "http://127.0.0.1:3000",
    "http://localhost:8000",
    "*",
]

# Routes of the JAX app that later slices bring, with the ROADMAP item.
_LATER_ROUTES = [
    ("POST", "/api/search/batch", "Queue 1 step 7 (the remaining routes)"),
    ("POST", "/api/search/image-batch", "Queue 1 step 7 (the remaining routes)"),
    ("POST", "/search", "Queue 1 step 7 (the remaining routes)"),
    ("POST", "/upload-samples", "Queue 1 step 7 (the remaining routes)"),
    ("GET", "/api/metrics", "Queue 1 step 13 (operations surface)"),
    ("POST", "/api/profile/start", "Queue 1 step 13 (operations surface)"),
    ("POST", "/api/profile/stop", "Queue 1 step 13 (operations surface)"),
    ("GET", "/", "Queue 1 step 7 (the remaining routes: web UI)"),
    ("GET", "/manage", "Queue 1 step 7 (the remaining routes: web UI)"),
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
    with Image.open(io.BytesIO(file.content)) as im:
        return im.convert("RGB")


def _decode_rgb(content: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(content)) as im:
        return np.asarray(im.convert("RGB"))


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


def _later(item: str):
    def handler(req, **_):
        return JSONResponse(
            {
                "success": False,
                "error": f"not ported to imatch_tpu_torch yet: ROADMAP.md {item}",
            },
            501,
        )

    return handler


def create_app(
    state: Optional[AppState] = None, root: str = ".", device: DeviceLike = None
) -> App:
    if state is None:
        state = AppState(root=root, device=device)
    app = App(cors_origins=CORS_ORIGINS)
    app.state = state
    app.mount_static("/static", state.static_dir)

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
        if todo:
            workers = min(8, os.cpu_count() or 1, len(todo))
            with ThreadPoolExecutor(workers, thread_name_prefix="imatch-decode") as pool:
                futures = [pool.submit(_decode_rgb, f.content) for f in todo]
                for f, fut in zip(todo, futures):
                    try:
                        images.append(fut.result())
                        names.append(f.filename)
                        raws.append(f.content)
                    except Exception as e:
                        results.append(
                            {"filename": f.filename, "status": "error", "reason": f"Cannot open image: {e}"}
                        )
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
        results = search_mod.search_by_image(state, _open_upload(file), limit=limit)
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
        results = search_mod.search_multimodal(
            state, _open_upload(file), query, weight_image=weight_image, limit=limit
        )
        return {"results": apply_search_filters(results, filters)}

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

    @app.get("/api/health")
    def health(req):
        return {
            "status": "ok",
            "images": state.store.count(),
            "captioner": getattr(state.captioner, "available", False),
            "model": state.embedder.cfg.name if state.embedder else None,
        }

    for method, path, item in _LATER_ROUTES:
        app.route(path, [method])(_later(item))

    return app
