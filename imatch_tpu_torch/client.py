"""Typed Python client for the ImageMatch REST API.

A copy of ``imatch_tpu/client.py``: the contract is the same on both
packages' servers (``python run.py`` and ``python -m imatch_tpu_torch``).
The reference ships a typed axios client wrapping every endpoint (its
frontend's ``src/lib/api.ts``); this is its first-party Python
equivalent: one method per route, the sequential folder upload that
classifies 409s as "skipped (duplicate)", the batched folder upload
chunked by payload size, and a filter-progress poller.

Uses only the standard library (urllib).
"""

from __future__ import annotations

import json
import mimetypes
import os
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class ApiError(Exception):
    def __init__(self, status: int, body: Any):
        super().__init__(f"HTTP {status}: {body}")
        self.status = status
        self.body = body


def _encode_multipart(fields: Sequence[Tuple[str, Any]]) -> Tuple[bytes, str]:
    boundary = uuid.uuid4().hex
    out = bytearray()
    for name, value in fields:
        out += f"--{boundary}\r\n".encode()
        if isinstance(value, tuple):  # (filename, bytes)
            filename, data = value
            ctype = (
                mimetypes.guess_type(filename)[0]
                or "application/octet-stream"
            )
            # HTML5/browser escaping: percent-encode the three unsafe
            # characters. Backslash-escaping quotes does NOT round-trip
            # (the server's filename="..." capture stops at the first
            # quote); %22 is what browsers send and servers store it
            # literally, with no truncation or header injection.
            safe_name = (
                filename.replace('"', "%22")
                .replace("\r", "%0D")
                .replace("\n", "%0A")
            )
            out += (
                f'Content-Disposition: form-data; name="{name}"; '
                f'filename="{safe_name}"\r\n'
                f"Content-Type: {ctype}\r\n\r\n"
            ).encode()
            out += data
        else:
            out += (
                f'Content-Disposition: form-data; name="{name}"\r\n\r\n'
            ).encode()
            out += str(value).encode()
        out += b"\r\n"
    out += f"--{boundary}--\r\n".encode()
    return bytes(out), f"multipart/form-data; boundary={boundary}"


class ImageMatchClient:
    def __init__(self, base_url: str = "http://localhost:8000", timeout: float = 300.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # -- transport ----------------------------------------------------------

    def _request(
        self,
        method: str,
        path: str,
        fields: Optional[Sequence[Tuple[str, Any]]] = None,
        ok_statuses: Sequence[int] = (200,),
        json_body: Any = None,
    ) -> Any:
        url = self.base_url + path
        data, headers = None, {}
        if json_body is not None:
            data = json.dumps(json_body).encode()
            headers["Content-Type"] = "application/json"
        elif fields is not None:
            data, ctype = _encode_multipart(fields)
            headers["Content-Type"] = ctype
        req = urllib.request.Request(
            url, data=data, headers=headers, method=method
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            body = e.read().decode()
            try:
                body = json.loads(body)
            except json.JSONDecodeError:
                pass
            if e.code in ok_statuses:
                return body
            raise ApiError(e.code, body) from None

    # -- uploads ------------------------------------------------------------

    def upload(
        self,
        path: str,
        description: str = "",
        custom_metadata: str = "",
        remove_bg: bool = False,
    ) -> Dict:
        """Upload one image; a duplicate (409) returns the existing
        metadata with ``duplicate: True`` instead of raising."""
        with open(path, "rb") as f:
            data = f.read()
        res = self._request(
            "POST",
            "/api/upload",
            [
                ("file", (os.path.basename(path), data)),
                ("description", description),
                ("custom_metadata", custom_metadata),
                ("remove_bg", str(remove_bg).lower()),
            ],
            ok_statuses=(200, 409),
        )
        if not res.get("success"):
            res["duplicate"] = True
        return res

    def upload_folder(
        self,
        paths: Sequence[str],
        remove_bg: bool = False,
        on_progress: Optional[Callable[[int, int, Dict], None]] = None,
    ) -> List[Dict]:
        """Sequential per-file upload with 409 -> "skipped" classification
        (mirrors uploadFolderWithProgress, api.ts:125-230)."""
        results = []
        for i, p in enumerate(paths):
            try:
                r = self.upload(p, remove_bg=remove_bg)
                status = "skipped" if r.get("duplicate") else "success"
                entry = {"filename": os.path.basename(p), "status": status}
            except (ApiError, OSError) as e:
                entry = {
                    "filename": os.path.basename(p),
                    "status": "error",
                    "reason": str(e),
                }
            results.append(entry)
            if on_progress:
                on_progress(i + 1, len(paths), entry)
        return results

    def upload_folder_batched(
        self,
        paths: Sequence[str],
        remove_bg=False,
        max_batch_bytes: int = 64 * 1024 * 1024,
        max_batch_files: int = 256,
    ) -> Dict:
        """Batched /api/upload-folder, chunked by payload size — one
        request per <=64 MB / <=256 files instead of materializing the
        whole folder in memory twice (a 5 GB corpus would hold ~10 GB
        transient RAM and time out a single request). Returns one merged
        summary across all chunks."""
        merged = {
            "success": True,
            "total": 0,
            "successful": 0,
            "skipped": 0,
            "failed": 0,
            "results": [],
        }

        def _send(fields):
            fields.append(("remove_bg", str(remove_bg).lower()))
            out = self._request("POST", "/api/upload-folder", fields)
            merged["total"] += out.get("total", 0)
            for k in ("successful", "skipped", "failed"):
                merged[k] += out.get(k, 0)
            merged["results"].extend(out.get("results", []))
            merged["success"] = merged["success"] and out.get("success", False)

        fields: List[Tuple[str, Any]] = []
        size = 0
        for p in paths:
            with open(p, "rb") as f:
                data = f.read()
            if fields and (
                size + len(data) > max_batch_bytes
                or len(fields) >= max_batch_files
            ):
                _send(fields)
                fields, size = [], 0
            fields.append(("files", (os.path.basename(p), data)))
            size += len(data)
        if fields:
            _send(fields)
        return merged

    # -- search ---------------------------------------------------------------

    def search_text(self, query: str, filters: Sequence[str] = (), limit: int = 10):
        fields = [("query", query), ("limit", limit)]
        fields += [("filters", f) for f in filters]
        return self._request("POST", "/api/search/text", fields)["results"]

    def search_text_batch(
        self,
        queries: Sequence[str],
        filters: Sequence[str] = (),
        limit: int = 10,
    ):
        """Batched text search: one request, one device dispatch for all
        queries; returns a list of result rows (one per query). Use this
        when issuing many queries — per-query latency amortizes the
        round-trip (POST /api/search/batch)."""
        body = {"queries": list(queries), "limit": limit,
                "filters": list(filters)}
        return self._request(
            "POST", "/api/search/batch", json_body=body
        )["results"]

    def search_image(self, path: str, filters: Sequence[str] = (), limit: int = 10):
        with open(path, "rb") as f:
            data = f.read()
        fields = [("file", (os.path.basename(path), data)), ("limit", limit)]
        fields += [("filters", f) for f in filters]
        return self._request("POST", "/api/search/image", fields)["results"]

    def search_image_batch(
        self,
        paths: Sequence[str],
        filters: Sequence[str] = (),
        limit: int = 10,
    ):
        """Batched image search: one request, the vision tower and index
        run all N query images in batched device dispatches; returns one
        result row per path, in order (POST /api/search/image-batch)."""
        fields: List[Tuple[str, Any]] = [("limit", limit)]
        for p in paths:
            with open(p, "rb") as f:
                fields.append(("files", (os.path.basename(p), f.read())))
        fields += [("filters", f) for f in filters]
        return self._request(
            "POST", "/api/search/image-batch", fields
        )["results"]

    def search_multimodal(
        self,
        path: str,
        query: str,
        weight_image: float = 0.5,
        filters: Sequence[str] = (),
        limit: int = 10,
    ):
        with open(path, "rb") as f:
            data = f.read()
        fields = [
            ("file", (os.path.basename(path), data)),
            ("query", query),
            ("weight_image", weight_image),
            ("limit", limit),
        ]
        fields += [("filters", f) for f in filters]
        return self._request("POST", "/api/search/multimodal", fields)["results"]

    # -- images / metadata ----------------------------------------------------

    def images(self) -> List[Dict]:
        return self._request("GET", "/api/images")["images"]

    def image(self, image_id: str) -> Dict:
        return self._request("GET", f"/api/image/{image_id}")["image"]

    def update_metadata(
        self, image_id: str, description: str, custom_metadata: str = ""
    ) -> Dict:
        return self._request(
            "PUT",
            f"/api/metadata/{image_id}",
            [
                ("description", description),
                ("custom_metadata", custom_metadata),
            ],
        )

    # -- filters ----------------------------------------------------------------

    def filters(self) -> List[str]:
        return self._request("GET", "/api/filters")["filters"]

    def add_filter(self, filter_query: str) -> Dict:
        return self._request(
            "POST", "/api/filters", [("filter_query", filter_query)]
        )

    def delete_filter(self, filter_query: str) -> Dict:
        # safe="" percent-encodes "/" too (encodeURIComponent semantics,
        # frontend/src/lib/api.ts) — the route pattern is [^/]+, so a raw
        # slash in the filter text would 404.
        return self._request(
            "DELETE",
            f"/api/filters/{urllib.parse.quote(filter_query, safe='')}",
        )

    def filter_progress(self, filter_query: str) -> Dict:
        q = urllib.parse.urlencode({"filter_query": filter_query})
        return self._request("GET", f"/api/filter-progress?{q}")

    def wait_for_filter(
        self, filter_query: str, poll_s: float = 0.5, timeout_s: float = 600
    ) -> Dict:
        """Poll /api/filter-progress until completed/error (the UI polls
        at 500 ms, frontend/src/app/manage/page.tsx:122-192)."""
        deadline = time.time() + timeout_s
        grace = time.time() + 10.0  # registration race: the backfill
        # thread writes its progress record AFTER POST /api/filters
        # returns, so an immediate poll can see not_found for a moment
        while time.time() < deadline:
            p = self.filter_progress(filter_query)
            status = p.get("status")
            if status in ("completed", "error"):
                return p
            if status == "not_found" and time.time() > grace:
                return p
            time.sleep(poll_s)
        raise TimeoutError(filter_query)

    # -- admin ---------------------------------------------------------------

    def reset(self) -> Dict:
        return self._request("POST", "/api/reset", [])

    def health(self) -> Dict:
        return self._request("GET", "/api/health")

    def metrics(self) -> Dict:
        return self._request("GET", "/api/metrics")
