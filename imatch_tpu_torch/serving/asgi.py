"""Minimal ASGI web framework (a copy of imatch_tpu/serving/asgi.py).

Feature set sized to the reference's API surface: path routing with
``{param}`` captures, query strings, urlencoded + multipart/form-data
bodies (repeated fields -> lists, file parts -> UploadFile), JSON/file
responses, CORS middleware with preflight, static directory mounts,
startup hooks, and thread-pool background tasks (the reference's
``BackgroundTasks`` runs the filter back-fill cooperatively,
backend/app/main.py:409; here it runs on a worker thread so device-bound
back-fills never stall the event loop).

Any ASGI server can host the app; tests drive it in-process through
``httpx.ASGITransport`` and production uses serving/server.py.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import json
import logging
import mimetypes
import os
import time
import re
import threading
import traceback
import urllib.parse
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("imatch.asgi")


class UploadFile:
    def __init__(self, filename: str, content: bytes, content_type: str = ""):
        self.filename = filename
        self.content = content
        self.content_type = content_type

    async def read(self) -> bytes:
        return self.content


class FormData:
    """Ordered multi-dict over parsed form fields."""

    def __init__(self):
        self._items: List[Tuple[str, Any]] = []

    def append(self, key: str, value: Any):
        self._items.append((key, value))

    def get(self, key: str, default=None):
        for k, v in self._items:
            if k == key:
                return v
        return default

    def getlist(self, key: str) -> List[Any]:
        return [v for k, v in self._items if k == key]

    def __contains__(self, key: str) -> bool:
        return any(k == key for k, _ in self._items)


class Request:
    def __init__(self, scope: dict, body: bytes):
        self.method = scope["method"].upper()
        self.path = scope["path"]
        self.headers = {
            k.decode("latin-1").lower(): v.decode("latin-1")
            for k, v in scope.get("headers", [])
        }
        self.query = urllib.parse.parse_qs(
            scope.get("query_string", b"").decode("latin-1")
        )
        self.body = body
        self.path_params: Dict[str, str] = {}

    def query_param(self, name: str, default: Optional[str] = None):
        vals = self.query.get(name)
        return vals[0] if vals else default

    def form(self) -> FormData:
        ctype = self.headers.get("content-type", "")
        if ctype.startswith("multipart/form-data"):
            return _parse_multipart(self.body, ctype)
        form = FormData()
        if ctype.startswith("application/x-www-form-urlencoded"):
            for k, vs in urllib.parse.parse_qs(
                self.body.decode("utf-8", "replace"), keep_blank_values=True
            ).items():
                for v in vs:
                    form.append(k, v)
        return form

    def json(self):
        return json.loads(self.body)


def _mp_decode(b: bytes) -> str:
    try:
        return b.decode("utf-8")
    except UnicodeDecodeError:
        return b.decode("latin-1")


def _parse_multipart(body: bytes, content_type: str) -> FormData:
    form = FormData()
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        return form
    delim = b"--" + m.group(1).encode("latin-1")
    # RFC 2046: parts are delimited by CRLF + delimiter; the CRLF belongs
    # to the DELIMITER, not the content — a naive strip would also eat
    # trailing newlines that are part of the payload (silently changing
    # uploaded bytes and therefore the image's phash id).
    segments = body.split(b"\r\n" + delim)
    first = segments[0]
    if first.startswith(delim):
        segments[0] = first[len(delim):]
    else:  # no leading delimiter: not multipart content we understand
        segments = segments[1:]
    for seg in segments:
        if seg in (b"", b"--") or seg.startswith(b"--"):
            continue  # closing delimiter / epilogue
        if seg.startswith(b"\r\n"):
            seg = seg[2:]
        if b"\r\n\r\n" in seg:
            raw_headers, content = seg.split(b"\r\n\r\n", 1)
        else:
            raw_headers, content = seg, b""
        headers = {}
        for line in raw_headers.split(b"\r\n"):
            if b":" in line:
                k, v = line.split(b":", 1)
                # browsers send RAW UTF-8 in multipart filenames (HTML5);
                # latin-1 would mojibake 'café.jpg'. Fall back to latin-1
                # only for bytes that are not valid UTF-8.
                headers[_mp_decode(k).strip().lower()] = _mp_decode(v).strip()
        disp = headers.get("content-disposition", "")
        # anchored: a bare name=" search also matches the substring
        # inside filename=" — a client that emits filename before name
        # (RFC 6266 mandates no parameter order) would register the
        # part under the FILENAME
        name_m = re.search(r'(?:^|;\s*)name="([^"]*)"', disp)
        if not name_m:
            continue
        name = name_m.group(1)
        file_m = re.search(r'filename="([^"]*)"', disp)
        if file_m:
            form.append(
                name,
                UploadFile(
                    filename=file_m.group(1),
                    content=content,
                    content_type=headers.get("content-type", ""),
                ),
            )
        else:
            form.append(name, content.decode("utf-8", "replace"))
    return form


class Response:
    def __init__(
        self,
        content: bytes = b"",
        status: int = 200,
        headers: Optional[List[Tuple[str, str]]] = None,
        media_type: str = "text/plain",
    ):
        self.body = content
        self.status = status
        self.headers = headers or []
        self.media_type = media_type


class JSONResponse(Response):
    def __init__(self, content: Any, status_code: int = 200):
        super().__init__(
            json.dumps(content).encode("utf-8"),
            status=status_code,
            media_type="application/json",
        )


class HTMLResponse(Response):
    def __init__(self, content: str, status_code: int = 200):
        super().__init__(
            content.encode("utf-8"),
            status=status_code,
            media_type="text/html; charset=utf-8",
        )


class FileResponse(Response):
    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        media = mimetypes.guess_type(path)[0] or "application/octet-stream"
        super().__init__(data, status=200, media_type=media)


class App:
    def __init__(self, cors_origins: Optional[List[str]] = None):
        # per-request access line (method path status bytes ms) — the
        # reference logs every request (SURVEY.md §5); IMATCH_ACCESS_LOG=0
        # silences it for benchmark runs
        self._access_log = os.environ.get("IMATCH_ACCESS_LOG", "1") != "0"
        # routes: (method, regex, param_names, handler)
        self._routes: List[Tuple[str, re.Pattern, List[str], Callable]] = []
        self._static: List[Tuple[str, str]] = []  # (url_prefix, directory)
        self._startup: List[Callable] = []
        self._started = False
        self._start_lock = threading.Lock()
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=int(os.environ.get("IMATCH_WORKERS", "8")),
            thread_name_prefix="imatch-handler",
        )
        self.cors_origins = cors_origins

    # -- registration -------------------------------------------------------

    def route(self, path: str, methods: List[str] = ("GET",)):
        param_names = re.findall(r"\{(\w+)\}", path)
        pattern = re.compile(
            "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", path) + "$"
        )

        def deco(fn):
            for m in methods:
                self._routes.append((m.upper(), pattern, param_names, fn))
            return fn

        return deco

    def get(self, path):
        return self.route(path, ["GET"])

    def post(self, path):
        return self.route(path, ["POST"])

    def put(self, path):
        return self.route(path, ["PUT"])

    def delete(self, path):
        return self.route(path, ["DELETE"])

    def mount_static(self, prefix: str, directory: str):
        self._static.append((prefix.rstrip("/") + "/", directory))

    def on_startup(self, fn):
        self._startup.append(fn)
        return fn

    def add_background_task(self, fn, *args):
        """Run fn on a daemon worker thread (device-bound jobs allowed)."""
        t = threading.Thread(target=fn, args=args, daemon=True)
        t.start()
        return t

    # -- dispatch -----------------------------------------------------------

    def _run_startup(self):
        with self._start_lock:
            if not self._started:
                for fn in self._startup:
                    fn()
                self._started = True

    def _cors_headers(
        self, request_origin: str = "", request_headers: str = ""
    ) -> List[Tuple[str, str]]:
        """Fetch-spec-correct CORS: allow-origin must be a SINGLE value,
        and credentials require echoing the requesting Origin (browsers
        reject '*' or comma-joined lists for credentialed requests) —
        the behavior of the reference's Starlette CORSMiddleware
        (backend/app/main.py:57-63)."""
        if self.cors_origins is None:
            return []
        # Credentialed reflection ONLY for explicitly-listed origins: a
        # "*" entry must not make the server echo arbitrary Origins with
        # allow-credentials (any page could then issue credentialed
        # requests and read responses). Unlisted origins fall through to
        # the wildcard-without-credentials branch — still usable by
        # plain fetches, never by credentialed ones.
        allowed = request_origin in self.cors_origins
        if request_origin and allowed:
            # credentialed responses must NOT use the '*' wildcard for
            # allow-headers (the Fetch spec reads it as a literal header
            # name): echo the preflight's requested headers instead
            return [
                ("access-control-allow-origin", request_origin),
                ("access-control-allow-methods", "GET, POST, PUT, DELETE, OPTIONS"),
                (
                    "access-control-allow-headers",
                    request_headers or "content-type, authorization",
                ),
                ("access-control-allow-credentials", "true"),
                ("vary", "origin"),
            ]
        if "*" in self.cors_origins:
            # no Origin header (non-browser client): wildcard without
            # credentials is the only valid combination
            return [
                ("access-control-allow-origin", "*"),
                ("access-control-allow-methods", "GET, POST, PUT, DELETE, OPTIONS"),
                ("access-control-allow-headers", "*"),
            ]
        return []

    async def _handle(self, scope, body: bytes) -> Response:
        self._run_startup()
        method = scope["method"].upper()
        # Routes match the RAW (still percent-encoded) path and captured
        # params are unquoted afterwards — unquoting first would turn an
        # encoded "/" inside a path param (e.g. a filter query
        # "indoor%2Foutdoor") into a path separator that [^/]+ can't
        # match, making such filters impossible to address. ASGI servers
        # hand the undecoded bytes in scope["raw_path"] (scope["path"] is
        # already decoded per spec).
        raw = scope.get("raw_path")
        have_raw = bool(raw)
        if have_raw:
            raw_path = raw.decode("latin-1").partition("?")[0]
        else:
            raw_path = scope["path"]
        path = urllib.parse.unquote(raw_path) if have_raw else raw_path

        if method == "OPTIONS":
            # Short-circuit only GENUINE CORS preflights (Origin +
            # access-control-request-method, CORS enabled) — __call__
            # appends the CORS headers; adding them here too would
            # duplicate access-control-allow-origin, which browsers
            # reject ("*, *" is invalid). Plain OPTIONS falls through to
            # normal routing (an app-registered handler, else 404).
            hdrs = {k: v for k, v in scope.get("headers", ())}
            if (
                self.cors_origins is not None
                and b"origin" in hdrs
                and b"access-control-request-method" in hdrs
            ):
                return Response(b"", status=204)

        # static mounts
        if method in ("GET", "HEAD"):
            for prefix, directory in self._static:
                if path.startswith(prefix):
                    try:
                        # containment check on the RESOLVED path: normpath
                        # alone misses absolute inputs (`/static//etc/passwd`
                        # would make os.path.join discard the mount
                        # directory). realpath can itself raise — a
                        # percent-encoded NUL ('/static/%00x') is a
                        # ValueError — and the file can vanish between
                        # isfile() and the read (UI grid racing a delete);
                        # neither may escape __call__ and kill the whole
                        # keep-alive connection.
                        base = os.path.realpath(directory)
                        full = os.path.realpath(
                            os.path.join(
                                base, path[len(prefix) :].lstrip("/")
                            )
                        )
                        if full != base and not full.startswith(
                            base + os.sep
                        ):
                            return JSONResponse({"error": "forbidden"}, 403)
                        if os.path.isfile(full):
                            # read on the worker pool, not the event
                            # loop: the UI grid pulls dozens of multi-MB
                            # images and a synchronous read here stalls
                            # every other connection (sync route
                            # handlers already run in this executor)
                            return await asyncio.get_running_loop().run_in_executor(
                                self._executor, FileResponse, full
                            )
                    except ValueError:
                        return JSONResponse({"error": "bad path"}, 400)
                    except OSError:
                        pass  # fall through to 404
                    return JSONResponse({"error": "not found"}, 404)

        # HEAD serves GET routes (Starlette/FastAPI behavior — the
        # reference answers HEAD on every GET endpoint); the server
        # strips the body per RFC 9110 §9.3.2.
        route_method = "GET" if method == "HEAD" else method
        for m, pattern, names, handler in self._routes:
            if m != route_method:
                continue
            match = pattern.match(raw_path)
            if match:
                # Only unquote captures when we matched a genuinely
                # percent-encoded path — when the server omitted
                # scope["raw_path"], raw_path is the already-decoded
                # scope["path"] and a second unquote would corrupt params
                # containing literal %XX (e.g. a filter named "50%2Foff").
                params = {
                    k: (urllib.parse.unquote(v) if have_raw else v)
                    for k, v in match.groupdict().items()
                }
            else:
                match = pattern.match(path)  # already-decoded client paths
                if not match:
                    continue
                params = match.groupdict()
            req = Request(scope, body)
            req.path_params = params
            try:
                if asyncio.iscoroutinefunction(handler):
                    result = await handler(req, **req.path_params)
                else:
                    # Sync handlers run on the worker pool (FastAPI runs
                    # sync routes the same way): a long device call — a
                    # first embed's jit compile takes minutes — must not
                    # freeze every other request on the event loop.
                    loop = asyncio.get_running_loop()
                    result = await loop.run_in_executor(
                        self._executor,
                        functools.partial(handler, req, **req.path_params),
                    )
                if asyncio.iscoroutine(result):
                    result = await result
            except Exception as e:  # route-level 500, like FastAPI
                logger.error(
                    "handler error on %s %s: %s\n%s",
                    method,
                    path,
                    e,
                    traceback.format_exc(),
                )
                return JSONResponse({"success": False, "error": str(e)}, 500)
            if isinstance(result, Response):
                return result
            try:
                return JSONResponse(result)
            except (TypeError, ValueError) as e:
                # non-JSON-serializable return (e.g. a numpy scalar
                # leaking into a dict) must surface as a logged 500, not
                # an unhandled exception that kills the connection
                logger.error(
                    "unserializable result on %s %s: %s", method, path, e
                )
                return JSONResponse(
                    {"success": False, "error": f"unserializable response: {e}"},
                    500,
                )
        return JSONResponse({"detail": "Not Found"}, 404)

    # -- ASGI entry ---------------------------------------------------------

    async def __call__(self, scope, receive, send):
        if scope["type"] == "lifespan":
            while True:
                message = await receive()
                if message["type"] == "lifespan.startup":
                    self._run_startup()
                    await send({"type": "lifespan.startup.complete"})
                elif message["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
            return
        assert scope["type"] == "http"
        chunks = bytearray()
        while True:
            message = await receive()
            if message["type"] == "http.request":
                # extend-and-join, not bytes +=: third-party ASGI hosts
                # deliver large uploads in ~64 KB chunks and repeated
                # bytes concatenation is O(n^2) on the event loop
                chunks.extend(message.get("body", b""))
                if not message.get("more_body"):
                    break
            elif message["type"] == "http.disconnect":
                return
        body = bytes(chunks)
        t0 = time.perf_counter()
        resp = await self._handle(scope, body)
        if self._access_log:
            logger.info(
                "%s %s -> %d %dB %.1fms",
                scope["method"],
                scope["path"],
                resp.status,
                len(resp.body),
                (time.perf_counter() - t0) * 1e3,
            )
        headers = [
            ("content-type", resp.media_type),
            ("content-length", str(len(resp.body))),
        ]
        headers += resp.headers
        req_origin = ""
        req_acrh = ""
        for hk, hv in scope.get("headers", ()):
            if hk == b"origin":
                req_origin = hv.decode("latin-1")
            elif hk == b"access-control-request-headers":
                req_acrh = hv.decode("latin-1")
        headers += self._cors_headers(req_origin, req_acrh)
        await send(
            {
                "type": "http.response.start",
                "status": resp.status,
                "headers": [
                    (k.encode("latin-1"), v.encode("latin-1"))
                    for k, v in headers
                ],
            }
        )
        await send({"type": "http.response.body", "body": resp.body})
