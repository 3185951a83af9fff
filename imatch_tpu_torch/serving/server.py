"""Asyncio HTTP/1.1 server hosting an ASGI app (a copy of imatch_tpu/serving/server.py).

First-party replacement for uvicorn (reference app backend/run.py:8-15).
HTTP/1.1 with keep-alive and content-length bodies — the feature set the
reference deployment actually uses; no chunked-upload or websocket
support.
"""

from __future__ import annotations

import asyncio
import logging
import os
import socket
logger = logging.getLogger("imatch.server")

_MAX_HEADER = 64 * 1024
_MAX_BODY = 512 * 1024 * 1024


def _idle_timeout() -> float:
    """Keep-alive / header-read timeout (slowloris guard): a client
    that opens a connection and trickles or sends nothing must not pin
    a connection task forever. nginx-style default."""
    return float(os.environ.get("IMATCH_HTTP_IDLE_TIMEOUT", "75"))


def _body_timeout() -> float:
    return float(os.environ.get("IMATCH_HTTP_BODY_TIMEOUT", "300"))


async def _handle_connection(app, reader, writer):
    try:
        while True:
            try:
                header_blob = await asyncio.wait_for(
                    reader.readuntil(b"\r\n\r\n"), _idle_timeout()
                )
            except (
                asyncio.IncompleteReadError,
                asyncio.LimitOverrunError,
                asyncio.TimeoutError,
            ):
                return
            if len(header_blob) > _MAX_HEADER:
                return
            head = header_blob.decode("latin-1")
            request_line, *header_lines = head.split("\r\n")
            parts = request_line.split(" ")
            if len(parts) != 3:
                return
            method, target, version = parts
            headers = []
            for line in header_lines:
                if ":" in line:
                    k, v = line.split(":", 1)
                    # re-encode latin-1, NOT the utf-8 default: the blob
                    # was decoded latin-1, and ASGI header values are
                    # latin-1 bytes — a default .encode() would transcode
                    # raw byte 0xE9 ('é') into two UTF-8 bytes and hand
                    # the app mojibake
                    headers.append(
                        (
                            k.strip().lower().encode("latin-1"),
                            v.strip().encode("latin-1"),
                        )
                    )
            hdict = {k: v for k, v in headers}
            if b"chunked" in hdict.get(b"transfer-encoding", b"").lower():
                # Reading per content-length (0) would leave the chunked
                # payload on the connection to be parsed as the NEXT
                # request — a desync/smuggling vector. Refuse instead.
                writer.write(
                    b"HTTP/1.1 501 Not Implemented\r\n"
                    b"connection: close\r\ncontent-length: 0\r\n\r\n"
                )
                await writer.drain()
                return
            try:
                length = int(hdict.get(b"content-length", b"0"))
            except ValueError:
                length = -1
            if length < 0:
                # 'abc' or a negative value: answer 400 instead of an
                # unhandled exception killing the connection task
                writer.write(
                    b"HTTP/1.1 400 Bad Request\r\n"
                    b"connection: close\r\ncontent-length: 0\r\n\r\n"
                )
                await writer.drain()
                return
            if length > _MAX_BODY:
                writer.write(b"HTTP/1.1 413 Payload Too Large\r\n\r\n")
                await writer.drain()
                return
            if (
                length
                and b"100-continue"
                in hdict.get(b"expect", b"").lower()
            ):
                # RFC 9110 §10.1.1: clients sending Expect: 100-continue
                # wait for the interim response before transmitting the
                # body — curl stalls ~1 s per bulk upload without it,
                # stricter clients stall until the body timeout
                writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                await writer.drain()
            try:
                body = (
                    await asyncio.wait_for(
                        reader.readexactly(length), _body_timeout()
                    )
                    if length
                    else b""
                )
            except (asyncio.IncompleteReadError, asyncio.TimeoutError):
                return

            if "?" in target:
                path, _, query = target.partition("?")
            else:
                path, query = target, ""
            scope = {
                "type": "http",
                "asgi": {"version": "3.0"},
                "http_version": "1.1",
                "method": method,
                "path": path,
                "raw_path": target.encode("latin-1"),
                "query_string": query.encode("latin-1"),
                "headers": headers,
                "client": writer.get_extra_info("peername"),
                "server": writer.get_extra_info("sockname"),
                "scheme": "http",
            }

            received = False

            async def receive():
                nonlocal received
                if received:
                    return {"type": "http.disconnect"}
                received = True
                return {"type": "http.request", "body": body, "more_body": False}

            status_line = {}
            out_headers = []
            out_body = bytearray()

            async def send(message):
                if message["type"] == "http.response.start":
                    status_line["status"] = message["status"]
                    out_headers.extend(message.get("headers", []))
                elif message["type"] == "http.response.body":
                    out_body.extend(message.get("body", b""))

            await app(scope, receive, send)

            keep_alive = hdict.get(b"connection", b"keep-alive").lower() != b"close"
            resp = [f"HTTP/1.1 {status_line.get('status', 500)} \r\n".encode()]
            seen_len = False
            for k, v in out_headers:
                if k.lower() == b"content-length":
                    seen_len = True
                resp.append(k + b": " + v + b"\r\n")
            if not seen_len:
                resp.append(f"content-length: {len(out_body)}\r\n".encode())
            resp.append(
                b"connection: keep-alive\r\n" if keep_alive else b"connection: close\r\n"
            )
            resp.append(b"\r\n")
            # HEAD: headers only (content-length kept). Sending the body
            # desyncs keep-alive clients that correctly stop at the
            # header end (RFC 9110 §9.3.2).
            if method == "HEAD":
                writer.write(b"".join(resp))
            else:
                writer.write(b"".join(resp) + bytes(out_body))
            await writer.drain()
            if not keep_alive:
                return
    except (ConnectionResetError, BrokenPipeError):
        pass
    finally:
        try:
            writer.close()
            await writer.wait_closed()
        except Exception:
            pass


async def serve_async(app, host: str = "0.0.0.0", port: int = 8000, ready=None):
    server = await asyncio.start_server(
        lambda r, w: _handle_connection(app, r, w),
        host,
        port,
        limit=_MAX_HEADER,
        family=socket.AF_INET,
    )
    logger.info("serving on http://%s:%d", host, port)
    if ready is not None:
        ready.set()
    async with server:
        await server.serve_forever()


def serve(app, host: str = "0.0.0.0", port: int = 8000):
    asyncio.run(serve_async(app, host, port))
