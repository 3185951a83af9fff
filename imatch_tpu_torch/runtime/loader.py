"""Python binding for the native decode pool (runtime/native/loader.cc).

A copy of ``imatch_tpu/runtime/loader.py`` (both are free of any
framework), so that the port decodes an upload to the JAX app's pixels: a
16-bit PNG, for one, is reduced to its high byte by libpng where PIL's
``convert("RGB")`` clips it. It exposes:

- ``NativeImageLoader``: submit bytes or paths, collect decoded RGB numpy
  arrays; decoding runs on a C++ worker pool off the GIL.
- ``decode_image_bytes``, ``decode_batch`` and ``decode_each``: wrappers
  that fall back to PIL, as JAX's do, for the formats the native path
  does not cover (AVIF) and where g++ or the codec headers are missing. A
  fallback is logged as a warning; ``toolchain_report`` says what is
  missing. Unlike JAX's, a batch's PIL fallbacks decode on a thread pool,
  as the pool would decode them: the pixels are PIL's either way.
- ``probe_image_bytes``: the (w, h) of an image from its header.

Unlike the JAX copy, which writes its library beside its source, the
shared library is built with g++ on first use (never at import) into the
repository's ``build/`` directory (ignored by git; the CUDA kernels build
there too, ops/kernels/_build.py), under a name hashed from the source
and the link line, and moved into place with ``os.replace`` so that a
concurrent build never loads a half-written file.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import io
import logging
import os
import shutil
import subprocess
import sys
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from imatch_tpu_torch.ops.kernels._build import BUILD_DIR

logger = logging.getLogger("imatch.loader")

_SRC = Path(__file__).resolve().parent / "native" / "loader.cc"
HEADERS = ("jpeglib.h", "png.h", "webp/decode.h")


def _jpeg_link_args() -> List[str]:
    """Prefer Pillow's bundled libjpeg-turbo (SIMD, several times the
    system libjpeg62), with the same v62 ABI as the system header the
    source compiles against."""
    try:
        import PIL

        libs_dir = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
        cands = sorted(glob.glob(os.path.join(libs_dir, "libjpeg-*.so.62*")))
        if cands:
            so = os.path.basename(cands[-1])
            return [f"-L{libs_dir}", f"-l:{so}", f"-Wl,-rpath,{libs_dir}"]
    except Exception:
        pass
    return ["-ljpeg"]


_LIBS = _jpeg_link_args() + ["-lpng", "-lwebp", "-lpthread"]
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
_lib_error: Optional[str] = None


def library_path() -> Path:
    """The library's path under build/: its name hashes the source, the
    compiler flags and the link line."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join((*_CXX_FLAGS, *_LIBS)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libimatch_loader-{digest}.so"


def _build_lib() -> Optional[ctypes.CDLL]:
    """Compile (if needed) and dlopen the native loader; None (and the PIL
    fallback) where that fails."""
    global _lib, _lib_failed, _lib_error
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            so_path = library_path()
            if not so_path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp_path = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
                cmd = ["g++", *_CXX_FLAGS, "-o", str(tmp_path), str(_SRC), *_LIBS]
                logger.info("building native loader: %s", " ".join(cmd))
                try:
                    proc = subprocess.run(cmd, capture_output=True, text=True)
                    if proc.returncode != 0:
                        raise RuntimeError(f"g++ failed: {proc.stderr.strip()[-2000:]}")
                    os.replace(tmp_path, so_path)
                finally:
                    if tmp_path.exists():
                        tmp_path.unlink()
            lib = ctypes.CDLL(str(so_path))
            lib.iml_create.restype = ctypes.c_void_p
            lib.iml_create.argtypes = [ctypes.c_int]
            lib.iml_destroy.argtypes = [ctypes.c_void_p]
            lib.iml_submit_mem.restype = ctypes.c_longlong
            lib.iml_submit_mem.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong]
            lib.iml_submit_file.restype = ctypes.c_longlong
            lib.iml_submit_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.iml_wait.restype = ctypes.POINTER(ctypes.c_ubyte)
            lib.iml_wait.argtypes = [
                ctypes.c_void_p,
                ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.iml_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
            lib.iml_decode_probe.restype = ctypes.c_int
            lib.iml_decode_probe.argtypes = [
                ctypes.c_char_p,
                ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            _lib = lib
        except Exception as e:  # no toolchain or headers -> PIL fallback
            logger.warning("native loader unavailable (%s); using PIL", e)
            _lib_failed = True
            _lib_error = str(e)
        return _lib


def toolchain_report() -> Dict[str, object]:
    """What the native build needs and what this machine has: g++'s path
    (None without one), whether g++ finds each codec header (None without
    g++), and the build's error if it failed."""
    gxx = shutil.which("g++")
    present: Dict[str, Optional[bool]] = {}
    for h in HEADERS:
        if gxx is None:
            present[h] = None
            continue
        probe = subprocess.run(
            [gxx, "-x", "c++", "-fsyntax-only", "-"],
            input=f"#include <cstdio>\n#include <{h}>\n",
            capture_output=True,
            text=True,
        )
        present[h] = probe.returncode == 0
    return {"g++": gxx, "headers": present, "build_error": _lib_error}


_avif_plugin_tried = False


def _pil_decode(data: bytes) -> np.ndarray:
    from PIL import Image

    global _avif_plugin_tried
    if not _avif_plugin_tried:
        # AVIF support where the plugin is installed, as the reference
        # imports it; tried once, since a failed import is not cached and
        # would search the path under the import lock at every frame
        try:
            import pillow_avif  # noqa: F401
        except ImportError:
            pass
        _avif_plugin_tried = True
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


class NativeImageLoader:
    """Ticketed async decode pool; falls back to sync PIL without g++."""

    def __init__(self, threads: Optional[int] = None):
        self.threads = threads or min(8, os.cpu_count() or 1)
        self._lib = _build_lib()
        self._pool = self._lib.iml_create(self.threads) if self._lib else None
        self._closed = False
        self._state_lock = threading.Lock()
        self._inflight = 0  # threads inside a native submit/wait call
        self._pil_pool: Optional[ThreadPoolExecutor] = None

    @property
    def native(self) -> bool:
        return self._pool is not None

    def close(self):
        """Idempotent; never destroys the pool under a thread that is
        inside a native call (a request still decoding at shutdown would
        otherwise touch freed memory). Skipping the destroy then leaks the
        pool, which is fine: close() runs at process exit."""
        with self._state_lock:
            if self._pool is None or self._closed:
                return
            if self._inflight:
                logger.warning(
                    "native loader closed with %d in-flight decodes; leaving the pool to the OS",
                    self._inflight,
                )
                self._closed = True
                return
            self._lib.iml_destroy(self._pool)
            self._closed = True

    def _enter_native(self) -> bool:
        with self._state_lock:
            if self._pool is None or self._closed:
                return False
            self._inflight += 1
            return True

    def _exit_native(self):
        with self._state_lock:
            self._inflight -= 1

    def __del__(self):
        if sys is None or sys.is_finalizing():
            return  # ctypes calls during interpreter teardown can crash
        try:
            self.close()
        except Exception:
            pass

    # -- ticketed interface ------------------------------------------------

    def submit_bytes(self, data: bytes):
        if isinstance(data, bytearray):
            # ctypes refuses a bytearray for the native call's c_char_p
            # (ArgumentError) while the PIL fallback takes it: without this
            # the fault would show only where the pool is compiled
            data = bytes(data)
        if not self._enter_native():
            return ("pil", data)
        try:
            t = self._lib.iml_submit_mem(self._pool, data, len(data))
        finally:
            self._exit_native()
        return ("native", t, data)  # the bytes stay for the PIL fallback

    def submit_path(self, path: str):
        if not self._enter_native():
            with open(path, "rb") as f:
                return ("pil", f.read())
        try:
            t = self._lib.iml_submit_file(self._pool, path.encode())
        finally:
            self._exit_native()
        return ("native", t, path)

    def wait(self, ticket) -> np.ndarray:
        if ticket[0] == "pil":
            return _pil_decode(ticket[1])
        _, t, src = ticket
        w = ctypes.c_int()
        h = ctypes.c_int()
        err = ctypes.c_int()
        if not self._enter_native():
            return _pil_decode(_read(src))
        try:
            ptr = self._lib.iml_wait(self._pool, t, ctypes.byref(w), ctypes.byref(h), ctypes.byref(err))
        finally:
            self._exit_native()
        if not ptr:
            # an unsupported format (AVIF) or a decode failure -> PIL
            return _pil_decode(_read(src))
        # Zero-copy: numpy views the malloc'd buffer, and a weakref
        # finalizer frees it when the array and every view of it are gone
        # (torch.from_numpy holds the array).
        n = w.value * h.value * 3
        arr = np.ctypeslib.as_array(ptr, shape=(n,)).reshape(h.value, w.value, 3)
        weakref.finalize(arr.base, self._lib.iml_free, ptr)
        return arr

    # -- batch convenience ---------------------------------------------------

    def decode_each(self, items: Sequence) -> List[object]:
        """bytes or paths -> for each item its RGB array or the exception
        it raised, decoded concurrently: every item is submitted before any
        is waited, native tickets on the C++ pool and PIL ones (the
        fallback without the pool) on a thread pool of ``threads``. PIL
        gives the same pixels on any thread.

        EVERY ticket is drained even when some fail: an abandoned ticket
        would leak its decoded C buffer in the pool's results map for the
        life of the process."""
        tickets: List = []
        for x in items:
            # a failed submit records its exception and goes on, so the
            # drain below still reaps every submission that succeeded
            try:
                tickets.append(
                    self.submit_bytes(x) if isinstance(x, (bytes, bytearray)) else self.submit_path(x)
                )
            except Exception as e:
                tickets.append(e)
        pil = [i for i, t in enumerate(tickets) if isinstance(t, tuple) and t[0] == "pil"]
        futures = {}
        if len(pil) > 1:
            pool = self._pil_executor()
            futures = {i: pool.submit(_pil_decode, tickets[i][1]) for i in pil}
        out: List[object] = []
        for i, t in enumerate(tickets):
            if isinstance(t, Exception):
                out.append(t)
                continue
            try:
                out.append(futures[i].result() if i in futures else self.wait(t))
            except Exception as e:
                out.append(e)
        return out

    def _pil_executor(self) -> ThreadPoolExecutor:
        """The PIL fallback's workers, started at its first batch and kept
        (a pool started for each batch spends part of every batch starting
        its threads). Idle workers exit with the loader or the
        interpreter."""
        with self._state_lock:
            if self._pil_pool is None:
                self._pil_pool = ThreadPoolExecutor(self.threads, thread_name_prefix="imatch-decode")
            return self._pil_pool

    def decode_batch(self, items: Sequence, on_error: str = "none") -> List[Optional[np.ndarray]]:
        """bytes or paths -> RGB arrays, decoded concurrently (``decode_each``).
        A failure becomes a None entry (``on_error="none"``, per-file
        isolation for bulk ingest) or is raised after the drain
        (``on_error="raise"``)."""
        out = self.decode_each(items)
        errors = [e for e in out if isinstance(e, Exception)]
        for e in errors:
            logger.warning("decode failed: %s", e)
        if on_error == "raise" and errors:
            raise errors[0]
        return [None if isinstance(a, Exception) else a for a in out]


def _read(src) -> bytes:
    if isinstance(src, bytes):
        return src
    with open(src, "rb") as f:
        return f.read()


_default_loader: Optional[NativeImageLoader] = None
_default_lock = threading.Lock()


def default_loader() -> NativeImageLoader:
    """The process's shared loader; its pool closes at exit (``atexit``),
    joining the C++ workers before interpreter teardown."""
    global _default_loader
    with _default_lock:
        if _default_loader is None:
            import atexit

            _default_loader = NativeImageLoader()
            atexit.register(_default_loader.close)
        return _default_loader


def decode_image_bytes(data: bytes) -> np.ndarray:
    return default_loader().decode_batch([data], on_error="raise")[0]


def probe_image_bytes(data: bytes):
    """Header-only (w, h) through the native pool's codecs; None where the
    pool is not built or the format needs the PIL path (AVIF)."""
    lib = _build_lib()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.iml_decode_probe(data, len(data), ctypes.byref(w), ctypes.byref(h))
    return (w.value, h.value) if rc == 0 else None
