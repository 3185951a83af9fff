"""torch.profiler traces of the live server.

Counterpart of ``imatch_tpu/utils/profiler.py``. ``start_trace`` and
``stop_trace`` bracket a trace of the host's operators and, on a card,
its kernels and copies (CUPTI); ``stop_trace`` writes it as a Chrome
trace, ``trace.json`` in the trace directory. The serving layer exposes
them as ``POST /api/profile/start`` and ``/api/profile/stop``;
``profile_trace`` is the context-manager form for scripts.

One trace at a time. A profiler session must start and stop on one
thread, and the two requests arrive on any of the server's threads, so
each trace runs on a thread of its own that waits between the two; it
records the operators of every thread where PyTorch can
(``profile_all_threads``). A session slows the process's later kernel
launches (PERF.md): profile a server, not a benchmark.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Optional

logger = logging.getLogger("imatch.profiler")

_lock = threading.Lock()
_active_dir: Optional[str] = None
_session: Optional["_Session"] = None


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _all_threads_config():
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):  # a PyTorch without the option
        return None


class _Session:
    """A profiler session on its own thread, from ``start`` to ``stop``."""

    def __init__(self, path: str):
        self.path = path
        self._started = threading.Event()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True, name="imatch-profiler")

    def _run(self):
        from torch.profiler import profile

        try:
            kw = {"activities": _activities()}
            cfg = _all_threads_config()
            if cfg is not None:
                kw["experimental_config"] = cfg
            with profile(**kw) as prof:
                self._started.set()
                self._stop.wait()
            prof.export_chrome_trace(self.path)
        except BaseException as e:  # reported by start() or stop()
            self._error = e
        finally:
            self._started.set()

    def start(self):
        self._thread.start()
        self._started.wait()
        if self._error is not None:
            raise RuntimeError(f"profiler did not start: {self._error}")

    def stop(self):
        self._stop.set()
        self._thread.join()
        if self._error is not None:
            raise RuntimeError(f"profiler trace not written: {self._error}")


def start_trace(log_dir: Optional[str] = None) -> str:
    """Begin a trace; returns the trace directory."""
    global _active_dir, _session
    with _lock:
        if _active_dir is not None:
            raise RuntimeError(f"trace already active in {_active_dir}")
        log_dir = log_dir or os.path.join("profiles", time.strftime("%Y%m%d-%H%M%S"))
        os.makedirs(log_dir, exist_ok=True)
        session = _Session(os.path.join(log_dir, "trace.json"))
        session.start()
        _session, _active_dir = session, log_dir
        logger.info("profiler trace started -> %s", log_dir)
        return log_dir


def stop_trace() -> str:
    """End the active trace; returns the trace directory."""
    global _active_dir, _session
    with _lock:
        if _active_dir is None:
            raise RuntimeError("no active trace")
        # cleared BEFORE the stop: if the export raises (disk full), a
        # still-set directory would wedge both endpoints until a restart
        out, _active_dir = _active_dir, None
        session, _session = _session, None
        session.stop()
        logger.info("profiler trace written -> %s", out)
        return out


def active_trace_dir() -> Optional[str]:
    return _active_dir


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    d = start_trace(log_dir)
    try:
        yield d
    finally:
        stop_trace()
