"""Per-stage timing metrics: counters and duration series.

A copy of ``imatch_tpu/utils/metrics.py`` (the port imports nothing of the
JAX package). Every pipeline stage records into the process-wide
``METRICS``: counters, and duration series with a bounded ring of recent
samples for percentiles. Served by ``GET /api/metrics``. An observation
costs one lock and a float append.

``timer`` is also the port's only span: while a torch.profiler session
records (``/api/profile/start``, or any other), it opens
``record_function`` of the same name around the block, so the span lies
in the Chrome trace on the calling thread, on the clock of the kernels
and copies. With no session it reads one flag and nothing more.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict

from torch.autograd import profiler as _profiler

_NO_SPAN = contextlib.nullcontext()


class _Series:
    __slots__ = ("count", "total", "max", "ring")

    def __init__(self, ring_size: int = 512):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self.ring = collections.deque(maxlen=ring_size)

    def observe(self, seconds: float):
        self.count += 1
        self.total += seconds
        if seconds > self.max:
            self.max = seconds
        self.ring.append(seconds)

    def snapshot(self) -> Dict:
        recent = sorted(self.ring)
        n = len(recent)

        def pct(p):
            return recent[min(n - 1, int(p * n))] * 1e3 if n else 0.0

        return {
            "count": self.count,
            "total_s": round(self.total, 4),
            "mean_ms": round(self.total / self.count * 1e3, 3)
            if self.count
            else 0.0,
            "p50_ms": round(pct(0.50), 3),
            "p95_ms": round(pct(0.95), 3),
            "max_ms": round(self.max * 1e3, 3),
        }


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._series: Dict[str, _Series] = {}
        self._counters: Dict[str, int] = collections.defaultdict(int)
        self._started = time.time()

    def observe(self, name: str, seconds: float):
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = _Series()
            s.observe(seconds)

    def inc(self, name: str, n: int = 1):
        with self._lock:
            self._counters[name] += n

    @contextlib.contextmanager
    def timer(self, name: str):
        """Observe the block's wall time into ``name``; while a profiler
        session records, the block is also its ``record_function`` span."""
        span = _profiler.record_function(name) if _profiler._is_profiler_enabled else _NO_SPAN
        with span:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.observe(name, time.perf_counter() - t0)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "uptime_s": round(time.time() - self._started, 1),
                "counters": dict(self._counters),
                "timings": {
                    k: s.snapshot() for k, s in sorted(self._series.items())
                },
            }

    def reset(self):
        with self._lock:
            self._series.clear()
            self._counters.clear()
            self._started = time.time()


METRICS = Metrics()


def timer(name: str):
    """Module-level convenience: ``with timer("embed.image"): ...``"""
    return METRICS.timer(name)
