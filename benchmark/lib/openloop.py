"""The open-loop window every serving driver runs.

Requests fall due on a fixed schedule (``lib/data.arrivals``) whatever
the system's state; ``workers`` threads (the server's IMATCH_WORKERS)
take them in order and serve each through ``handle(i)``, inside a
``bench.<driver>.request`` span, which returns whether the answer is
whole. A request's record holds its due, start and done times from the
window's start; one that raises is counted as failed with its error, one
that has not answered a minute after the window as never done. With
``--trace 1`` a torch.profiler session records the stretch
``[trace_from x seconds, + trace_seconds]``. After the window: the
program's METRICS over it, the device's memory peak, the trace's summary,
the records, and how late the schedule sent each request.
"""

from __future__ import annotations

import gc
import queue
import threading
import time
from typing import Callable

import numpy as np
import torch

from . import cell
from .cell import now

GRACE_S = 60.0


def serve(ctx: cell.Context, due, handle: Callable[[int], bool], span: str, workers: int, metrics) -> bool:
    """Run the window; fill ``ctx``'s window fields. Returns whether a
    worker was still busy when the grace ran out."""
    mix = ctx.mix
    records = [dict(due=float(d), start=None, done=None, ok=False, err=None) for d in due]
    work: "queue.Queue" = queue.Queue()
    t0 = None

    def worker():
        while True:
            item = work.get()
            if item is None:
                return
            rec = records[item]
            rec["start"] = now() - t0
            try:
                with torch.autograd.profiler.record_function(span):
                    rec["ok"] = bool(handle(item))
            except Exception as e:  # a failed request is counted, not raised
                rec["err"] = repr(e)
            rec["done"] = now() - t0

    threads = [threading.Thread(target=worker, daemon=True, name=f"bench-worker-{k}") for k in range(workers)]
    for t in threads:
        t.start()
    tracer = None
    if ctx.trace:
        from .trace import Tracer

        tracer = Tracer()
    trace_at = (mix["trace_from"] * ctx.seconds, mix["trace_from"] * ctx.seconds + mix["trace_seconds"])
    late = []
    pauses = []

    def on_gc(phase, info):
        if info["generation"] == 2:
            pauses.append(now()) if phase == "start" else pauses.append(now() - pauses.pop())

    gc.callbacks.append(on_gc)
    t0 = ctx.start_window()
    metrics.reset()
    for i, d in enumerate(due):
        while True:
            t = now() - t0
            if tracer is not None and not tracer.started and ctx.stretch is None and t >= trace_at[0]:
                tracer.start()
                ctx.stretch = (now(), None)
            elif tracer is not None and tracer.started and ctx.stretch[1] is None and t >= trace_at[1]:
                tracer.stop()
                ctx.stretch = (ctx.stretch[0], now())
            if t >= d:
                break
            time.sleep(min(d - t, 0.05))
        late.append(now() - t0 - d)
        work.put(i)
    while now() - t0 < ctx.seconds:
        time.sleep(0.001)
    ctx.window_s = ctx.seconds
    for _ in threads:
        work.put(None)
    for t in threads:
        t.join(timeout=max(0.0, ctx.seconds + GRACE_S - (now() - t0)))
    if tracer is not None and tracer.started and ctx.stretch[1] is None:
        tracer.stop()
        ctx.stretch = (ctx.stretch[0], now())
    wait_end = now() - t0
    hung = any(t.is_alive() for t in threads)
    gc.callbacks.remove(on_gc)
    ctx.notes["gc_full_collections"] = float(len(pauses))
    ctx.notes["gc_full_s"] = float(sum(pauses))
    ctx.program_metrics = metrics.snapshot()
    ctx.memory_peak_bytes = cell.peak_memory(ctx.device)
    if tracer is not None:
        ctx.trace_summary = tracer.read()
    ctx.requests = records
    ctx.attempted = len(records)
    ctx.failed = sum(1 for r in records if not r["ok"])
    ctx.notes["late_p95_ms"] = float(np.percentile(late, 95)) * 1e3
    ctx.notes["late_max_ms"] = float(np.max(late)) * 1e3
    ctx.notes["wait_end_s"] = wait_end
    return hung
