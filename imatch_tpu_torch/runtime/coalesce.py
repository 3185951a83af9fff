"""Dynamic request coalescing: concurrent single-query searches share
one engine dispatch.

A copy of ``imatch_tpu/runtime/coalesce.py`` whose ``_stack`` concatenates
torch tensors (on the card when any member is there) instead of jax
arrays. K1 scores a (Q, d) block of queries for little more than one
(PERF.md: 0.52 ms at Q = 16 against 0.51 ms at Q = 1 over 2^20 rows), so
when single-query requests arrive together one batched engine call beats
Q calls in a row. ``POST /api/search/batch`` serves clients that batch
themselves; this module serves those that do not.

No added latency at low load: the worker blocks on the first request and
then drains whatever is already queued (no timed window), so a lone query
goes straight through and batches form only while the card is busy with
an earlier group. Requests with different (k, include) land in separate
groups; a batch of several groups runs them on parallel threads. The
store enables it (IMATCH_COALESCE on a ``cuda`` store, or the
``coalesce`` constructor argument).
"""

from __future__ import annotations

import os
import queue
import threading
import weakref
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Callable, Sequence, Tuple

_CLOSE = object()  # sentinel: worker drains and exits


class CoalescerClosed(RuntimeError):
    """Raised by submit() when the coalescer has been closed — distinct
    from engine errors propagated out of a batch, so callers can fall
    back to a direct dispatch unambiguously."""


def _default_max_batch() -> int:
    """IMATCH_COALESCE_MAX (default 16): largest coalesced batch, within
    the power-of-two Q buckets that the app's warmup runs."""
    # clamp: 0/negative would make the drain loop `while len(batch) < 0`
    # never batch — every query its own dispatch serialized through ONE
    # worker thread, strictly worse than coalescing disabled
    return max(1, int(os.environ.get("IMATCH_COALESCE_MAX", "16")))


class QueryCoalescer:
    """Funnels single-row queries into batched calls of ``direct``.

    ``direct(q, n_results, include) -> dict`` is the store's internal
    query implementation taking an already-normalized (Q, d) array
    (numpy or a torch tensor); results are chroma-shaped lists-of-lists and are
    split back row-per-future. Requests are grouped by
    (n_results, include) so every member of a batch wants the same k
    and the same result fields.
    """

    def __init__(self, direct: Callable, max_batch: int | None = None):
        # Hold the dispatch target WEAKLY when it is a bound method: the
        # worker thread must not pin the owning store (its embedding
        # matrix) after the store is dropped without close(). A finalize
        # hook on the owner closes the coalescer so the thread is reaped
        # too; plain functions are kept strongly (nothing to pin).
        try:
            ref = weakref.WeakMethod(direct)
            weakref.finalize(direct.__self__, self.close)
            self._direct_ref = ref
        except TypeError:
            self._direct_ref = lambda d=direct: d
        if max_batch is None:
            max_batch = _default_max_batch()
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._started = False
        self._closed = False
        self._lock = threading.Lock()

    # -- client side ---------------------------------------------------------

    def submit(self, q, n_results: int, include: Tuple[str, ...]) -> dict:
        """Block until the (1, d) query ``q`` has been answered as part
        of some batch; returns the single-row chroma-shaped dict."""
        fut: Future = Future()
        # enqueue under the same lock close() takes: nothing can land
        # AFTER the _CLOSE sentinel, so no future is ever stranded (an
        # unsynchronized check-then-put could block fut.result() forever)
        with self._lock:
            if self._closed:
                raise CoalescerClosed("coalescer is closed")
            if not self._started:
                threading.Thread(
                    target=self._loop,
                    daemon=True,
                    name="imatch-coalesce",
                ).start()
                self._started = True
            self._q.put((q, int(n_results), tuple(include), fut))
        try:
            return fut.result(
                timeout=float(
                    os.environ.get("IMATCH_COALESCE_TIMEOUT_S", "120")
                )
            )
        except FuturesTimeout:
            # the worker wedged or died (it is belt-and-suspenders
            # guarded, but an unbounded wait would consume serving
            # threads one request at a time until the server starves):
            # degrade to a direct single-row dispatch
            direct = self._direct_ref()
            if direct is None:
                raise CoalescerClosed("coalescer owner was collected")
            res = direct(q, int(n_results), tuple(include))
            return {key: [val[0]] for key, val in res.items()}

    def close(self):
        """Stop the worker (after it finishes anything already queued)
        and reject further submits. Releases the worker's reference to
        the owning store so a discarded store is collectable."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._started:
                self._q.put(_CLOSE)

    # -- worker side -----------------------------------------------------------

    def _drain(self):
        """First request blocking, then everything already queued.
        Returns (batch, closing)."""
        first = self._q.get()
        if first is _CLOSE:
            return [], True
        batch, closing = [first], False
        while len(batch) < self.max_batch:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is _CLOSE:
                closing = True
                break
            batch.append(item)
        return batch, closing

    @staticmethod
    def _stack(rows: Sequence):
        """Stack (1, d) rows: a tensor on the card when any member is one
        (numpy members are moved there), numpy for pure-host groups."""
        if len(rows) == 1:
            return rows[0]
        import torch

        dev = next(
            (r.device for r in rows if isinstance(r, torch.Tensor) and r.device.type != "cpu"),
            None,
        )
        if dev is not None or any(isinstance(r, torch.Tensor) for r in rows):
            return torch.cat(
                [torch.as_tensor(r, dtype=torch.float32, device=dev) for r in rows], dim=0
            )
        import numpy as np

        return np.concatenate(list(rows), axis=0)

    def _run_group(self, k: int, inc: Tuple[str, ...], members):
        futs = [f for _, f in members]
        try:
            direct = self._direct_ref()
            if direct is None:  # owner collected mid-flight
                raise CoalescerClosed("coalescer owner was collected")
            res = direct(
                self._stack([q for q, _ in members]), k, inc
            )
            for i, fut in enumerate(futs):
                fut.set_result({key: [val[i]] for key, val in res.items()})
        except BaseException as e:  # propagate, never strand callers
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)

    def _loop(self):
        while True:
            batch, closing = self._drain()
            groups: dict = {}
            for q, k, inc, fut in batch:
                groups.setdefault((k, inc), []).append((q, fut))
            if len(groups) == 1:
                ((k, inc), members), = groups.items()
                self._run_group(k, inc, members)
            elif groups:
                # distinct (k, include) groups pipeline on device like
                # independent requests did pre-coalescing — one thread
                # per group rather than serializing full round-trips.
                # Thread creation itself can fail (RuntimeError under
                # thread exhaustion): groups whose thread never started
                # must have their futures failed, not stranded — an
                # unresolved future blocks its caller and, worse, an
                # exception escaping this loop would kill the worker
                # and strand EVERY later submit.
                ts = []
                started = set()
                try:
                    for (k, inc), members in groups.items():
                        t = threading.Thread(
                            target=self._run_group, args=(k, inc, members)
                        )
                        t.start()
                        ts.append(t)
                        started.add((k, inc))
                except BaseException as e:  # noqa: BLE001
                    for gk, members in groups.items():
                        if gk not in started:
                            for _, fut in members:
                                if not fut.done():
                                    fut.set_exception(e)
                for t in ts:
                    t.join()
            if closing:
                # defensively fail anything that somehow remains queued
                while True:
                    try:
                        item = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if item is not _CLOSE and not item[3].done():
                        item[3].set_exception(
                            CoalescerClosed("coalescer is closed")
                        )
