"""Device-queue priority gate: bulk work yields to latency-critical work.

A copy of ``imatch_tpu/runtime/scheduler.py``. The card runs the kernels
of one stream in order, so a search queued behind a bulk caption or
ingest stream waits for all of it. Two halves:

- latency-critical paths (the store's engine call and its copy to the
  host) run inside ``GATE.priority()``;
- bulk paths (caption decode segments, yes/no and encode chunks, fused
  ingest chunks) call ``GATE.checkpoint()`` between device dispatches, at
  a point where the host has already waited for the previous chunk. While
  a priority section is open, the bulk path parks (bounded wait), so the
  search queues behind at most the chunks already on the card.

Cooperative scheduling on the host: the card has no preemption.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

__all__ = ["PriorityGate", "GATE"]


class PriorityGate:
    """Fairness note: a checkpoint waits only for priority sections
    ALREADY OPEN when it is reached (a sequence-number handoff), not
    for later arrivals — a continuous search stream therefore cannot
    starve bulk work; the two interleave one-quantum-for-one-query."""

    def __init__(self):
        self._cond = threading.Condition()
        self._next_seq = 0  # priority sections ever opened
        self._open: set = set()  # seq numbers of in-flight sections

    @contextmanager
    def priority(self):
        """Mark a latency-critical section (dispatch + fetch)."""
        with self._cond:
            seq = self._next_seq
            self._next_seq += 1
            self._open.add(seq)
        try:
            yield
        finally:
            with self._cond:
                self._open.discard(seq)
                self._cond.notify_all()

    def checkpoint(self, timeout: float = 2.0) -> bool:
        """Bulk yield point: park until every priority section open at
        this moment has finished (or ``timeout`` — a stuck search must
        not wedge ingest). Returns True if it waited. Costs one
        uncontended lock acquire when idle.

        Exactness matters here: the wait is on the SET of open section
        ids below the snapshot, not on a finished-count — with counters,
        a later section opening and closing quickly could satisfy the
        count while a section open at snapshot time was still in flight,
        letting a bulk quantum interleave mid-section."""
        with self._cond:
            target = self._next_seq
            if not any(s < target for s in self._open):
                return False
            deadline = time.monotonic() + timeout
            while any(s < target for s in self._open):
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(left)
        return True

    @property
    def contended(self) -> bool:
        return bool(self._open)


GATE = PriorityGate()
