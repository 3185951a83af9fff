"""The port's spans on its batched text-search path, on the CPU.

``Metrics.timer`` is the port's one span: it observes the block's wall
time into METRICS and, while a torch.profiler session records, opens
``record_function`` of the same name, so the span lies in the Chrome
trace on the calling thread, on the kernels' clock.

- Profiler off: one ``search_by_text_batch`` with ``record_function``
  made to raise (so it is never entered) records each span of the path
  exactly once; a text served from the LRU records no tokenizing.
- Profiler on (``utils/profiler.profile_trace``): every span of the path
  is a ``user_annotation`` on the calling thread, the store's nested in
  the order of the calls.
- A tower call that waits for the embedder's lock, held by another
  thread for a known sleep, records an ``embed.wait`` of at least it.
"""

import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from imatch_tpu_torch.index.store import VectorStore
from imatch_tpu_torch.models.clip.configs import TINY
from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
from imatch_tpu_torch.pipeline.search import search_by_text_batch
from imatch_tpu_torch.utils import profiler
from imatch_tpu_torch.utils.metrics import METRICS

NEW_SPANS = ("embed.wait", "embed.tokenize", "index.fetch", "index.rows", "search.rows")
PATH_SPANS = NEW_SPANS + ("embed.text", "index.query", "index.dispatch")
TEXTS = ["a red drill on a bench", "two cats", "a harbour at night"]
HOLD_S = 0.2


@pytest.fixture(scope="module")
def state():
    emb = ClipEmbedder(config=TINY, device="cpu")
    st = VectorStore(device="cpu")
    rows = np.random.default_rng(0).standard_normal((64, emb.dim)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    st.add(ids=[f"img_{i}" for i in range(64)], embeddings=rows, metadatas=[{"n": i} for i in range(64)])
    s = types.SimpleNamespace(get_embedder=lambda: emb, store=st)
    search_by_text_batch(s, TEXTS, limit=3)  # first call outside every count
    return s


def _counts():
    return {k: v["count"] for k, v in METRICS.snapshot()["timings"].items()}


@pytest.fixture(scope="module")
def counts_off(state):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler session")

    assert not torch.autograd.profiler._is_profiler_enabled
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.autograd.profiler, "record_function", refuse)
        METRICS.reset()
        rows = search_by_text_batch(state, TEXTS, limit=3)
        counts = _counts()
    assert len(rows) == len(TEXTS) and all(len(r) == 3 for r in rows)
    return counts


@pytest.mark.parametrize("name", PATH_SPANS)
def test_profiler_off_counts_each_span_once(counts_off, name):
    assert counts_off[name] == 1


def test_cache_hit_records_no_tokenizing(state):
    emb = state.get_embedder()
    text = "a cached caption"
    emb.embed_text_device(text)
    METRICS.reset()
    emb.embed_text_device(text)
    snap = METRICS.snapshot()
    assert snap["counters"].get("embed.text_cache_hit") == 1
    assert "embed.tokenize" not in snap["timings"] and "embed.wait" not in snap["timings"]


@pytest.fixture(scope="module")
def traced(state, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("trace"))
    METRICS.reset()
    with profiler.profile_trace(d):
        search_by_text_batch(state, TEXTS, limit=3)
    counts = _counts()
    with open(f"{d}/trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            spans.setdefault(e["name"], []).append(e)
    return spans, counts


@pytest.mark.parametrize("name", PATH_SPANS)
def test_profiler_on_span_on_calling_thread(traced, name):
    spans, counts = traced
    assert counts[name] == 1  # the observation stays beside the span
    assert len(spans.get(name, [])) == 1, sorted(spans)
    (e,) = spans[name]
    assert e["tid"] == threading.get_native_id() and float(e["dur"]) > 0


@pytest.mark.parametrize(
    "inner, outer",
    [("index.fetch", "index.dispatch"), ("index.dispatch", "index.query"), ("index.rows", "index.query")],
)
def test_profiler_on_store_spans_nest(traced, inner, outer):
    spans, _ = traced
    (i,), (o,) = spans[inner], spans[outer]
    assert float(o["ts"]) <= float(i["ts"])
    assert float(i["ts"]) + float(i["dur"]) <= float(o["ts"]) + float(o["dur"])


class _ArrivalLock:
    """The embedder's lock, with an event set when a caller reaches it."""

    def __init__(self, lock):
        self._lock = lock
        self.arrived = threading.Event()

    def acquire(self, *a, **k):
        self.arrived.set()
        return self._lock.acquire(*a, **k)

    def release(self):
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


@pytest.mark.parametrize(
    "call",
    [
        lambda emb: emb.embed_texts_device(TEXTS),
        lambda emb: emb.embed_images_device([np.zeros((40, 30, 3), np.uint8)]),
    ],
    ids=["text", "image"],
)
def test_tower_wait_covers_the_lock_holder(state, monkeypatch, call):
    emb = state.get_embedder()
    lock = _ArrivalLock(emb._lock)
    monkeypatch.setattr(emb, "_lock", lock)
    held = threading.Event()

    def holder():
        with lock._lock:
            held.set()
            assert lock.arrived.wait(10)
            time.sleep(HOLD_S)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    assert held.wait(10)
    METRICS.reset()
    call(emb)
    t.join(10)
    wait = METRICS.snapshot()["timings"]["embed.wait"]
    assert wait["count"] == 1 and wait["max_ms"] >= HOLD_S * 1e3
