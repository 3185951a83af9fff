"""The port's framework-free copies held to the JAX package's originals.

- ``utils/metrics.py``: the same observations and counters give the same
  ``snapshot()`` (``uptime_s`` aside, a clock reading).
- ``runtime/scheduler.py``: the same thread script parks and releases in
  the same order, with the sequence-number fairness of the docstring (a
  checkpoint waits for the sections open when it is reached, not for later
  ones), and the timeout bounds a wait.
- ``pipeline/search.py::enhance_query_with_caption``: the same caption is
  cut at the same word boundary.

Every thread has a timeout of its own.
"""

import threading
import time
import types

import numpy as np
import pytest
from PIL import Image

from imatch_tpu.pipeline.search import enhance_query_with_caption as jax_enhance
from imatch_tpu.runtime.scheduler import PriorityGate as JaxGate
from imatch_tpu.utils.metrics import Metrics as JaxMetrics
from imatch_tpu_torch.pipeline.search import enhance_query_with_caption
from imatch_tpu_torch.runtime.scheduler import GATE, PriorityGate
from imatch_tpu_torch.utils.metrics import METRICS, Metrics, timer


def _observe(m):
    rng = np.random.default_rng(0)
    for i, s in enumerate(rng.exponential(0.01, 700)):  # past the 512-sample ring
        m.observe("index.query" if i % 3 else "embed.text", float(s))
    m.inc("images_embedded", 5)
    m.inc("images_embedded")
    m.inc("embed.text_cache_hit", 3)
    with m.timer("ingest.add"):
        pass
    return m.snapshot()


def _without_clock(snap):
    snap = dict(snap)
    snap.pop("uptime_s")
    snap["timings"] = dict(snap["timings"])
    # the one timer() sample is a clock reading too: keep its count only
    snap["timings"]["ingest.add"] = snap["timings"]["ingest.add"]["count"]
    return snap


def test_metrics_snapshot_equals_jax():
    got, want = _observe(Metrics()), _observe(JaxMetrics())
    assert _without_clock(got) == _without_clock(want)
    assert list(got["timings"]) == sorted(got["timings"])
    assert got["timings"]["index.query"]["count"] == 466


def test_metrics_reset_and_module_timer():
    m = Metrics()
    m.inc("x")
    m.reset()
    assert m.snapshot()["counters"] == {} and m.snapshot()["timings"] == {}
    before = METRICS.snapshot()["timings"].get("test.module_timer", {}).get("count", 0)
    with timer("test.module_timer"):
        pass
    assert METRICS.snapshot()["timings"]["test.module_timer"]["count"] == before + 1


def _gate_script(gate_cls):
    """A bulk thread reaches a checkpoint while section A is open; section
    B opens after it. Closing A releases the checkpoint although B is
    still open. Returns the event order."""
    gate = gate_cls()
    log = []
    a_open, a_close = threading.Event(), threading.Event()
    b_open, b_close = threading.Event(), threading.Event()
    parked = threading.Event()

    def section(name, opened, close):
        with gate.priority():
            log.append(f"{name} open")
            opened.set()
            assert close.wait(10)
            log.append(f"{name} close")

    def bulk():
        parked.set()
        waited = gate.checkpoint(timeout=10)
        log.append(f"checkpoint returned waited={waited}")

    ta = threading.Thread(target=section, args=("A", a_open, a_close))
    ta.start()
    assert a_open.wait(10)
    assert gate.contended
    tb_bulk = threading.Thread(target=bulk)
    tb_bulk.start()
    assert parked.wait(10)
    time.sleep(0.05)  # the bulk thread is inside checkpoint()
    tb = threading.Thread(target=section, args=("B", b_open, b_close))
    tb.start()
    assert b_open.wait(10)
    time.sleep(0.05)
    log.append("closing A")
    a_close.set()
    tb_bulk.join(10)
    ta.join(10)
    assert not tb_bulk.is_alive() and not ta.is_alive()
    log.append("closing B")
    b_close.set()
    tb.join(10)
    assert not tb.is_alive()
    assert not gate.contended
    log.append(f"idle checkpoint waited={gate.checkpoint(timeout=1)}")
    return log


def test_gate_park_and_release_order_equals_jax():
    got = _gate_script(PriorityGate)
    assert got == _gate_script(JaxGate)
    assert got == [
        "A open",
        "B open",
        "closing A",
        "A close",
        "checkpoint returned waited=True",
        "closing B",
        "B close",
        "idle checkpoint waited=False",
    ]


@pytest.mark.parametrize("gate_cls", [PriorityGate, JaxGate], ids=["port", "jax"])
def test_gate_checkpoint_timeout_bounds_a_stuck_section(gate_cls):
    gate = gate_cls()
    release = threading.Event()
    opened = threading.Event()

    def stuck():
        with gate.priority():
            opened.set()
            release.wait(10)

    t = threading.Thread(target=stuck)
    t.start()
    assert opened.wait(10)
    t0 = time.perf_counter()
    assert gate.checkpoint(timeout=0.2) is True
    assert 0.15 < time.perf_counter() - t0 < 5
    release.set()
    t.join(10)
    assert not t.is_alive()


def test_process_gate_is_one_object():
    from imatch_tpu_torch.index import store
    from imatch_tpu_torch.pipeline import embedder

    assert store.GATE is GATE and embedder.GATE is GATE


class _Captioner:
    available = True

    def __init__(self, caption):
        self._caption = caption

    def encode_image(self, image_np):
        return {"features": np.asarray(image_np, np.float32).mean()}

    def caption(self, encoded):
        return {"caption": self._caption}


_WORDS = " ".join(f"word{i}" for i in range(400))


@pytest.mark.parametrize(
    "caption,query",
    [
        (_WORDS, "red drill"),  # cut at a word boundary
        ("x" * 2000, "red drill"),  # no space to cut at
        ("a drill on a bench", "red drill"),  # fits whole
        (_WORDS, ""),  # no query: the caption alone
        ("", "red drill"),  # empty caption: the query as is
        (_WORDS, "q" * 1000),  # no budget left
    ],
    ids=["words", "no-space", "short", "no-query", "empty-caption", "no-budget"],
)
def test_enhance_query_with_caption_equals_jax(caption, query):
    image = Image.fromarray(np.full((8, 8, 3), 100, np.uint8))
    state = types.SimpleNamespace(captioner=_Captioner(caption))
    got = enhance_query_with_caption(state, image, query)
    assert got == jax_enhance(state, image, query)
    assert len(got) <= max(248 * 4, len(query))


def test_enhance_without_captioner_returns_query():
    image = Image.fromarray(np.zeros((8, 8, 3), np.uint8))
    state = types.SimpleNamespace(captioner=types.SimpleNamespace(available=False))
    assert enhance_query_with_caption(state, image, "q") == "q"
