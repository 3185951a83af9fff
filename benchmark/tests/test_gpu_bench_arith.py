"""The benchmark's frozen arithmetic: operation and byte counts from
shapes, percentiles, spreads, open-loop latencies and the trace's busy
and in-request time."""

import math
import statistics

import pytest

from benchmark.lib import flops, peaks, stats

B32 = {
    "projection_dim": 512,
    "vision_config": {"hidden_size": 768, "intermediate_size": 3072, "num_hidden_layers": 12, "patch_size": 32,
                      "image_size": 224, "num_attention_heads": 12},
    "text_config": {"hidden_size": 512, "intermediate_size": 2048, "num_hidden_layers": 12, "num_attention_heads": 8},
}


def test_text_flops_counts_causal_pairs_through_eos():
    n, d = 5, 512
    layer = 8 * n * d * d + 4 * n * d * 2048 + 4 * d * (n * (n + 1) / 2)
    assert flops.text_flops(B32, n) == 12 * layer + 2 * d * 512


def test_k1_launch_counts():
    ops, nbytes = flops.k1_launch(1 << 20, 768, 256, 512)
    assert ops == 2 * (1 << 20) * 768 * 256
    assert nbytes == (1 << 20) * 768 * 2 + (1 << 20) + 256 * 768 * 2 + 256 * 2048 * 4
    # at 768 wide and Q = 256 the corpus read bounds K1 (PERF.md's 0.48 ms)
    assert flops.bound_s(ops, nbytes) == pytest.approx(nbytes / peaks.HBM_BYTES_PER_S)
    assert 0.45e-3 < flops.bound_s(ops, nbytes) < 0.5e-3


def test_percentile_interpolates_like_numpy():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 95) == pytest.approx(4.8)
    assert stats.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_spread_is_quartile_distance_over_median():
    xs = [10.0, 11.0, 9.0, 10.5, 9.5, 10.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def test_stall_inside_the_window_moves_the_p95():
    """Open loop: 100 requests due every 10 ms, each served in 5 ms. A
    300 ms stall at 0.5 s holds every request due during it, and the
    latency from the due time counts the wait."""
    due = [i * 0.01 for i in range(100)]
    done = [t + 0.005 for t in due]
    calm = stats.percentile(stats.open_loop_latencies(due, done, 10.0), 95)
    stalled, free_at = [], 0.0
    for t in due:
        start = max(t, free_at, 0.8 if 0.5 <= t < 0.8 else 0.0)
        free_at = start + 0.005
        stalled.append(free_at)
    hit = stats.percentile(stats.open_loop_latencies(due, stalled, 10.0), 95)
    assert calm == pytest.approx(0.005)
    assert hit > 0.2
    # timed from when each was sent, the stall would not show at all
    sent = [max(t, s - 0.005) for t, s in zip(due, stalled)]
    assert stats.percentile([s - x for s, x in zip(stalled, sent)], 95) == pytest.approx(0.005)


def test_missing_answer_waits_until_the_end():
    lat = stats.open_loop_latencies([0.0, 1.0], [0.1, None], 61.0)
    assert lat == [0.1, 60.0]
    assert math.isfinite(stats.percentile(lat, 95))


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_idle_in_request_leaves_out_the_schedules_gaps():
    """A 1000 us stretch: two requests in their calls (100-300 and 250-400
    us, on two threads) and one at 700-800; kernels at 150-200, 350-450
    and 900-950. In-request time 300 + 100 us, of it busy 50 + 50 + 0 us:
    idle in requests 75%, while the whole stretch idles 80%."""
    from benchmark.lib import trace

    events = [
        _ev("bench.stretch", "user_annotation", 0, 1000),
        _ev("bench.search.request", "user_annotation", 100, 200),
        _ev("bench.search.request", "user_annotation", 250, 150),
        _ev("bench.search.request", "user_annotation", 700, 100),
        _ev("k", "kernel", 150, 50),
        _ev("k", "kernel", 350, 100),
        _ev("k", "kernel", 900, 50),
    ]
    s = trace.summarize(events)
    assert s["request_s"] == pytest.approx(400e-6)
    assert s["busy_in_request_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(200e-6)

    class Ctx:
        trace_summary, requests = s, [{}]

    from benchmark.lib.spec import Spec
    from gpu_bench_support import REPO

    read = Spec(REPO).reader("idle_in_request_pct.search")
    assert read(Ctx) == pytest.approx(75.0)
