"""search_p50_ms: the median latency of every request due in the window,
from its due time to its results (host clock)."""

from benchmark.lib import stats


def read(ctx):
    if not ctx.requests:
        return None
    wait_end = ctx.notes["wait_end_s"]
    lat = stats.open_loop_latencies([r["due"] for r in ctx.requests],
                                    [r["done"] if r["ok"] else None for r in ctx.requests], wait_end)
    return stats.percentile(lat, 50) * 1e3
