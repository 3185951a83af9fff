"""store_fetch_ms.search: the program's ``index.fetch`` timer over the
window, its mean a request: the copy of the engine's scores and indices
to the host, which waits for every kernel queued before it on the
stream (other requests' towers among them). Part of
``store_query_ms.search``."""


def read(ctx):
    t = ctx.program_metrics.get("timings", {}).get("index.fetch")
    if not ctx.requests or not t or not t["count"]:
        return None
    return t["total_s"] / t["count"] * 1e3
