"""store_rows_ms.search: the program's ``index.rows`` timer over the
window, its mean a request: the store turning a request's (Q, k) indices
into id, distance and metadata lists. Part of ``store_query_ms.search``."""


def read(ctx):
    t = ctx.program_metrics.get("timings", {}).get("index.rows")
    if not ctx.requests or not t or not t["count"]:
        return None
    return t["total_s"] / t["count"] * 1e3
