"""store_query_ms.search: the program's ``index.query`` timer over the
window, its mean a request: the store query up to its results on the
host."""


def read(ctx):
    t = ctx.program_metrics.get("timings", {}).get("index.query")
    if not ctx.requests or not t or not t["count"]:
        return None
    return t["total_s"] / t["count"] * 1e3
