"""result_rows_ms.search: the program's ``search.rows`` timer over the
window, its mean a request: the search pipeline building a request's
result dicts from the store's rows."""


def read(ctx):
    t = ctx.program_metrics.get("timings", {}).get("search.rows")
    if not ctx.requests or not t or not t["count"]:
        return None
    return t["total_s"] / t["count"] * 1e3
