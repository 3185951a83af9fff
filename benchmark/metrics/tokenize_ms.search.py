"""tokenize_ms.search: the program's ``embed.tokenize`` timer over the
window, its mean a request: the host's tokenizing of a request's texts."""


def read(ctx):
    t = ctx.program_metrics.get("timings", {}).get("embed.tokenize")
    if not ctx.requests or not t or not t["count"]:
        return None
    return t["total_s"] / t["count"] * 1e3
