"""tower_dispatch_ms.search: the program's ``embed.text`` timer over the
window, its mean a request: the host's time to enqueue a request's text
tower (the call returns before the card has run it)."""


def read(ctx):
    t = ctx.program_metrics.get("timings", {}).get("embed.text")
    if not ctx.requests or not t or not t["count"]:
        return None
    return t["total_s"] / t["count"] * 1e3
