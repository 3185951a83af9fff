"""tower_wait_ms.search: the program's ``embed.wait`` timer over the
window, its mean a request: a tower call's wait for the embedder's lock,
which every worker shares (the queue in front of the tower)."""


def read(ctx):
    t = ctx.program_metrics.get("timings", {}).get("embed.wait")
    if not ctx.requests or not t or not t["count"]:
        return None
    return t["total_s"] / t["count"] * 1e3
