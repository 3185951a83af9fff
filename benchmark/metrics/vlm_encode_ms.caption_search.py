"""vlm_encode_ms.caption_search: the program's ``vlm.encode`` timer over
the window, its mean a request: the captioner's encode of the query
image (its wait for the captioner's lock not included; the features
copied to the host)."""


def read(ctx):
    t = ctx.program_metrics.get("timings", {}).get("vlm.encode")
    if not ctx.requests or not t or not t["count"]:
        return None
    return t["total_s"] / t["count"] * 1e3
