"""vlm_caption_ms.caption_search: the program's ``vlm.caption`` timer over
the window, its mean a request: the captioner's prefill and greedy decode
of the caption, after it holds the captioner's lock."""


def read(ctx):
    t = ctx.program_metrics.get("timings", {}).get("vlm.caption")
    if not ctx.requests or not t or not t["count"]:
        return None
    return t["total_s"] / t["count"] * 1e3
