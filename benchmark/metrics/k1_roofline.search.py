"""k1_roofline.search: K1 (``tile_max_mma_kernel``) in the traced
stretch: each launch's bound at (store rows, width, queries a request),
the corpus, its mask and the queries read once and the tile maxima
written once, over its device time (device trace)."""

from benchmark.lib import flops, trace


def read(ctx):
    s = ctx.trace_summary
    if s is None or not ctx.requests:
        return None
    dev_s, launches = trace.kernel_time(s, "tile_max_mma_kernel")
    if launches == 0 or dev_s == 0:
        return None
    rows = -(-ctx.store_rows // 512) * 512
    ops, nbytes = flops.k1_launch(rows, ctx.cfg["projection_dim"], ctx.mix["per_request"], 512)
    return 100.0 * launches * flops.bound_s(ops, nbytes) / dev_s
