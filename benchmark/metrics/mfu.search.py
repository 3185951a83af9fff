"""mfu.search: the useful operations of the requests completed inside
the traced stretch (the text tower at each text's ids through its eos,
and 2 N D Q of scoring), over the card's busy seconds in the stretch at
the bf16 peak. Busy time, not wall time: at a fixed offered rate the
operations a wall second cannot move."""

from benchmark.lib import flops, peaks
from benchmark.reference import tokenizer


def read(ctx):
    s = ctx.trace_summary
    if s is None or not ctx.requests or s["busy_s"] <= 0:
        return None
    a, b = ctx.stretch[0] - ctx.t0, ctx.stretch[1] - ctx.t0
    t = ctx.cfg["text_config"]
    total = 0.0
    for i, r in enumerate(ctx.requests):
        if r["ok"] and a <= r["done"] <= b:
            counts = tokenizer.token_counts(ctx.texts[i], t["max_position_embeddings"])
            total += sum(flops.text_flops(ctx.cfg, n) for n in counts)
            total += flops.scoring_flops(ctx.store_rows, ctx.cfg["projection_dim"], len(counts))
    if total == 0:
        return None
    return 100.0 * total / (s["busy_s"] * peaks.BF16_FLOPS)
