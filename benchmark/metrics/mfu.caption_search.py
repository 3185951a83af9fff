"""mfu.caption_search: the useful operations of the requests completed
inside the traced stretch, over the card's busy seconds in the stretch at
the bf16 peak: the captioner's encode, prefill and one decode step a
generated token after the first (its family's ``request_flops``), the
CLIP image tower, the text tower at the embedded text's ids through its
eos, and 2 N D of scoring. Busy time, not wall time: at a fixed offered
rate the operations a wall second cannot move."""

from benchmark.lib import flops, peaks, program
from benchmark.reference import tokenizer


def read(ctx):
    s = ctx.trace_summary
    if s is None or not ctx.requests or s["busy_s"] <= 0 or "captioner" not in ctx.cfg:
        return None
    cc = ctx.cfg["captioner"]
    fam = program.family(cc, ctx.bench_dir)
    a, b = ctx.stretch[0] - ctx.t0, ctx.stretch[1] - ctx.t0
    t = ctx.cfg["text_config"]
    total = 0.0
    for i, r in enumerate(ctx.requests):
        cap = ctx.captions.get(i)
        if r["ok"] and cap and a <= r["done"] <= b:
            total += fam.request_flops(cc, cap["prompt"], cap["generated"])
            total += flops.image_flops(ctx.cfg)
            total += sum(flops.text_flops(ctx.cfg, n) for n in tokenizer.token_counts(ctx.texts[i], t["max_position_embeddings"]))
            total += flops.scoring_flops(ctx.store_rows, ctx.cfg["projection_dim"], 1)
    if total == 0:
        return None
    return 100.0 * total / (s["busy_s"] * peaks.BF16_FLOPS)
