"""k2_roofline.caption_search: K2 (``flash_fwd_mma_kernel``) in the traced
stretch, over the launches whose shape the launching span gives: the
captioner's vision tower (the family's ``k2_shapes``: Moondream's
``vlm.encode``, (1, 16, 729, 72)), the CLIP image tower (``embed.image``)
and the causal text tower (``embed.text``, at its context). Each launch's
bound at its shape (q, k and v read once, the output written once, every
pair computed, or those on and below the diagonal) summed, over their
device time (device trace)."""

from benchmark.lib import flops, program

KERNEL = "flash_fwd_mma_kernel"


def read(ctx):
    s = ctx.trace_summary
    if s is None or not ctx.requests or "captioner" not in ctx.cfg:
        return None
    v, t = ctx.cfg["vision_config"], ctx.cfg["text_config"]
    shapes = dict(program.family(ctx.cfg["captioner"], ctx.bench_dir).k2_shapes(ctx.cfg["captioner"]))
    shapes["embed.image"] = (1, v["num_attention_heads"], (v["image_size"] // v["patch_size"]) ** 2 + 1,
                             v["hidden_size"] // v["num_attention_heads"], False)
    shapes["embed.text"] = (1, t["num_attention_heads"], t["max_position_embeddings"],
                            t["hidden_size"] // t["num_attention_heads"], True)
    bound, dev_s = 0.0, 0.0
    for key, (secs, launches) in s.get("kernel_by_span", {}).items():
        name, span = key.split("|", 1)
        if name == KERNEL and span in shapes:
            bound += launches * flops.bound_s(*flops.k2_launch(*shapes[span]))
            dev_s += secs
    if bound == 0 or dev_s == 0:
        return None
    return 100.0 * bound / dev_s
