"""The open-loop caption-enhanced image-search driver: the legacy
/search route with ``enhance_with_caption`` on.

Each request is one image and one query. It calls
``pipeline.search.enhance_query_with_caption(state, image, query)`` (the
captioner's encode and its caption of ``MAX_NEW`` greedy tokens, appended
to the query within the text tower's budget) and then
``search_multimodal(state, image, enhanced, weight_image, limit)`` (the
CLIP image and text towers, their weighted blend, one store query), as
the route does, through the schedule, workers and warm-up of the search
driver (``lib/openloop.py``). The images are seeded RGB frames of the
mix's ``frame_sizes`` (W, H), the same multiset every seed, handed over
as PIL images (the cell skips HTTP and decoding); the queries are
``min_words``-``max_words`` words (Pareto ``alpha``; the window's
requests hold the same multiset of word counts every seed). The configuration
names the captioner (``captioner``); its family
(``captioners/<model_type>.py``) builds it and records what it produced.
A request is whole when it returned ``limit`` results and its captioner
produced tokens (the route swallows a captioner's failure and searches
the bare query).

After the window, ``check_requests`` requests drawn from the seed are
held to the references, stage by stage:

- the captioner: the family's numbers (Moondream: ``cap_prefill_gap``,
  ``cap_decode_gap``, ``cap_greedy_gap_max``) against its fp32 reference,
  from the same image;
- the enhanced text: the query and the caption the reference decodes from
  the program's tokens, joined by the route's rule, against the text the
  tower embedded (``enhanced_text_mismatch``, exact);
- the combined query: the embedding the store was given against the fp32
  image and text towers' blend of the same image and the embedded text
  (``emb_gap_max``, the largest distance; ``emb_bias``, the norm of the
  mean difference);
- the store: as in the search driver, from the served query on.

``--control 1`` runs the program with its own paths one precision step
below bf16 switched on: the captioner family's (Moondream: int8 weights,
the W8A8 prefill, the int8 KV cache) and the image tower's W8A8 (the text
tower has none); it has to come out not correct.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..lib import cell, data, openloop, program
from .search import _row_ids, store_gaps

TEXT_BUDGET_TOKENS = 248  # the route's enhance_query_with_caption: max_tokens
CHARS_PER_TOKEN = 4  # and chars_per_token


def enhanced(query: str, caption: str) -> str:
    """The route's caption-enhanced query (a frozen copy of its rule): as
    much of the caption as the text tower's budget holds, cut at a word
    boundary, after the query and a full stop."""
    budget = TEXT_BUDGET_TOKENS * CHARS_PER_TOKEN - len(query) - 2
    if budget <= 0 or not caption:
        return query
    if len(caption) > budget:
        cut = caption[:budget]
        caption = cut.rsplit(" ", 1)[0] if " " in cut else cut
    return f"{query}. {caption}" if query else caption


def run(ctx: cell.Context) -> cell.Context:
    from PIL import Image

    cfg, mix, dev, seed = ctx.cfg, ctx.mix, ctx.device, ctx.seed
    if "captioner" not in cfg:
        raise ValueError(f"mix {mix['name']!r} needs a configuration that names a captioner")
    fam = program.family(cfg["captioner"], ctx.bench_dir)
    due = data.arrivals(ctx.rate, ctx.seconds, seed)
    n_req, limit, w_img = len(due), mix["limit"], mix["weight_image"]
    sizes, n_warm = mix["frame_sizes"], mix["warm_requests"]
    lo, hi, alpha = mix["min_words"], mix["max_words"], mix["alpha"]
    queries = data.make_text_stream(n_req, lo, hi, alpha, seed)
    warm_queries = data.make_text_stream(n_warm, lo, hi, alpha, seed, "warm-texts")
    frames = data.make_frames(sizes, n_req, seed, dev)
    warm_frames = data.make_frames(sizes, n_warm, seed, dev, tag="warm-frames")
    images = [Image.fromarray(f) for f in frames]
    crng = np.random.default_rng(data.sub_seed(seed, "check"))
    check = sorted(crng.choice(n_req, size=min(mix["check_requests"], n_req), replace=False).tolist())
    enhance, multimodal = program.caption_search_entries()

    ctx.mark("imports")
    weights = data.make_weights(cfg, seed, dev, program.served_dtype(cfg))
    # the control: the program's own paths one precision step lower, the image tower's W8A8 and the captioner's
    emb = program.embedder(dict(cfg, quant="int8") if ctx.control else cfg, weights, dev)
    del weights
    ctx.mark("embedder")
    cap = program.captioner(cfg, seed, dev, ctx.bench_dir, control=ctx.control)
    ctx.mark("captioner")
    n_rows = mix["store_rows"]
    rows = data.make_rows(n_rows, cfg["projection_dim"], seed, dev).cpu().numpy()
    ids = _row_ids(n_rows)
    metas = data.app_metadata(ids)
    ctx.mark("rows")
    st = program.store(cfg, dev)
    st.add(ids=ids, embeddings=rows, metadatas=metas)
    del rows, ids, metas
    ctx.mark("store_add")
    st.warm(n_results_list=(limit,), q_counts=(1,))
    ctx.mark("store_warm")
    state = program.State(emb, st, cap)

    # what the timed path produced, a record a request: the captioner's
    # (through its family), the text the tower embedded, the query the
    # store was given (checked requests only)
    tls = threading.local()
    check_set = set(check)
    items = {i: {} for i in range(n_req)}

    def sink(key, value):
        idx = getattr(tls, "idx", None)
        if idx is None:
            return
        if key == "logits":  # heavy: the checked requests' alone
            if idx in check_set:
                items[idx].setdefault(key, []).append(value)
        else:
            items[idx][key] = value

    undo = fam.record(cap, sink)
    served_text, served_query = emb.embed_text_device, st.query

    def recording_text(text):
        sink("text", text)
        return served_text(text)

    def recording_query(query_embeddings, *a, **kw):
        if getattr(tls, "idx", None) in check_set:
            sink("query", query_embeddings)
        return served_query(query_embeddings, *a, **kw)

    emb.embed_text_device, st.query = recording_text, recording_query

    def request(image, query):
        return multimodal(state, image, enhance(state, image, query), weight_image=w_img, limit=limit)

    warm = [(Image.fromarray(f), q) for f, q in zip(warm_frames, warm_queries)]
    for image, query in warm[: len(sizes)]:
        request(image, query)
    burst = [threading.Thread(target=request, args=wq) for wq in warm[len(sizes):]]
    for t in burst:
        t.start()
    for t in burst:
        t.join()
    cell.sync(dev)
    ctx.mark("warm_requests")

    results = {}

    def handle(item):
        tls.idx = item
        res = request(images[item], queries[item])
        if item in check_set:
            results[item] = [(m["id"], m["similarity_score"]) for m in res]
        return len(res) == min(limit, n_rows) and "generated" in items[item]

    hung = openloop.serve(ctx, due, handle, "bench.caption_search.request", mix["workers"], program.metrics())
    ctx.store_rows = st.count()
    undo()
    del emb.embed_text_device, st.query, served_text, served_query
    n_prompt = len(fam.prompt_ids(cfg["captioner"], fam.tokenizer(cfg["captioner"])))
    ctx.texts = [[it.get("text", "")] for it in (items[i] for i in range(n_req))]
    ctx.captions = {i: {"prompt": n_prompt, "generated": int(it["generated"][1])}
                    for i, it in items.items() if "generated" in it}
    checked = {}
    for i in check:
        it = items[i]
        got = {"frame": frames[i], "text": it.get("text")}
        if "logits" in it and "generated" in it:
            toks, n = it["generated"]
            got.update(logits=torch.stack(it["logits"]).float().cpu(), tokens=toks[: int(n)].tolist())
        if "query" in it:
            got["query"] = it["query"].float().reshape(1, -1).cpu()
        checked[i] = got
    del st, emb, cap, state, items, undo
    cell.free_device(dev)
    if hung:
        ctx.notes["hung_workers"] = 1.0
    _check(ctx, fam, queries, checked, results)
    return ctx


def _check(ctx, fam, queries, checked, results):
    """The stages of each checked request against the references (see the
    module docstring)."""
    from ..reference import clip as ref_clip
    from ..reference import resize
    from ..reference import tokenizer as ref_tok

    cfg, dev, limit, w = ctx.cfg, ctx.device, ctx.mix["limit"], ctx.mix["weight_image"]
    whole = {i: c for i, c in checked.items() if "tokens" in c}
    cap_nums, captions, printed = fam.check(cfg["captioner"], ctx.seed, dev, whole)
    ctx.notes.update(printed)

    ref_clip.no_tf32()
    tree = ref_clip.fp32_tree(data.make_weights(cfg, ctx.seed, dev, program.served_dtype(cfg)))
    rows = data.make_rows(ctx.mix["store_rows"], cfg["projection_dim"], ctx.seed, dev)
    t = cfg["text_config"]
    size = cfg["vision_config"]["image_size"]
    mismatch, missing, diffs, gaps = 0, 0, [], []
    store_rank, store_score, e2e_rank, e2e_score = 0.0, 0.0, 0.0, 0.0
    for i, c in checked.items():
        if i not in captions or c["text"] is None or i not in results or "query" not in c:
            missing += 1
            continue
        mismatch += int(c["text"] != enhanced(queries[i], captions[i]))
        pixels = resize.clip_pixels(c["frame"], size, dev)[None]
        ids = torch.from_numpy(ref_tok.encode_batch([c["text"]], t["max_position_embeddings"])).to(dev)
        ref = w * ref_clip.encode_image(tree, cfg, pixels) + (1.0 - w) * ref_clip.encode_text(tree, cfg, ids, ref_tok.EOS)
        ref = ref / torch.linalg.vector_norm(ref, dim=1, keepdim=True)
        served, res = c["query"].to(dev), results[i]
        d = served.double() - ref.double()
        diffs.append(d)
        gaps.append(float(torch.linalg.vector_norm(d)))
        if len(res) < limit:
            missing += 1
            continue
        (rank, score), (rank2, score2) = (store_gaps(rows, q, res, limit) for q in (served, ref))
        store_rank, store_score = max(store_rank, rank), max(store_score, score)
        e2e_rank, e2e_score = max(e2e_rank, rank2), max(e2e_score, score2)
    bias = float(torch.linalg.vector_norm(torch.cat(diffs).mean(0))) if diffs else 0.0
    if gaps:
        ctx.notes["emb_gap_median"] = float(np.median(gaps))
    ctx.notes["e2e_rank_gap"], ctx.notes["e2e_score_gap"] = e2e_rank, e2e_score
    del tree, rows
    cell.free_device(dev)
    lim = cfg["limits"]["caption_search"]
    ctx.checks = {name: (value, lim[name]) for name, value in cap_nums.items()}
    ctx.checks.update({
        "enhanced_text_mismatch": (float(mismatch), lim["enhanced_text_mismatch"]),
        "emb_gap_max": (max(gaps) if gaps else 0.0, lim["emb_gap_max"]),
        "emb_bias": (bias, lim["emb_bias"]),
        "store_rank_gap": (store_rank, lim["store_rank_gap"]),
        "store_score_gap": (store_score, lim["store_score_gap"]),
        "results_missing": (float(missing), lim["results_missing"]),
    })
