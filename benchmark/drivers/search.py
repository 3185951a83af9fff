"""The open-loop batched text-search driver.

Requests arrive on a fixed schedule at the mix's ``rate`` (a Poisson
process's gaps, the same set every seed in a seeded order) whatever the
system's state, and ``workers`` threads (the server's IMATCH_WORKERS)
serve them (``lib/openloop.py``) through
``pipeline.search.search_by_text_batch(state, texts, limit)``, the
/api/search/batch route's call, against a store of ``store_rows`` unit
rows made from the seed. Each request is ``per_request`` distinct texts
whose word counts are the same multiset in every request (a Pareto tail
of index ``alpha`` from ``min_words``, cut at ``max_words``), cut by the
tokenizer at the text tower's context. A request's latency runs from its
due time to its results in the caller's hands; one that fails, or has
not answered a minute after the window, counts as failed.

After the window, ``check_requests`` requests drawn from the seed are
held to the references: the query embeddings the timed path computed
against the fp32 text tower, and the top ``limit`` ids and similarity
scores against a brute force over the rows.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..lib import cell, data, openloop, program


def _row_ids(n: int):
    return [f"img_{i:016x}" for i in range(n)]


def run(ctx: cell.Context) -> cell.Context:
    cfg, mix, dev, seed = ctx.cfg, ctx.mix, ctx.device, ctx.seed
    due = data.arrivals(ctx.rate, ctx.seconds, seed)
    n_req, q_per, limit = len(due), mix["per_request"], mix["limit"]
    texts = data.make_texts(n_req + mix["warm_requests"], q_per, mix["min_words"], mix["max_words"], mix["alpha"], seed)
    warm_texts, texts = texts[n_req:], texts[:n_req]
    crng = np.random.default_rng(data.sub_seed(seed, "check"))
    check = sorted(crng.choice(n_req, size=min(mix["check_requests"], n_req), replace=False).tolist())
    if ctx.control:
        return _control(ctx, texts, check)
    search_by_text_batch = program.search_entry()

    ctx.mark("imports")
    weights = data.make_weights(cfg, seed, dev, program.served_dtype(cfg))
    emb = program.embedder(cfg, weights, dev)
    del weights
    ctx.mark("embedder")
    n_rows = mix["store_rows"]
    rows = data.make_rows(n_rows, cfg["projection_dim"], seed, dev).cpu().numpy()
    ids = _row_ids(n_rows)
    metas = data.app_metadata(ids)
    ctx.mark("rows")
    st = program.store(cfg, dev)
    st.add(ids=ids, embeddings=rows, metadatas=metas)
    del rows, ids, metas
    ctx.mark("store_add")
    st.warm(n_results_list=(limit,), q_counts=(q_per,))
    ctx.mark("store_warm")
    state = program.State(emb, st)

    # capture the query embeddings the timed path computes, for the
    # requests drawn for the check
    tls = threading.local()
    captured = {}
    served_embed = emb.embed_texts_device

    def recording_embed(t):
        out = served_embed(t)
        idx = getattr(tls, "idx", None)
        if idx is not None:
            captured[idx] = out
        return out

    emb.embed_texts_device = recording_embed

    for w in warm_texts[:2]:
        search_by_text_batch(state, w, limit=limit)
    burst = [threading.Thread(target=search_by_text_batch, args=(state, w), kwargs={"limit": limit}) for w in warm_texts[2:]]
    for t in burst:
        t.start()
    for t in burst:
        t.join()
    cell.sync(dev)
    ctx.mark("warm_requests")

    results = {}
    check_set = set(check)

    def handle(item):
        tls.idx = item if item in check_set else None
        res = search_by_text_batch(state, texts[item], limit=limit)
        if item in check_set:
            results[item] = [[(m["id"], m["similarity_score"]) for m in r] for r in res]
        return len(res) == q_per and all(len(r) == min(limit, n_rows) for r in res)

    hung = openloop.serve(ctx, due, handle, "bench.search.request", mix["workers"], program.metrics())
    ctx.texts = texts
    ctx.store_rows = st.count()
    emb_p = {i: captured[i].float().cpu().numpy() for i in check if i in captured}
    emb.embed_texts_device = served_embed
    del st, emb, state, captured
    cell.free_device(dev)
    if hung:
        ctx.notes["hung_workers"] = 1.0
    _check(ctx, texts, check, emb_p, results)
    return ctx


def _reference(ctx, texts, check, int8: bool):
    from ..reference import clip as ref_clip
    from ..reference import tokenizer as ref_tok

    cfg, dev = ctx.cfg, ctx.device
    ref_clip.no_tf32()
    tree = ref_clip.fp32_tree(data.make_weights(cfg, ctx.seed, dev, program.served_dtype(cfg)))
    t = cfg["text_config"]
    out = {}
    for i in check:
        ids = torch.from_numpy(ref_tok.encode_batch(texts[i], t["max_position_embeddings"])).to(dev)
        parts = [ref_clip.encode_text(tree, cfg, ids[s : s + 32], ref_tok.EOS, int8=int8) for s in range(0, ids.shape[0], 32)]
        out[i] = torch.cat(parts)
    return out


def store_gaps(rows, query, res, limit):
    """One served result row ``res`` ([(id, similarity)], the top
    ``limit``) against a brute force over ``rows`` for the (1, D)
    ``query``: the largest amount by which a served result's score lies
    below the brute force's at its rank, and the largest gap of a served
    similarity from the brute force's for the same row."""
    from ..reference import topk as ref_topk

    idx = torch.tensor([int(r[0][4:], 16) for r in res], device=rows.device)
    sims = torch.tensor([float(r[1]) for r in res], device=rows.device, dtype=torch.float64)
    best, _ = ref_topk.topk(rows, query, limit)
    got = ref_topk.scores_of(rows, query, idx[None])[0]
    rank = float((best[0] - torch.sort(got, descending=True).values).max())
    score = float((sims - (1.0 + got.double()) / 2.0).abs().max())
    return rank, score


def _check(ctx, texts, check, emb_p, results):
    """For each request drawn, two stages, each against the references.

    The tokenizer and text tower: the served query embeddings against the
    fp32 reference's, by two numbers. ``emb_gap_max``, the largest
    distance of one served query from its reference, sees a single wrong
    slot and any order of the batch that is not the texts' (a permuted
    slot lies as far off as two texts' embeddings). ``emb_bias``, the norm
    of the mean difference over every query checked, sees a lower
    precision: bf16 rounding moves each query by about 0.01 in a direction
    of its own, which averages out; lower-precision weights move them all
    alike.

    The store and engine, from the served queries on (the stage follows
    the program's own query embeddings, checked above): the top
    ``limit`` rows against a brute force over the seed's rows in fp32,
    as the largest amount by which a served result's score lies below
    the brute force's at its rank (``store_rank_gap``), and each served
    similarity against the brute force's for the same row
    (``store_score_gap``). The exact engine promises the fp32 top k, so
    both limits are the fp32 rounding of a score.

    Also printed: the same gaps of the results against the reference's
    own queries (what the user sees end to end)."""
    dev, limit = ctx.device, ctx.mix["limit"]
    ref = _reference(ctx, texts, check, int8=False)
    rows = data.make_rows(ctx.mix["store_rows"], ctx.cfg["projection_dim"], ctx.seed, dev)
    diffs, gaps = [], []
    store_rank, store_score, e2e_rank, e2e_score, missing = 0.0, 0.0, 0.0, 0.0, 0
    for i in check:
        if i not in results or i not in emb_p:
            missing += len(texts[i])
            continue
        served = torch.from_numpy(emb_p[i]).to(dev).float()
        d = served.double() - ref[i].double()
        diffs.append(d)
        gaps += torch.linalg.vector_norm(d, dim=1).tolist()
        for q, res in enumerate(results[i]):
            if len(res) < limit:
                missing += 1
                continue
            (rank, score), (rank2, score2) = (store_gaps(rows, query, res, limit)
                                              for query in (served[q : q + 1], ref[i][q : q + 1]))
            store_rank, store_score = max(store_rank, rank), max(store_score, score)
            e2e_rank, e2e_score = max(e2e_rank, rank2), max(e2e_score, score2)
    bias = float(torch.linalg.vector_norm(torch.cat(diffs).mean(0))) if diffs else 0.0
    if gaps:
        ctx.notes["emb_gap_median"] = float(np.median(gaps))
    ctx.notes["e2e_rank_gap"], ctx.notes["e2e_score_gap"] = e2e_rank, e2e_score
    lim = ctx.cfg["limits"]["search"]
    ctx.checks = {
        "emb_gap_max": (max(gaps) if gaps else 0.0, lim["emb_gap_max"]),
        "emb_bias": (bias, lim["emb_bias"]),
        "store_rank_gap": (store_rank, lim["store_rank_gap"]),
        "store_score_gap": (store_score, lim["store_score_gap"]),
        "results_missing": (float(missing), lim["results_missing"]),
    }


def _control(ctx, texts, check):
    """The control: the reference text tower in W8A8 int8 put in the
    program's place, its queries ranked by the brute force (what the
    exact engine returns for them), held to the same numbers."""
    dev, limit = ctx.device, ctx.mix["limit"]
    from ..reference import topk as ref_topk

    emb_c = _reference(ctx, texts, check, int8=True)
    rows = data.make_rows(ctx.mix["store_rows"], ctx.cfg["projection_dim"], ctx.seed, dev)
    results = {}
    for i in check:
        s, idx = ref_topk.topk(rows, emb_c[i], limit)
        results[i] = [
            [(f"img_{int(j):016x}", (1.0 + float(v)) / 2.0) for v, j in zip(sr.tolist(), ir.tolist())]
            for sr, ir in zip(s, idx)
        ]
    emb_p = {i: e.cpu().numpy() for i, e in emb_c.items()}
    del rows
    cell.free_device(dev)
    ctx.setup_s = ctx.window_s = 0.0
    ctx.attempted = len(check)
    _check(ctx, texts, check, emb_p, results)
    return ctx
