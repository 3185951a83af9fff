"""Phase 2 of the tilemax engine on the card: the batched ``bmm`` rescore
of ``index/search.py`` against a per-query form, and the engine at the
real query count against the count padded to a power of two:

    python -m imatch_tpu_torch.scripts.rescore_ab [--rows 1048576] [--iters 5]

The state is the store's bf16 tilemax engine: ``rows`` seeded unit rows of
width 768, 512-row tiles, margin 4. Queries are seeded unit rows.

- At Q = 16 and 256 and k = 16 (the limit 10 select): whether the batched
  form gives each query, bit for bit, the scores and ids it gives that
  query alone (a batch of one), whether a per-query form (one ``mv`` a
  query) equals it, and the host ms of each form for the whole batch
  (each call ends in a synchronize; the per-query form is launch-bound).
- At Q = 129 and k = 1024 (limit 0): ``tilemax_topk`` at the 129 rows
  against 256 rows whose last 127 are zero (JAX's padding to a power of
  two), in the order real, padded, padded, real; the first 129 rows of
  the two must agree.

Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from imatch_tpu_torch.index.search import (
    FINAL_MARGIN,
    DeviceCorpus,
    NEG_INF,
    _rescore,
    final_topk,
    _top_tiles,
    prepare_device_corpus,
    tilemax_topk,
)
from imatch_tpu_torch.ops.kernels import _build
from imatch_tpu_torch.ops.kernels.topk import tile_max
from imatch_tpu_torch.scripts._common import card, unit_rows

SEED = 0
DIM = 768
TILE_N = 512


def rescore_per_query(q32, tmax, dc: DeviceCorpus, k: int):
    """Phase 2 one query at a time: the batched form's steps (candidate
    tiles in index order, a stable sort, -1 / NEG_INF past the valid
    rows, the survivors' ``final_topk``) with one ``torch.mv`` a query."""
    nq, n_tiles = tmax.shape
    d = dc.exact.shape[1]
    kt = min(k + dc.margin, n_tiles)
    tiles = torch.sort(_top_tiles(tmax, kt), dim=1).values
    rows_t = dc.exact.view(n_tiles, dc.tile_n, d)
    valid_t = dc.valid.view(n_tiles, dc.tile_n)
    col = torch.arange(dc.tile_n, device=tmax.device)
    keep = min(k + FINAL_MARGIN, kt * dc.tile_n)
    out_s, out_i = [], []
    for qi in range(nq):
        t = tiles[qi]
        s = torch.mv(rows_t[t].reshape(kt * dc.tile_n, d), q32[qi])
        s = torch.where(valid_t[t].reshape(-1), s, NEG_INF)
        s, pos = torch.sort(s, descending=True, stable=True)
        gidx = (t[:, None] * dc.tile_n + col).reshape(-1)
        cand = torch.where(s[:keep] <= NEG_INF / 2, -1, gidx[pos[:keep]])
        scores, idx = final_topk(cand[None], q32[qi : qi + 1], dc.exact, k)
        out_s.append(scores)
        out_i.append(idx)
    return torch.cat(out_s), torch.cat(out_i)


def host_ms(fn, iters: int) -> float:
    """Mean host-clock ms of a call that ends in a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _tile_maxima(q32, dc):
    qs = torch.zeros((q32.shape[0], dc.scoring.shape[1]), dtype=dc.scoring.dtype, device=q32.device)
    qs[:, : q32.shape[1]] = q32
    return tile_max(qs, dc.scoring, dc.valid, dc.tile_n)


def _same(a, b) -> dict:
    """Rows whose scores differ in any bit or whose ids differ, and the
    largest score difference."""
    (sa, ia), (sb, ib) = a, b
    rows = (sa != sb).any(1) | (ia != ib).any(1)
    return {"rows_differing": int(rows.sum()), "max_score_diff": float((sa - sb).abs().max())}


def batch_forms(dc, queries, k: int, iters: int) -> dict:
    q32 = queries.float()
    tmax = _tile_maxima(q32, dc)
    batched = _rescore(q32, tmax, dc, k)
    alone = [_rescore(q32[i : i + 1], tmax[i : i + 1], dc, k) for i in range(q32.shape[0])]
    alone = (torch.cat([a[0] for a in alone]), torch.cat([a[1] for a in alone]))
    per_query = rescore_per_query(q32, tmax, dc, k)
    return {
        "q": q32.shape[0],
        "k": k,
        "bmm_batch_vs_alone": _same(batched, alone),
        "per_query_vs_bmm_batch": _same(per_query, batched),
        "per_query_vs_bmm_alone": _same(per_query, alone),
        "per_query_ms": host_ms(lambda: rescore_per_query(q32, tmax, dc, k), iters),
        "bmm_ms": host_ms(lambda: _rescore(q32, tmax, dc, k), iters),
    }


def padding(dc, queries, k: int, iters: int) -> dict:
    real = queries.float()
    padded = torch.nn.functional.pad(real, (0, 0, 0, 256 - real.shape[0]))
    a = tilemax_topk(real, dc, k=k)
    b = tilemax_topk(padded, dc, k=k)
    same = _same(a, (b[0][: real.shape[0]], b[1][: real.shape[0]]))
    ms = {"real": [], "padded": []}
    for name, q in (("real", real), ("padded", padded), ("padded", padded), ("real", real)):
        ms[name].append(host_ms(lambda: tilemax_topk(q, dc, k=k), iters))
    return {"q": real.shape[0], "k": k, "padded_to": 256, "real_vs_padded": same, "ms": ms}


def main(rows: int = 1 << 20, iters: int = 5) -> dict:
    dev = torch.device("cuda")
    _build.build()
    g = torch.Generator(device=dev).manual_seed(SEED)
    corpus = unit_rows(g, (rows, DIM), dev)
    valid = torch.ones((rows,), dtype=torch.bool, device=dev)
    dc = prepare_device_corpus(corpus, valid, tile_n=TILE_N, device=dev)
    del corpus
    queries = unit_rows(g, (256, DIM), dev)
    out = {"card": card(dev), "rows": rows, "dim": DIM, "tile_n": TILE_N, "margin": dc.margin}
    out["forms"] = [batch_forms(dc, queries[:nq], 16, iters) for nq in (16, 256)]
    out["padding"] = padding(dc, queries[:129], 1024, max(1, iters // 2))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    main(args.rows, args.iters)
