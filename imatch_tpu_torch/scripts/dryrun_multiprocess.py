"""Multi-process dryrun: the grid's paths over processes.

Port of ``scripts/dryrun_multiprocess.py``. N worker processes each bring
their local shards, ``parallel/distributed.py`` joins them over
``torch.distributed`` (gloo), and ``make_mesh`` stitches their shards into
one grid that every process sees whole. Then, in every process, the
library call (``prepare_sharded_corpus`` + ``sharded_topk_prepared``) and
the unchanged serving store (``VectorStore(engine="sharded")`` given the
grid as its mesh) answer queries over it: each process runs K1 on its own
shards and all-gathers the candidates. Every process checks its answers
against a float64 numpy exact top-k (ids equal, scores within 1e-5),
deletes the top hit of query 0 and sees the runner-up come first, then
adds a copy of query 1's row and finds it beside the original.

The corpus is drawn from one seed on the same device type in every
process: the store's host state is replicated, the SPMD contract the
sharded engine relies on.

Beside ``sharded`` (the default), ``--paths`` (comma-separated, run in
this order in every process) drives the grid's other paths, each checked
in every process against what the same grid shape gives in one process
(process 0 computes that answer and hands it to all):

- ``ivf``: the store's ``ivf-sharded`` engine over procs x local-devices
  shards on ``--rows`` x ``--dim`` rows round ``--centres`` centres: at a
  full probe bit for bit the ``sharded`` store's, at IMATCH_IVF_NPROBE=8
  the one-process engine's; a sidecar each process saves reloads in one
  process and repairs; an add through the append patch and a delete;
- ``tp``: the CLIP towers of ``--config`` at ``--mp`` model shards, one
  shard a process, on ``--batch`` images and texts (K2 at (B, H / mp, S,
  Dh) held against its plain version; cosine and top-10 ids);
- ``embed``: the embedder's data axis, one shard a process, on
  ``--batch`` frames (the grid's shard count kept, a block a process);
- ``train``: ``--steps`` DP + TP steps at ``--train-batch`` on the
  (procs / mp, mp) grid (losses within rtol 1e-6), then a checkpoint
  saved there restored in one process at mp = 1; ``--train-layers V,T``
  cuts the config's image and text towers to V and T layers (full
  width);
- ``ring``: causal ring attention at ``--ring`` B,H,S,Dh over the data
  axis (procs x local-devices positions), output and gradient;
- ``gpipe``: the config's image-tower layers through ``gpipe_scan``, one
  stage a process, at ``--pipe-batch`` rows and ``--microbatches``.

With ``--write`` the workers leave their results under ``--out`` as
``.npz`` and ``.json`` files (a caller compares them with the JAX
package). ``--init-npz`` starts ``train`` from a JAX-layout param tree
saved flat (keys ``vision/layers/attn/wq`` ...) instead of ``--seed``.
``--reference caller`` leaves ``train``'s loss check to the caller, which
computes the one-process grid's steps while the workers run (chip_smoke's
phase 8i); process 0 still restores the checkpoint and checks it.

Usage:
    python -m imatch_tpu_torch.scripts.dryrun_multiprocess --device cpu      # 2 procs x 4 cpu shards
    python -m imatch_tpu_torch.scripts.dryrun_multiprocess --device cpu --local-devices 2 \
        --paths sharded,ivf,tp,embed,ring,gpipe                               # every path but train
    python -m imatch_tpu_torch.scripts.dryrun_multiprocess --device cpu --procs 4 --paths train
    python -m imatch_tpu_torch.scripts.dryrun_multiprocess --procs 2 --local-devices 2 \\
        --rows 262144 --dim 768 --queries 16                                  # on the card

``--device cuda`` (the default) puts process p's shards on card
p mod (visible cards): on a one-card machine every process shares
``cuda:0``, as logical shards. The launcher picks a free port for the
coordinator, and exits 0 and prints ``MULTIPROCESS DRYRUN OK`` only when
every worker did; a worker that fails or outlives ``--timeout`` makes it
exit non-zero (the others are then stopped). Each worker prints one
``[proc i] {json}`` line: its K1 launches, the search's ms for one query
and the all-gather's ms within it (on the card), and a key for each
other path with its checks, launches and (on the card) times.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import socket
import subprocess
import sys
import tempfile
import time

T0 = time.perf_counter()  # a worker's start, for its stage times
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _local_device(name: str, worker: int):
    import torch

    from imatch_tpu_torch.device import resolve_device

    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", worker % torch.cuda.device_count())
    return dev


def _host_ms(fn, device, iters: int = 10, warm: bool = True) -> float:
    """Mean host-clock ms of one call, after a warm call (``warm=False``:
    the caller's last call warmed it); every process runs the same loop
    (its collectives pair up)."""
    import torch

    if warm:
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3 / iters


def worker(args) -> int:
    import torch

    from imatch_tpu_torch.parallel import distributed

    me = args.worker
    dev = _local_device(args.device, me)
    torch.zeros(1, device=dev)  # the card's context, timed apart
    seconds = {"card": time.perf_counter() - T0}
    distributed.initialize(args.coordinator, args.procs, me, timeout=args.timeout)
    seconds["group"] = time.perf_counter() - T0
    paths = args.paths.split(",")
    unknown = set(paths) - set(PATHS) - {"sharded"}
    if unknown:
        raise ValueError(f"unknown paths {sorted(unknown)}: sharded or {', '.join(PATHS)}")
    row = {}
    try:
        if "sharded" in paths:
            row = _sharded_path(args, dev, me, seconds)
        for name in paths:
            if name != "sharded":
                row[name] = PATHS[name](args, dev, me, args.out)
                print(f"[proc {me}] {name} over the {args.procs}-process grid: checked", flush=True)
                seconds[name] = time.perf_counter() - T0
        row["seconds_since_start"] = seconds  # at the end of each stage
        row["peak_host_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        print(f"[proc {me}] " + json.dumps(row), flush=True)
    finally:
        distributed.shutdown()
    return 0


def _sharded_path(args, dev, me, seconds) -> dict:
    """The library call and the ``sharded`` store over procs x
    local-devices shards, exact against float64 numpy."""
    import numpy as np
    import torch

    from imatch_tpu_torch.index.store import VectorStore
    from imatch_tpu_torch.ops.kernels.topk import tile_max
    from imatch_tpu_torch.parallel import distributed
    from imatch_tpu_torch.parallel.dist_search import prepare_sharded_corpus, sharded_topk_prepared
    from imatch_tpu_torch.parallel.mesh import make_mesh

    grid = make_mesh(devices=[dev] * args.local_devices)
    n_global = args.procs * args.local_devices
    if len(grid) != n_global or distributed.process_count() != args.procs:
        raise RuntimeError(f"expected {n_global} shards over {args.procs} processes, got {grid!r}")
    mine = [s for s in range(len(grid)) if grid.is_local(s)]
    if mine != list(range(me * args.local_devices, (me + 1) * args.local_devices)):
        raise RuntimeError(f"proc {me} owns shards {mine}")

    # the same corpus in every process (one seed, one device type):
    # replicated host state; drawn on the device, where it is fast
    g = torch.Generator(device=dev).manual_seed(7)
    n, d, k = args.rows, args.dim, args.k
    rows = torch.randn((n, d), generator=g, device=dev)
    corpus = (rows / rows.norm(dim=1, keepdim=True)).cpu().numpy()
    del rows
    queries = corpus[torch.randint(0, n, (args.queries,), generator=g, device=dev).cpu().numpy()]
    ref = queries.astype(np.float64) @ corpus.astype(np.float64).T
    want = [np.argsort(-ref[qi], kind="stable")[:k] for qi in range(len(queries))]
    seconds["data"] = time.perf_counter() - T0

    # ---- library layer: the prepared sharded corpus over the grid
    k1 = (tile_max.launches, tile_max.mma_launches)
    sc = prepare_sharded_corpus(corpus, np.ones(n, bool), mesh=grid, score_dtype=torch.float32)
    q = torch.from_numpy(queries).to(dev)
    s, i = (t.cpu().numpy() for t in sharded_topk_prepared(q, sc, k=k))
    for qi in range(len(queries)):
        if i[qi].tolist() != want[qi].tolist():
            raise AssertionError(f"proc {me} query {qi}: {i[qi]} != {want[qi]}")
        np.testing.assert_allclose(s[qi], ref[qi][want[qi]], atol=1e-5)
    print(f"[proc {me}] library sharded_topk exact over the {args.procs}-process grid", flush=True)
    seconds["library"] = time.perf_counter() - T0

    # ---- serving layer: the store, engine=sharded, on the same grid
    store = VectorStore(dim=d, engine="sharded", score_dtype="fp32", device=dev, mesh=grid)
    ids = [f"r{j:07d}" for j in range(n)]
    store.add(ids=ids, embeddings=corpus)
    res = store.query(queries, n_results=k)
    for qi in range(len(queries)):
        if res["ids"][qi] != [ids[w] for w in want[qi]]:
            raise AssertionError(f"proc {me} store query {qi} mismatch")
    top0 = res["ids"][0][0]
    store.delete([top0])
    res2 = store.query(queries[:1], n_results=k)
    if top0 in res2["ids"][0] or res2["ids"][0][0] != res["ids"][0][1]:
        raise AssertionError(f"proc {me}: delete of {top0} not seen: {res2['ids'][0]}")
    # an add after the build patches the owner's shard: a copy of query
    # 1's row ties with the original, which keeps the lower slot
    store.add(ids=["added"], embeddings=queries[1:2])
    res3 = store.query(queries[1:2], n_results=k)
    want3 = [w for w in (res["ids"][1][0], "added") if w != top0]
    if res3["ids"][0][: len(want3)] != want3:
        raise AssertionError(f"proc {me}: the added row not found: {res3['ids'][0]}")
    print(f"[proc {me}] VectorStore sharded engine + mutation exact over the process-spanning grid", flush=True)
    seconds["store"] = time.perf_counter() - T0
    row = {
        "shards": mine,
        "k1_launches": tile_max.launches - k1[0],
        "k1_mma_launches": tile_max.mma_launches - k1[1],
        "rows": n,
        "dim": d,
        "queries": len(queries),
        "k": k,
        "device": str(dev),
    }
    if dev.type == "cuda":
        row["timing_started_at"] = time.time()  # wall clock: a caller can tell what overlapped it
        q1 = q[:1]
        cand = (torch.zeros((1, k * len(mine)), device=dev), torch.zeros((1, k * len(mine)), dtype=torch.int64, device=dev))
        row["query_ms"] = _host_ms(lambda: sharded_topk_prepared(q1, sc, k=k)[1].cpu(), dev)
        row["gather_ms"] = _host_ms(lambda: [distributed.all_gather(t) for t in cand], dev)
        row["gather_share"] = row["gather_ms"] / row["query_ms"]
    return row


# -- the grid's other paths (--paths) ------------------------------------------


def _shared(me: int, fn):
    """``fn()`` computed in process 0 (host values) and handed to every
    process: the one-process answer each process checks its own against."""
    import torch.distributed as dist

    box = [fn() if me == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(a.detach().cpu(), b.detach().cpu())


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


class _K2Watch:
    """K2's launches in a window (``flash_mha.launches``) and the first
    launch's inputs at each shape, captured from the path, to hold against
    the plain version afterwards."""

    def __enter__(self):
        from imatch_tpu_torch.ops import attention
        from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha

        self.served, self.captured, self.before = attention.flash_mha, {}, flash_mha.launches

        def watch(q, k, v, **kw):
            if q.is_cuda:
                self.captured.setdefault(tuple(q.shape), (q.clone(), k.clone(), v.clone(), kw))
            return self.served(q, k, v, **kw)

        attention.flash_mha = watch
        return self

    def __exit__(self, *exc):
        from imatch_tpu_torch.ops import attention
        from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha

        attention.flash_mha = self.served
        self.launches = flash_mha.launches - self.before

    def held(self) -> dict:
        """Each captured shape: K2 against ``flash_mha_plain`` in fp32 on
        the same inputs, within 2 bf16 ulps at magnitude 1 plus half an ulp
        relative."""
        from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha, flash_mha_plain

        out = {}
        for shape, (q, k, v, kw) in self.captured.items():
            got = flash_mha(q, k, v, **kw).float()
            ref = flash_mha_plain(q.float(), k.float(), v.float(), **kw)
            err = (got - ref).abs()
            out["x".join(map(str, shape))] = {
                "max_abs_err": float(err.max()),
                "ok": bool((err <= 2 * 2.0**-7 + 2.0**-8 * ref.abs()).all()),
            }
        return out


def _dtype(args, dev):
    import torch

    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def clip_batch(cfg, b: int, seed: int):
    """(pixels (b, H, W, 3) fp32, eos-padded tokens (b, S) int32) from a
    numpy seed, the same in every process."""
    import numpy as np

    rng = np.random.default_rng(seed)
    size, s = cfg.vision.image_size, cfg.text.max_positions
    px = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    tok = rng.integers(0, cfg.text.eos_token_id, (b, s)).astype(np.int32)
    for i, n in enumerate(rng.integers(3, s, b)):
        tok[i, n:] = cfg.text.eos_token_id
    return px, tok


def _top10(emb, corpus):
    import torch

    return torch.topk(emb.float() @ corpus.T, 10, dim=1).indices


def ivf_path(args, dev, me, out) -> dict:
    """The store's ``ivf-sharded`` engine over procs x local-devices
    shards: at a full probe equal to ``sharded`` bit for bit; at
    IMATCH_IVF_NPROBE=8 equal to the one-process engine over as many
    shards; a sidecar any process saves reloads (and repairs) in one
    process; then an add through the append patch and a delete."""
    import numpy as np
    import torch

    from imatch_tpu_torch.index.store import VectorStore
    from imatch_tpu_torch.parallel import distributed
    from imatch_tpu_torch.parallel.dist_ivf import prepare_sharded_ivf, sharded_ivf_topk
    from imatch_tpu_torch.parallel.mesh import Grid, make_mesh

    grid = make_mesh(devices=[dev] * args.local_devices)
    p = len(grid)
    n, d, nq = args.rows, args.dim, args.queries
    g = torch.Generator(device=dev).manual_seed(args.seed + 11)
    c = torch.randn((args.centres, d), generator=g, device=dev)
    c /= c.norm(dim=1, keepdim=True)
    x = c[torch.randint(0, args.centres, (n,), generator=g, device=dev)]
    x = x + torch.randn((n, d), generator=g, device=dev) * (0.5 / d**0.5)
    corpus = (x / x.norm(dim=1, keepdim=True)).cpu().numpy()
    del c, x
    queries = corpus[:nq] * 0.95 + np.roll(corpus[:nq], 1, axis=0) * 0.05
    ids = [f"v{j:07d}" for j in range(n)]
    row = {"rows": n, "dim": d, "shards": p, "centres": args.centres}

    def store(engine, mesh):
        # 16 rows short of the capacity: the later add patches, no growth
        s = VectorStore(dim=d, engine=engine, device=dev, mesh=mesh)
        s.add(ids=ids[:-16], embeddings=corpus[:-16])
        return s

    def probe(s, depth, q=queries):
        os.environ["IMATCH_IVF_NPROBE"] = str(depth)
        try:
            return s.query(q, n_results=args.k)
        finally:
            os.environ.pop("IMATCH_IVF_NPROBE")

    ann, exact = store("ivf-sharded", grid), store("sharded", grid)
    full, want = probe(ann, 1 << 20), exact.query(queries, n_results=args.k)
    _check(full == want, f"proc {me}: ivf-sharded at a full probe != sharded")
    del exact
    got8 = probe(ann, 8)
    root = os.path.join(out, f"ivf_p{me}")
    ann.save(root)
    # the library call beside the store's, for a comparison with JAX
    lib = prepare_sharded_ivf(corpus, np.ones(n, bool), mesh=grid)
    ls, li = (t.cpu().numpy() for t in sharded_ivf_topk(torch.from_numpy(queries), lib, k=args.k, n_probe=8))
    del lib

    def one_process():
        local = Grid([dev] * p)
        ref = store("ivf-sharded", local)
        r8 = probe(ref, 8)
        # process 0's and the last process's sidecars, each loaded in one process
        loads = []
        os.environ["IMATCH_INDEX_ENGINE"] = "ivf-sharded"  # load takes its engine from here
        try:
            for q in (0, args.procs - 1):
                back = VectorStore.load(os.path.join(out, f"ivf_p{q}"), persist=False, device=dev, mesh=local)
                loads.append((probe(back, 8), back.stats()["ivf"]["last_mode"]))
        finally:
            os.environ.pop("IMATCH_INDEX_ENGINE")
        ref.delete([r8["ids"][0][0]])
        ref.add(ids=["added"], embeddings=queries[1:2])
        return r8, loads, probe(ref, 8)

    r8, loads, r8m = _shared(me, one_process)
    _check(got8 == r8, f"proc {me}: ivf-sharded at n_probe 8 != the one-process engine over {p} shards")
    for res, mode in loads:
        _check(res == r8 and mode == "repair", f"proc {me}: a saved sidecar did not reload and repair ({mode})")
    patched = ann.stats()["patched_mutations"]
    ann.delete([got8["ids"][0][0]])
    ann.add(ids=["added"], embeddings=queries[1:2])
    got8m = probe(ann, 8)
    _check(ann.stats()["patched_mutations"] - patched == 2, f"proc {me}: the add or delete rebuilt")
    _check(got8m == r8m, f"proc {me}: after an add and a delete, != the one-process engine")
    row.update(clusters=int(ann.stats()["ivf"]["clusters"]), sidecar_modes=[m for _, m in loads])
    if out and args.write:
        np.savez(
            os.path.join(out, f"ivf_arrays_p{me}.npz"),
            corpus=corpus, queries=queries, lib_scores=ls, lib_ids=li,
        )  # fmt: skip
        with open(os.path.join(out, f"ivf_results_p{me}.json"), "w") as f:
            json.dump({"full": full, "sharded": want, "probe8": got8, "probe8_one_process": r8, "mutated": got8m}, f)
    if dev.type == "cuda":
        k = args.k
        for nq_t in (1, 16):
            qt = queries[:nq_t]
            row[f"query_ms_q{nq_t}"] = _host_ms(lambda: probe(ann, 8, qt), dev)
            local = len(grid.local_shards())
            cand = (torch.zeros((nq_t, k * local), device=dev), torch.zeros((nq_t, k * local), dtype=torch.int64, device=dev))
            row[f"gather_ms_q{nq_t}"] = _host_ms(lambda: [distributed.all_gather(t) for t in cand], dev)
            row[f"gather_share_q{nq_t}"] = row[f"gather_ms_q{nq_t}"] / row[f"query_ms_q{nq_t}"]
    return row


def tp_path(args, dev, me, out) -> dict:
    """The CLIP towers at ``--mp`` model shards, one a process: every
    process returns the one-process grid's embeddings; K2 runs at (B,
    H / mp, S, Dh) in each, held against its plain version."""
    import numpy as np
    import torch

    from imatch_tpu_torch.models.clip.configs import get_config
    from imatch_tpu_torch.models.clip.model import encode_image, encode_text, init_random
    from imatch_tpu_torch.parallel.mesh import Grid, make_mesh
    from imatch_tpu_torch.parallel.sharding import shard_model

    cfg, dtype = get_config(args.config), _dtype(args, dev)
    grid = make_mesh(args.mp, [dev])

    def model(g):
        full = init_random(cfg, device=dev, dtype=dtype, generator=torch.Generator(device=dev).manual_seed(args.seed))
        return shard_model(full, g)

    px, tok = (torch.from_numpy(a).to(dev) for a in clip_batch(cfg, args.batch, args.seed + 1))
    m = model(grid)
    with _K2Watch() as k2:
        img, txt = encode_image(m, px), encode_text(m, tok)
    corpus = torch.nn.functional.normalize(
        torch.randn((4096, cfg.projection_dim), generator=torch.Generator(device=dev).manual_seed(3), device=dev), dim=1
    )
    row = {"config": cfg.name, "batch": args.batch, "grid": grid.shape, "k2_launches": k2.launches, "k2_held": k2.held()}

    def one_process():
        r = model(Grid([dev] * args.mp, args.mp))
        return encode_image(r, px).cpu(), encode_text(r, tok).cpu()

    ri, rt = _shared(me, one_process)
    cos = torch.nn.functional.cosine_similarity(img.cpu(), ri, dim=1)
    row.update(min_cosine=float(cos.min()), equal=_equal(img, ri) and _equal(txt, rt))
    row["top10_equal"] = _equal(_top10(img, corpus), _top10(ri.to(dev), corpus))
    _check(row["min_cosine"] >= 0.9999 and row["top10_equal"], f"proc {me}: the TP forward != one process: {row}")
    _check(all(h["ok"] for h in row["k2_held"].values()), f"proc {me}: K2 off its plain version: {row['k2_held']}")
    if dev.type == "cuda":
        row["forward_ms"] = _host_ms(lambda: encode_image(m, px), dev, iters=1, warm=False)
    if out and args.write:
        np.savez(os.path.join(out, f"tp_p{me}.npz"), img=img.cpu().numpy(), txt=txt.cpu().numpy(), ref_img=ri.numpy(), ref_txt=rt.numpy())
    return row


def embed_path(args, dev, me, out) -> dict:
    """The embedder's data axis over one shard a process: the grid's shard
    count kept, each process running its own block only (K2 at the data
    shard's rows), every process returning the one-process grid's
    embeddings and one device's top-10 ids."""
    import numpy as np
    import torch

    from imatch_tpu_torch.parallel.mesh import Grid, make_mesh
    from imatch_tpu_torch.pipeline import embedder as emb_mod

    grid = make_mesh([dev])
    rng = np.random.default_rng(args.seed + 5)
    frames = [rng.integers(0, 256, (64, 80, 3), dtype=np.uint8) for _ in range(args.batch)]
    blocks, served = [], emb_mod.encode_image

    def counted(model, pixels):
        blocks.append(int(pixels.shape[0]))
        return served(model, pixels)

    # a list of the grid's devices: the form that must give the grid again
    e = emb_mod.ClipEmbedder(args.config, device=dev, mesh=list(grid))
    emb_mod.encode_image = counted
    try:
        with _K2Watch() as k2:
            got = torch.from_numpy(e.embed_images(frames))
    finally:
        emb_mod.encode_image = served
    row = {"shards": len(e.mesh), "tower_blocks": blocks, "k2_launches": k2.launches, "k2_held": k2.held()}
    _check(len(e.mesh) == len(grid) and len(blocks) >= 1, f"proc {me}: the embedder lost the grid: {row}")

    def one_process():
        one = emb_mod.ClipEmbedder(args.config, device=dev).embed_images(frames)
        same = emb_mod.ClipEmbedder(args.config, device=dev, mesh=Grid([dev] * len(grid))).embed_images(frames)
        return torch.from_numpy(one), torch.from_numpy(same)

    one, same = _shared(me, one_process)
    corpus = torch.nn.functional.normalize(torch.randn((4096, got.shape[1]), generator=torch.Generator().manual_seed(3)), dim=1)
    row.update(
        equal_one_process_grid=_equal(got, same),
        min_cosine_one_device=float(torch.nn.functional.cosine_similarity(got, one, dim=1).min()),
        top10_equal_one_device=_equal(_top10(got, corpus), _top10(one, corpus)),
    )
    _check(row["equal_one_process_grid"] and row["top10_equal_one_device"], f"proc {me}: the embedder over processes: {row}")
    _check(all(h["ok"] for h in row["k2_held"].values()), f"proc {me}: K2 off its plain version: {row['k2_held']}")
    if out and args.write:
        np.savez(os.path.join(out, f"embed_p{me}.npz"), got=got.numpy(), same=same.numpy(), one=one.numpy())
    return row


def _init_tree(path):
    """A JAX-layout param tree saved flat (``--init-npz``), or None."""
    import numpy as np

    if not path:
        return None
    from imatch_tpu_torch.parallel.checkpoint import _unflatten

    with np.load(path) as z:
        return _unflatten({f"params/{k}": z[k] for k in z.files}, "params")


def train_config(name: str, layers=None):
    """The CLIP config ``name``, its image and text towers cut to
    ``layers`` ("V,T" encoder layers; None: the config's depth), at full
    width."""
    import dataclasses

    from imatch_tpu_torch.models.clip.configs import get_config

    cfg = get_config(name)
    if not layers:
        return cfg
    v, t = (int(n) for n in layers.split(","))
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, num_layers=v), text=dataclasses.replace(cfg.text, num_layers=t)
    )


def train_path(args, dev, me, out) -> dict:
    """``--steps`` DP + TP steps on the (procs / mp, mp) grid, each
    process on its data shard's rows and its model shard: the losses
    within rtol 1e-6 of the one-process grid's; then a checkpoint saved
    there restores in one process at mp = 1 to the one-process grid's
    parameters. With ``--reference caller`` the loss check is the
    caller's (it computes the one-process grid's steps itself, from
    ``clip_batch`` and ``--seed``), and process 0 restores the file at mp =
    1 and holds it against the state the processes saved."""
    import numpy as np
    import torch

    from imatch_tpu_torch.models.clip.bridge import named_to_numpy
    from imatch_tpu_torch.parallel import init_train_state, make_train_step
    from imatch_tpu_torch.parallel.checkpoint import restore_checkpoint, save_checkpoint
    from imatch_tpu_torch.parallel.mesh import Grid, make_mesh
    from imatch_tpu_torch.parallel.sharding import gather_named
    from imatch_tpu_torch.parallel.train import make_optimizer

    cfg, dtype = train_config(args.config, args.train_layers), _dtype(args, dev)
    key = _init_tree(args.init_npz)
    key = args.seed if key is None else key
    batches = [clip_batch(cfg, args.train_batch, args.seed + 100 + i) for i in range(args.steps)]
    tx = make_optimizer()

    def run(grid):
        t0 = time.perf_counter()
        state, _ = init_train_state(key, cfg, tx, mesh=grid)
        step = make_train_step(cfg, tx, mesh=grid, dtype=dtype)
        init_s = time.perf_counter() - t0
        losses, ms = [], []
        for px, tok in batches:
            t0 = time.perf_counter()
            state, loss = step(state, px, tok)
            losses.append(float(loss))  # waits for the step
            ms.append((time.perf_counter() - t0) * 1e3)
        return state, losses, ms, init_s

    grid = make_mesh(args.mp, [dev])
    state, losses, ms, init_s = run(grid)
    row = {"config": cfg.name, "layers": [cfg.vision.num_layers, cfg.text.num_layers], "batch": args.train_batch}
    row.update(grid=grid.shape, losses=losses, step_ms=ms, init_s=init_s)
    ckpt = os.path.join(out, "ckpt")
    t0 = time.perf_counter()
    save_checkpoint(ckpt, state)
    row["save_s"] = time.perf_counter() - t0
    full = None
    if 0 in grid.local_block()[0]:  # data row 0's processes gather its model row
        with torch.no_grad():
            full = gather_named(dict(state.params.named_parameters()), state.params, device=dev)
    if out and args.write and me == 0:
        np.savez(os.path.join(out, "train_params.npz"), losses=np.asarray(losses), **{
            "/".join(k): v for k, v in _flat(named_to_numpy(full, cfg)).items()
        })  # fmt: skip
    # every process's state freed before process 0 builds the one-process grid's
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if args.reference == "caller":
        if me == 0:
            t0 = time.perf_counter()
            template, _ = init_train_state(0, cfg, tx, device=dev)
            row["template_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = restore_checkpoint(ckpt, template)
            row["restore_s"] = time.perf_counter() - t0
            with torch.no_grad():
                got = dict(back.params.named_parameters())
                row["restored_mp1_max_abs_diff"] = max(float((got[n] - full[n]).abs().max()) for n in full)
            _check(
                row["restored_mp1_max_abs_diff"] == 0.0 and back.step == args.steps,
                f"proc {me}: the checkpoint restored at mp = 1: {row}",
            )
        return row

    def one_process():
        ref, ref_losses, ref_ms, _ = run(Grid([dev] * len(grid), args.mp))
        with torch.no_grad():
            want = gather_named(dict(ref.params.named_parameters()), ref.params, device=dev)
        del ref
        template, _ = init_train_state(0, cfg, tx, device=dev)
        t0 = time.perf_counter()
        back = restore_checkpoint(ckpt, template)
        restore_s = time.perf_counter() - t0
        with torch.no_grad():  # the file against the saved state, and the one-process grid's
            got = dict(back.params.named_parameters())
            saved = max(float((got[n] - full[n]).abs().max()) for n in full)
            grid_diff = max(float((got[n] - want[n]).abs().max()) for n in want)
        return ref_losses, ref_ms, saved, grid_diff, restore_s, back.step

    ref_losses, ref_ms, saved, grid_diff, restore_s, restored_step = _shared(me, one_process)
    row.update(
        one_process_losses=ref_losses,
        one_process_step_ms=ref_ms,
        restored_mp1_max_abs_diff=saved,
        params_max_abs_diff_to_one_process=grid_diff,
        restore_s=restore_s,
    )
    close = all(abs(a - b) <= 1e-6 * abs(b) for a, b in zip(losses, ref_losses))
    _check(close, f"proc {me}: DP + TP losses != the one-process grid's: {row}")
    _check(saved == 0.0 and restored_step == args.steps, f"proc {me}: the checkpoint restored at mp = 1: {row}")
    return row


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def ring_path(args, dev, me, out) -> dict:
    """Causal ring attention over the grid's data axis (procs x
    local-devices positions): output and gradient equal the one-process
    ring's over as many positions."""
    import numpy as np
    import torch

    from imatch_tpu_torch.parallel import ring_attention
    from imatch_tpu_torch.parallel.mesh import Grid, make_mesh

    grid = make_mesh([dev] * args.local_devices)
    shape = tuple(int(a) for a in args.ring.split(","))
    g = torch.Generator(device=dev).manual_seed(args.seed + 41)
    qkv = [torch.randn(shape, generator=g, device=dev).to(_dtype(args, dev)) for _ in range(3)]

    def ring(mesh):
        q, k, v = (t.clone().requires_grad_() for t in qkv)
        o = ring_attention(q, k, v, mesh=mesh, axis="data", causal=True)
        o.float().sum().backward()
        return [t.detach().cpu() for t in (o, q.grad, k.grad, v.grad)]

    got = ring(grid)
    want = _shared(me, lambda: ring(Grid([dev] * len(grid))))
    row = {"shape": list(shape), "ring_size": len(grid), "equal": all(_equal(a, b) for a, b in zip(got, want))}
    _check(row["equal"], f"proc {me}: the ring over processes != the one-process ring")
    if dev.type == "cuda":
        with torch.no_grad():
            row["ms"] = _host_ms(lambda: ring_attention(*qkv, mesh=grid, axis="data", causal=True), dev, iters=3)
            row["one_process_ms"] = _shared(
                me, lambda: _host_ms(lambda: ring_attention(*qkv, mesh=Grid([dev] * len(grid)), axis="data", causal=True), dev, iters=3)
            )
    if out and args.write:
        arrays = dict(zip(("out", "gq", "gk", "gv"), got), **dict(zip("qkv", qkv)))
        np.savez(os.path.join(out, f"ring_p{me}.npz"), **{n: t.float().cpu().numpy() for n, t in arrays.items()})
    return row


def gpipe_path(args, dev, me, out) -> dict:
    """The config's image-tower layers through ``gpipe_scan``, one stage a
    process, ``--microbatches``: equal to the one-process
    pipeline over as many stages; K2 launched layers / stages x M times a
    stage; under autograd a RuntimeError."""
    import numpy as np
    import torch

    from imatch_tpu_torch.models.clip.configs import get_config
    from imatch_tpu_torch.models.clip.model import init_random
    from imatch_tpu_torch.parallel import gpipe_scan
    from imatch_tpu_torch.parallel.mesh import Grid, make_mesh

    cfg, dtype = get_config(args.config), _dtype(args, dev)
    vc = cfg.vision
    grid = make_mesh([dev])  # one stage a process
    g = torch.Generator(device=dev).manual_seed(args.seed + 43)
    encoder = init_random(cfg, device=dev, dtype=dtype, generator=g).vision.encoder
    x = torch.randn((args.pipe_batch, vc.seq_len, vc.hidden_size), generator=g, device=dev).to(dtype)

    def body(h, layer):
        return layer(h, False), None

    def pipe(mesh):
        return gpipe_scan(body, x, encoder.layers, mesh=mesh, axis="data", microbatches=args.microbatches)

    with torch.no_grad(), _K2Watch() as k2:
        got = pipe(grid)
    want = _shared(me, lambda: pipe(Grid([dev] * len(grid))).cpu())
    stages, m = len(grid), args.microbatches
    row = {
        "config": cfg.name, "layers": vc.num_layers, "stages": stages, "microbatches": m,
        "k2_launches": k2.launches, "k2_held": k2.held(), "equal": _equal(got, want),
    }  # fmt: skip
    try:
        gpipe_scan(body, x.clone().requires_grad_(), encoder.layers, mesh=grid, axis="data", microbatches=m)
        row["grad_refused"] = False
    except RuntimeError as e:
        row["grad_refused"] = "forward only" in str(e)
    local = len(grid.local_shards())
    want_k2 = vc.num_layers // stages * local * m if dev.type == "cuda" else 0
    _check(row["equal"] and row["grad_refused"], f"proc {me}: gpipe over processes: {row}")
    _check(k2.launches == want_k2, f"proc {me}: K2 launched {k2.launches} times, not {want_k2}")
    _check(all(h["ok"] for h in row["k2_held"].values()), f"proc {me}: K2 off its plain version: {row['k2_held']}")
    if dev.type == "cuda":
        with torch.no_grad():
            row["ms"] = _host_ms(lambda: pipe(grid), dev, iters=3)
            row["one_process_ms"] = _shared(me, lambda: _host_ms(lambda: pipe(Grid([dev] * len(grid))), dev, iters=3))
    if out and args.write:
        np.savez(os.path.join(out, f"gpipe_p{me}.npz"), got=got.float().cpu().numpy())
    return row


PATHS = {"ivf": ivf_path, "tp": tp_path, "embed": embed_path, "train": train_path, "ring": ring_path, "gpipe": gpipe_path}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launcher(args) -> int:
    """Spawns the workers and waits for them. It imports no torch and
    touches no card: where the device is missing the workers raise."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    coordinator = f"localhost:{_free_port()}"
    scratch = None if args.out else tempfile.TemporaryDirectory()
    out_dir = args.out or scratch.name
    os.makedirs(out_dir, exist_ok=True)
    common = [
        "--procs", str(args.procs), "--local-devices", str(args.local_devices), "--coordinator", coordinator,
        "--device", args.device, "--rows", str(args.rows), "--dim", str(args.dim),
        "--queries", str(args.queries), "-k", str(args.k), "--timeout", str(args.timeout),
        "--paths", args.paths, "--config", args.config, "--batch", str(args.batch), "--mp", str(args.mp),
        "--train-batch", str(args.train_batch), "--steps", str(args.steps), "--ring", args.ring,
        "--pipe-batch", str(args.pipe_batch), "--microbatches", str(args.microbatches),
        "--centres", str(args.centres), "--seed", str(args.seed), "--out", out_dir,
        "--reference", args.reference,
    ]  # fmt: skip
    if args.write:
        common.append("--write")
    if args.init_npz:
        common += ["--init-npz", args.init_npz]
    if args.train_layers:
        common += ["--train-layers", args.train_layers]
    procs, outs = [], []
    for pid in range(args.procs):
        out = tempfile.TemporaryFile(mode="w+")
        cmd = [sys.executable, "-m", "imatch_tpu_torch.scripts.dryrun_multiprocess", "--worker", str(pid), *common]
        procs.append(subprocess.Popen(cmd, env=env, stdout=out, stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    rc, deadline, notes = 0, time.monotonic() + args.timeout, []
    try:
        while any(p.poll() is None for p in procs):
            failed = [i for i, p in enumerate(procs) if p.returncode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                # a lone worker would wait in a collective: stop every one
                why = f"proc {failed[0]} failed" if failed else "timed out"
                notes.append(f"[launcher] {why}: stopping the workers")
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if scratch is not None:
            scratch.cleanup()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        out.seek(0)
        sys.stdout.write(out.read())
        out.close()
        if p.returncode != 0:
            rc = 1
            print(f"[launcher] proc {pid} exited {p.returncode}")
    for note in notes:
        print(note)
    if rc == 0:
        exact = ", sharded engine exact" if "sharded" in args.paths.split(",") else ""
        print(
            f"MULTIPROCESS DRYRUN OK: {args.procs} processes x {args.local_devices} "
            f"{args.device} shards{exact}; paths {args.paths} checked"
        )
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--device", default=os.environ.get("IMATCH_DEVICE") or "cuda", help="cpu or cuda")
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("--timeout", type=int, default=300, help="seconds for the workers, and each collective's bound")
    ap.add_argument("--paths", default="sharded", help="comma-separated: sharded, ivf, tp, embed, train, ring, gpipe")
    ap.add_argument("--config", default="tiny", help="the CLIP config of tp, embed, train and gpipe")
    ap.add_argument("--batch", type=int, default=4, help="tp's images and texts, embed's frames")
    ap.add_argument("--mp", type=int, default=2, help="the model axis of tp and train (one shard a process)")
    ap.add_argument("--train-batch", type=int, default=8)
    ap.add_argument("--train-layers", default=None, help="train: V,T image and text layers (default: the config's)")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--ring", default="2,3,16,8", help="B,H,S,Dh")
    ap.add_argument("--pipe-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--centres", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="the workers' directory (a temporary one by default)")
    ap.add_argument("--write", action="store_true", help="leave each path's results under --out")
    ap.add_argument("--init-npz", default=None)
    ap.add_argument(
        "--reference", choices=("process0", "caller"), default="process0",
        help="train: process 0 checks against the one-process grid, or the caller does (the workers stop after the save)",
    )  # fmt: skip
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    args = ap.parse_args(argv)
    if args.worker is not None:
        return worker(args)
    return launcher(args)


if __name__ == "__main__":
    sys.exit(main())
