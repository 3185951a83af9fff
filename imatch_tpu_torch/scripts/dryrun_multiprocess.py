"""Multi-process dryrun: the sharded store over a grid that spans processes.

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

Usage:
    python -m imatch_tpu_torch.scripts.dryrun_multiprocess --device cpu      # 2 procs x 4 cpu shards
    python -m imatch_tpu_torch.scripts.dryrun_multiprocess --procs 2 --local-devices 2 \\
        --rows 262144 --dim 768 --queries 16                                  # on the card

``--device cuda`` (the default) puts process p's shards on card
p mod (visible cards): on a one-card machine every process shares
``cuda:0``, as logical shards. The launcher picks a free port for the
coordinator, and exits 0 and prints ``MULTIPROCESS DRYRUN OK`` only when
every worker did; a worker that fails or outlives ``--timeout`` makes it
exit non-zero (the others are then stopped). Each worker prints one
``[proc i] {json}`` line: its K1 launches, the search's ms for one query
and the all-gather's ms within it (on the card).
"""

from __future__ import annotations

import argparse
import json
import os
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


def _host_ms(fn, device, iters: int = 10) -> float:
    """Mean host-clock ms of one call, after a warm call; every process
    runs the same loop (its collectives pair up)."""
    import torch

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
    import numpy as np
    import torch

    from imatch_tpu_torch.index.store import VectorStore
    from imatch_tpu_torch.ops.kernels.topk import tile_max
    from imatch_tpu_torch.parallel import distributed
    from imatch_tpu_torch.parallel.dist_search import prepare_sharded_corpus, sharded_topk_prepared
    from imatch_tpu_torch.parallel.mesh import make_mesh

    me = args.worker
    dev = _local_device(args.device, me)
    torch.zeros(1, device=dev)  # the card's context, timed apart
    seconds = {"card": time.perf_counter() - T0}
    distributed.initialize(args.coordinator, args.procs, me, timeout=args.timeout)
    seconds["group"] = time.perf_counter() - T0
    try:
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
        row["seconds_since_start"] = seconds  # at the end of each stage
        print(f"[proc {me}] " + json.dumps(row), flush=True)
    finally:
        distributed.shutdown()
    return 0


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
    common = [
        "--procs", str(args.procs), "--local-devices", str(args.local_devices), "--coordinator", coordinator,
        "--device", args.device, "--rows", str(args.rows), "--dim", str(args.dim),
        "--queries", str(args.queries), "-k", str(args.k), "--timeout", str(args.timeout),
    ]  # fmt: skip
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
        print(
            f"MULTIPROCESS DRYRUN OK: {args.procs} processes x {args.local_devices} "
            f"{args.device} shards, sharded engine exact"
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
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    args = ap.parse_args(argv)
    if args.worker is not None:
        return worker(args)
    return launcher(args)


if __name__ == "__main__":
    sys.exit(main())
