"""Multi-device dryrun: every parallel path of the port on one n-shard grid.

Port of ``__graft_entry__.dryrun_multichip``: over a grid of ``n``
devices (``cpu`` repeated on the CPU; logical shards of ``cuda:0`` on one
card), split into (data, model) with model 2 where n is even, each step
as JAX's:

- one DP + TP train step of the tiny CLIP, its loss finite;
- ``sharded_cosine_topk`` over the data axis, each query its own top hit;
- a ``sharded`` store against a ``tilemax`` store, equal ids;
- a mutation on each (an add and a delete after the first build), absorbed
  by at least two O(batch) patches of the sharded device state, still
  equal to tilemax;
- a device-resident add (a tensor batch) equal to the host add;
- ``ivf-sharded`` at full probe, equal to the exact store;
- the W8A8 image tower (IMATCH_EMBED_QUANT=int8) over the data axis
  against one device;
- ring attention over ``data`` (causal) against ``mha_xla``;
- GPipe over ``model`` (where model > 1) against the plain loop.

Usage:
    python -m imatch_tpu_torch.scripts.dryrun_multichip [--devices 8] [--device cpu]

Runs on the card unless ``--device cpu`` (or IMATCH_DEVICE=cpu) asks for
the CPU. Prints ``dryrun_multichip ok`` and a JSON line of what it held,
and exits non-zero on any mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from imatch_tpu_torch.device import resolve_device

# on the card the embedder runs bf16, whose matmuls see other batch sizes
# on a data shard: chip_smoke's per-row bar for DP against one device
EMBED_MIN_COSINE = 0.999


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def dryrun_multichip(n_devices: int = 8, device=None) -> dict:
    """Each step above; raises AssertionError on the first that fails.
    Returns what was held, for a caller that logs it."""
    from imatch_tpu_torch.index.store import VectorStore
    from imatch_tpu_torch.models.clip.configs import get_config
    from imatch_tpu_torch.ops.attention import mha_xla
    from imatch_tpu_torch.parallel import (
        gpipe_scan,
        init_train_state,
        make_mesh,
        make_train_step,
        pad_corpus_for_mesh,
        ring_attention,
        sharded_cosine_topk,
    )
    from imatch_tpu_torch.pipeline.embedder import ClipEmbedder

    dev = resolve_device(device)
    mp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    grid = make_mesh(mp, [dev] * n_devices)
    dp = grid.shape["data"]
    shards = [dev] * n_devices
    rng = np.random.default_rng(0)
    out = {"grid": {"data": dp, "model": mp}, "device": str(dev)}

    # --- one train step: DP over the batch, Megatron TP inside the towers
    cfg = get_config("tiny")
    state, tx = init_train_state(0, cfg, mesh=grid)
    step = make_train_step(cfg, tx, mesh=grid)
    b = 2 * dp
    pixels = torch.ones((b, cfg.vision.image_size, cfg.vision.image_size, 3))
    tokens = torch.from_numpy(rng.integers(0, cfg.text.vocab_size, (b, cfg.text.max_positions)))
    state, loss = step(state, pixels, tokens)
    out["train_loss"] = float(loss)
    assert np.isfinite(out["train_loss"]), f"non-finite loss {out['train_loss']}"
    del state

    # --- corpus-sharded exact top-k over the data axis
    n, d, k = 64 * dp, 32, 5
    corpus = torch.from_numpy(_unit(rng, (n, d))).to(dev)
    corpus, valid = pad_corpus_for_mesh(corpus, torch.ones(n, dtype=torch.bool, device=dev), dp)
    _, idx = sharded_cosine_topk(corpus[:3], corpus, valid, mesh=grid.axis("data"), k=k, score_dtype=torch.float32)
    assert idx[:, 0].cpu().tolist() == [0, 1, 2], "self-match failed"

    # --- the serving path: a sharded store against a tilemax store
    emb = _unit(rng, (100, 32))
    ids = [f"r{i}" for i in range(100)]
    sharded = VectorStore(engine="sharded", device=dev, mesh=shards)
    exact = VectorStore(engine="tilemax", device=dev)
    for st in (sharded, exact):
        st.add(ids=ids, embeddings=emb)
    rs = sharded.query(emb[:2], n_results=4)
    rt = exact.query(emb[:2], n_results=4)
    assert rs["ids"] == rt["ids"], "sharded store != tilemax store"
    assert rs["ids"][0][0] == "r0" and rs["ids"][1][0] == "r1"

    # --- mutations after the build: O(batch) patches of the sharded state
    more = _unit(rng, (8, 32))
    mids = [f"m{i}" for i in range(8)]
    mut_sharded = VectorStore(engine="sharded", device=dev, mesh=shards)
    mut_exact = VectorStore(engine="tilemax", device=dev)
    for st in (mut_sharded, mut_exact):
        st.add(ids=ids, embeddings=emb)
        st.query(emb[:1], n_results=2)  # build the device state
        st.add(ids=mids, embeddings=more)
        st.delete(["r5"])
    out["patched_mutations"] = mut_sharded.stats()["patched_mutations"]
    assert out["patched_mutations"] >= 2, "mesh patch not taken"
    rp = mut_sharded.query(more[:2], n_results=4)
    assert rp["ids"] == mut_exact.query(more[:2], n_results=4)["ids"], "patched sharded store != tilemax"
    assert rp["ids"][0][0] == "m0" and rp["ids"][1][0] == "m1"

    # --- a device-resident add: a tensor batch scattered into the shards
    dev_rows = torch.from_numpy(_unit(rng, (4, 32))).to(dev)
    dids = [f"d{i}" for i in range(4)]
    mut_sharded.add(ids=dids, embeddings=dev_rows)
    mut_exact.add(ids=dids, embeddings=dev_rows.cpu().numpy())
    q = dev_rows[:1].cpu().numpy()
    rq = mut_sharded.query(q, n_results=3)
    assert rq["ids"] == mut_exact.query(q, n_results=3)["ids"], "device-resident mesh add != host add"
    assert rq["ids"][0][0] == "d0"

    # --- ivf-sharded at full probe reproduces the exact engine
    os.environ["IMATCH_IVF_NPROBE"] = "4096"
    try:
        ann = VectorStore(engine="ivf-sharded", device=dev, mesh=shards)
        ann.add(ids=ids, embeddings=emb)
        assert ann.query(emb[:2], n_results=4)["ids"] == rt["ids"], "ivf-sharded full probe != exact"
    finally:
        del os.environ["IMATCH_IVF_NPROBE"]

    # --- the W8A8 image tower over the data axis against one device
    os.environ["IMATCH_EMBED_QUANT"] = "int8"
    try:
        imgs = [rng.integers(0, 256, (40, 44, 3), dtype=np.uint8) for _ in range(dp + 1)]  # dp does not divide
        e_dp = ClipEmbedder(config="tiny", mesh=list(grid.axis("data")))
        e_1 = ClipEmbedder(config="tiny", device=dev)
        assert e_dp.quant == "int8"
        got, want = e_dp.embed_images(imgs), e_1.embed_images(imgs)
        if dev.type == "cpu":
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
        cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
        out["w8a8_dp_min_cosine"] = float(cos.min())
        assert out["w8a8_dp_min_cosine"] >= EMBED_MIN_COSINE, "W8A8 DP embeddings != one device"
    finally:
        del os.environ["IMATCH_EMBED_QUANT"]

    # --- sequence parallelism: ring attention over the data axis
    qkv = torch.from_numpy(rng.standard_normal((2, 2, 8 * dp, 16)).astype(np.float32)).to(dev)
    ring = ring_attention(qkv, qkv, qkv, mesh=grid, axis="data", causal=True)
    out["ring_max_abs_err"] = float((ring - mha_xla(qkv, qkv, qkv, causal=True)).abs().max())
    assert ring.shape == qkv.shape and out["ring_max_abs_err"] <= 2e-5, "ring attention mismatch"

    # --- pipeline parallelism: GPipe over the model axis
    if mp > 1:
        stacked = {"w": torch.from_numpy(rng.standard_normal((2 * mp, 16, 16)).astype(np.float32) * 0.1).to(dev)}
        xb = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)).to(dev)

        def body(h, lp):
            return torch.tanh(h @ lp["w"]), None

        ref = xb
        for w in stacked["w"]:
            ref = body(ref, {"w": w})[0]
        pp = gpipe_scan(body, xb, stacked, mesh=grid, axis="model", microbatches=4)
        out["gpipe_max_abs_err"] = float((pp - ref).abs().max())
        assert out["gpipe_max_abs_err"] <= 1e-5, "gpipe mismatch"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8, help="shards of the grid (the device repeated)")
    ap.add_argument("--device", default=os.environ.get("IMATCH_DEVICE") or None, help="cpu, or cuda (the default)")
    args = ap.parse_args(argv)
    out = dryrun_multichip(args.devices, args.device)
    print("dryrun_multichip ok")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
