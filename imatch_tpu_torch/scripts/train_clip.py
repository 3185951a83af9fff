"""Fine-tune CLIP on the indexed library — the port's training CLI.

Port of ``scripts/train_clip.py``: contrastively fine-tunes the CLIP
towers on (processed image, description + custom metadata) pairs straight
out of the app's own state directory, with DP + TP over a (data, model)
grid and checkpoint and resume in the JAX package's format
(``parallel/checkpoint.py``: either package resumes the other's run, at
any model-parallel size).

Usage:
  python -m imatch_tpu_torch.scripts.train_clip --root approot \\
      --config vit-b32 --steps 1000 --batch 64 --mp 1 \\
      --ckpt-dir ckpt [--resume] [--lr 1e-5] [--synthetic N] [--device cpu]

--synthetic N trains on N random pairs (pipeline smoke-testing without an
indexed library). The grid is ``make_mesh(model_parallel=--mp)`` over every
visible card, as the JAX CLI's mesh is over every local device, or over
``--device``: one device (``cpu``), or a comma-separated device list in
which a device may repeat (``cpu,cpu,cpu,cpu``: four logical shards of the
CPU, as the JAX suite's virtual host devices; ``cuda:0,cuda:0``). A batch
that does not divide by the data axis is rounded up, with a warning. It
trains in bf16 on the card and fp32 on the CPU, as the JAX CLI does on its
accelerator and elsewhere. It logs ``mesh: data=D model=M``, ``step N
loss X`` every 10 steps (or 30 s), ``resumed from step N`` and ``done at
step N``. A run over several real cards has not been made.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from typing import Callable, List, Optional

import numpy as np

logger = logging.getLogger("imatch.train")


def load_library(root: str, device=None):
    """(image paths, texts) from an app state directory."""
    from imatch_tpu_torch.index.store import VectorStore

    data_dir = os.path.join(root, os.environ.get("IMATCH_DATA_DIR", "index_data"))
    store = VectorStore.load(data_dir, persist=False, device=device)
    got = store.get(include=["metadatas"])
    paths, texts = [], []
    for md in got["metadatas"]:
        md = md or {}
        p = md.get("processed_url") or ""
        if not os.path.exists(p):
            p = os.path.join(root, "static", "processed", f"{md.get('id')}.png")
        if not os.path.exists(p):
            continue
        text = " ".join(t for t in (md.get("description"), md.get("custom_metadata")) if t)
        paths.append(p)
        texts.append(text or md.get("filename", ""))
    return paths, texts


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--config", default="vit-b32")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--mp", type=int, default=1, help="model-parallel size")
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--ckpt-dir", default="ckpt")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--device",
        default=os.environ.get("IMATCH_DEVICE") or None,
        help="the grid's devices: every visible card (default), cpu, or a "
        "comma-separated list in which a device may repeat; IMATCH_DEVICE sets the default",
    )
    return ap.parse_args(argv)


@dataclasses.dataclass
class Run:
    """What ``train`` did: the final state, the loss and wall time of each
    step it ran (the loss read back each step, as the JAX loop reads the
    step), and the seconds of each checkpoint save and of the restore."""

    state: object
    rc: int = 0
    losses: List[float] = dataclasses.field(default_factory=list)
    step_s: List[float] = dataclasses.field(default_factory=list)
    save_s: List[float] = dataclasses.field(default_factory=list)
    restore_s: Optional[float] = None


def batch_source(args: argparse.Namespace, cfg, device) -> Optional[Callable]:
    """A function returning the next training batch, ``(pixels, tokens)``
    on ``device``: pairs drawn with ``np.random.default_rng(args.seed)``
    from ``--synthetic`` random frames or from the library (None where it
    holds fewer than two usable records). Frames go through ``preprocess``
    and texts through the tokenizer, an oversized vocab folded."""
    import torch

    from imatch_tpu_torch.ops.preprocess import preprocess_images
    from imatch_tpu_torch.ops.tokenizer import default_tokenizer
    from imatch_tpu_torch.runtime.loader import default_loader

    rng = np.random.default_rng(args.seed)
    tok = default_tokenizer()
    size = cfg.vision.image_size

    if args.synthetic:
        n = args.synthetic
        frames = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
        texts = [f"synthetic sample {i}" for i in range(n)]

        def sample_batch():
            idx = rng.integers(0, n, args.batch)
            return [frames[i] for i in idx], [texts[i] for i in idx]

    else:
        paths, texts_all = load_library(args.root, device=device)
        if len(paths) < 2:
            logger.error(
                "library at %s has %d usable records; need >= 2 (or use --synthetic N)",
                args.root,
                len(paths),
            )
            return None
        logger.info("library: %d image-text pairs", len(paths))
        loader = default_loader()

        def sample_batch():
            idx = rng.integers(0, len(paths), args.batch)
            imgs = loader.decode_batch([paths[i] for i in idx])
            # failed decodes (None) are replaced with the first good image
            # so the step's batch shape holds
            good = next((g for g in imgs if g is not None), None)
            if good is None:
                raise RuntimeError("every image in the sampled batch failed to decode")
            imgs = [g if g is not None else good for g in imgs]
            return imgs, [texts_all[i] for i in idx]

    def next_batch():
        imgs, txts = sample_batch()
        pixels = preprocess_images(imgs, device=device, out_size=size)
        tokens = tok.encode_batch(txts, max_length=cfg.text.max_positions)
        if tok.vocab_size > cfg.text.vocab_size:
            # Fold oversized tokenizer vocabs as the embedder does: eos maps
            # to the model's eos id so pooling stays at the true first eos;
            # other ids fold into [0, vocab - 2] (configs keep eos at
            # vocab - 1, so folded ids never alias it).
            tokens = np.where(
                tokens == tok.eos_id, cfg.text.eos_token_id, tokens % (cfg.text.vocab_size - 1)
            )
        return pixels, torch.from_numpy(tokens).to(device)

    return next_batch


def grid_of(args: argparse.Namespace):
    """``make_mesh(model_parallel=--mp)`` over ``--device``'s devices (a
    comma-separated list) or every visible card."""
    from imatch_tpu_torch.parallel.mesh import make_mesh

    devices = args.device.split(",") if args.device else None
    return make_mesh(model_parallel=args.mp, devices=devices)


def train(args: argparse.Namespace) -> Run:
    from imatch_tpu_torch.device import default_compute_dtype
    from imatch_tpu_torch.models.clip.configs import get_config
    from imatch_tpu_torch.parallel.checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from imatch_tpu_torch.parallel.sharding import clip_param_specs
    from imatch_tpu_torch.parallel.train import init_train_state, make_optimizer, make_train_step

    mesh = grid_of(args)
    device = mesh[0]
    cfg = get_config(args.config)
    dtype = default_compute_dtype(device)
    logger.info("mesh: data=%d model=%d (%s)", mesh.shape["data"], mesh.shape["model"], device)
    logger.info("%s compute, config %s", dtype, cfg.name)
    dp = mesh.shape["data"]
    if args.batch % dp:
        new_batch = -(-args.batch // dp) * dp
        logger.warning(
            "batch %d not divisible by data-parallel size %d; using %d", args.batch, dp, new_batch
        )
        args.batch = new_batch

    tx = make_optimizer(lr=args.lr)
    state, tx = init_train_state(args.seed, cfg, tx, mesh=mesh)
    run = Run(state)
    if args.resume and latest_step(args.ckpt_dir) is not None:
        t0 = time.perf_counter()
        state = restore_checkpoint(args.ckpt_dir, state, mesh=mesh, param_specs=clip_param_specs())
        run.restore_s = time.perf_counter() - t0
        logger.info("resumed from step %d", state.step)
    step_fn = make_train_step(cfg, tx, mesh=mesh, dtype=dtype)
    next_batch = batch_source(args, cfg, device)
    if next_batch is None:
        run.rc = 2
        return run

    def save():
        t0 = time.perf_counter()
        path = save_checkpoint(args.ckpt_dir, state)
        run.save_s.append(time.perf_counter() - t0)
        logger.info("checkpoint -> %s", path)

    t_log = time.time()
    saved = None
    for _ in range(state.step, args.steps):
        t0 = time.perf_counter()
        state, loss = step_fn(state, *next_batch())
        run.losses.append(float(loss))
        run.step_s.append(time.perf_counter() - t0)
        if state.step % 10 == 0 or time.time() - t_log > 30:
            logger.info("step %d loss %.4f", state.step, run.losses[-1])
            t_log = time.time()
        if state.step % args.ckpt_every == 0 or state.step == args.steps:
            save()
            saved = state.step
    if state.step % args.ckpt_every != 0 and saved != state.step:
        save()
    run.state = state
    logger.info("done at step %d", state.step)
    return run


def main(argv=None) -> int:
    return train(parse_args(argv)).rc


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    raise SystemExit(main())
