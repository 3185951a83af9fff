"""Where the time of the Moondream captioner goes on the card, in a fresh
process (a torch.profiler session slows the host's later launches, and
chip_smoke.py's phase 8b runs after several):

    python -m imatch_tpu_torch.scripts.md_stages [--config moondream2] [--iters 5]

``MoondreamTorch`` at ``config`` (full width and depth, seeded random
weights, bf16, the byte-fallback vocab) times each stage of the slice's
path on the host's clock, each call ending on the host: the vision encode
at B = 1 and 16, the caption prefill at B = 1 (BOS + 729 patches + the
caption prompt, a 128-slot cache bucket for 48 new tokens), one greedy
decode step at B = 1 and 16, a whole caption at B = 1 (prefill + 47 decode
steps), the yes/no prefill at B = 1 and 64. Then, last, a torch.profiler
trace of each (``kernel_ab.trace``): its device busy ms, the idle share
against the host time, the device operations a call, and K2's ms. Prints
one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from imatch_tpu_torch.models.moondream.generate import (
    _decode_step,
    init_gen_state,
    prefill,
    vqa_yes_no,
)
from imatch_tpu_torch.models.moondream.model import encode_image_features
from imatch_tpu_torch.models.moondream.runtime import CAPTION_PROMPT, MoondreamTorch
from imatch_tpu_torch.ops.kernels import _build
from imatch_tpu_torch.scripts._common import card
from imatch_tpu_torch.scripts.kernel_ab import trace

SEED = 0
MAX_NEW = 48


def host_ms(fn, iters: int) -> float:
    """Mean host-clock ms of a call that ends in a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def stage_calls(svc: MoondreamTorch) -> dict:
    """Zero-argument calls of each stage, on seeded inputs."""
    dev, cfg = svc.device, svc.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED)
    size = cfg.vision.image_size
    pixels = {b: torch.rand((b, size, size, 3), generator=gen, device=dev) * 2 - 1 for b in (1, 16)}
    feats = encode_image_features(svc.model, pixels[16]).float()
    caption_ids = svc._prompt_id_list(CAPTION_PROMPT, max_new=MAX_NEW)
    yes_no_ids = svc._prompt_id_list("\n\nQuestion: Yes or No: is there a red object\n\nAnswer:", max_new=1)

    def decode_state(b):
        """A fresh decode state after the caption prefill of ``b`` rows;
        the step then writes the cache slot after the prompt."""
        logits, cache, pos = prefill(svc.model, feats[:b], svc._tokens(caption_ids, b), max_new=MAX_NEW)
        return init_gen_state(svc.model, logits, cache, pos, max_new=MAX_NEW)

    states = {b: decode_state(b) for b in (1, 16)}
    feats64 = feats.repeat(4, 1, 1)
    return {
        "encode_b1": lambda: encode_image_features(svc.model, pixels[1]),
        "encode_b16": lambda: encode_image_features(svc.model, pixels[16]),
        "caption_prefill_b1": lambda: prefill(
            svc.model, feats[:1], svc._tokens(caption_ids, 1), max_new=MAX_NEW
        ),
        "decode_step_b1": lambda: _decode_step(svc.model, states[1]),
        "decode_step_b16": lambda: _decode_step(svc.model, states[16]),
        "caption_b1": lambda: svc._run_generate(feats[:1], svc._tokens(caption_ids, 1), MAX_NEW),
        "yes_no_b1": lambda: vqa_yes_no(
            svc.model, feats[:1], svc._tokens(yes_no_ids, 1), svc._yes_ids, svc._no_ids
        ),
        "yes_no_b64": lambda: vqa_yes_no(
            svc.model, feats64, svc._tokens(yes_no_ids, 64), svc._yes_ids, svc._no_ids
        ),
    }


def main(config: str = "moondream2", iters: int = 5) -> dict:
    dev = torch.device("cuda")
    _build.build()
    os.environ["IMATCH_MD_CONFIG"] = config
    svc = MoondreamTorch(device=dev)
    calls = stage_calls(svc)
    out = {
        "card": card(dev),
        "config": config,
        "dtype": str(svc.dtype).replace("torch.", ""),
        "caption_prefill_len": svc.cfg.vision.num_patches
        + len(svc._prompt_id_list(CAPTION_PROMPT, max_new=MAX_NEW)),
    }
    host = {}
    for name, fn in calls.items():
        host[name] = host_ms(fn, 1 if name == "caption_b1" else iters)
        out[f"{name}_host_ms"] = host[name]
    # traces last: a profiler session slows the host's later launches
    for name, fn in calls.items():
        if name == "caption_b1":
            continue  # its steps are decode_step_b1's
        t = trace(fn, 3)
        out[f"{name}_device_busy_ms"] = t["busy_ms"]
        out[f"{name}_idle_share"] = 1.0 - t["busy_ms"] / host[name]
        out[f"{name}_device_ops"] = t["ops"]
        out[f"{name}_k2_ms"] = t["by_key"].get("K2", 0.0)
        out[f"{name}_guarded"] = t["guarded"]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="moondream2")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    main(args.config, args.iters)
