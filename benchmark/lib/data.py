"""Inputs and weights made from ``--seed``.

The same seed gives the same weights, texts, store rows and schedule. Sizes and arrivals are the same set for every seed, in another
order, so that seeds change the data and not the amount of work.
Weights and rows are drawn on the run's device by a
``torch.Generator`` in a few large calls.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch


def sub_seed(seed: int, tag: str) -> int:
    """An independent 63-bit seed for one use of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


# -- weights -------------------------------------------------------------------


def _encoder_leaves(prefix: str, layers: int, d: int, inter: int):
    for i in range(layers):
        p = f"{prefix}.encoder.layers.{i}"
        yield f"{p}.ln1.weight", (d,), "ln_weight"
        yield f"{p}.ln1.bias", (d,), "ln_bias"
        yield f"{p}.qkv.weight", (3 * d, d), d
        yield f"{p}.qkv.bias", (3 * d,), "bias"
        yield f"{p}.out.weight", (d, d), d
        yield f"{p}.out.bias", (d,), "bias"
        yield f"{p}.ln2.weight", (d,), "ln_weight"
        yield f"{p}.ln2.bias", (d,), "ln_bias"
        yield f"{p}.fc1.weight", (inter, d), d
        yield f"{p}.fc1.bias", (inter,), "bias"
        yield f"{p}.fc2.weight", (d, inter), inter
        yield f"{p}.fc2.bias", (d,), "bias"


def weight_leaves(cfg: dict):
    """(name, shape, kind) of every weight of the two towers, named as the
    served module names its parameters. ``kind`` is a matrix's fan-in
    (drawn normal(0, 1 / sqrt(fan_in)), so activations keep their scale
    through the depth and the output depends on the input), or one of
    ``embedding`` and ``bias`` (normal(0, 0.02)), ``ln_weight``
    (1 + normal(0, 0.02)), ``ln_bias`` (normal(0, 0.02))."""
    v, t, proj = cfg["vision_config"], cfg["text_config"], cfg["projection_dim"]
    dv, p = v["hidden_size"], v["patch_size"]
    seq = (v["image_size"] // p) ** 2 + 1
    yield "vision.patch_embedding.weight", (dv, 3, p, p), 3 * p * p
    yield "vision.class_embedding", (dv,), "embedding"
    yield "vision.position_embedding", (seq, dv), "embedding"
    yield "vision.pre_ln.weight", (dv,), "ln_weight"
    yield "vision.pre_ln.bias", (dv,), "ln_bias"
    yield from _encoder_leaves("vision", v["num_hidden_layers"], dv, v["intermediate_size"])
    yield "vision.post_ln.weight", (dv,), "ln_weight"
    yield "vision.post_ln.bias", (dv,), "ln_bias"
    yield "vision.projection.weight", (proj, dv), dv
    dt = t["hidden_size"]
    yield "text.token_embedding.weight", (t["vocab_size"], dt), "embedding"
    yield "text.position_embedding", (t["max_position_embeddings"], dt), "embedding"
    yield from _encoder_leaves("text", t["num_hidden_layers"], dt, t["intermediate_size"])
    yield "text.final_ln.weight", (dt,), "ln_weight"
    yield "text.final_ln.bias", (dt,), "ln_bias"
    yield "text.projection.weight", (proj, dt), dt


def make_weights(cfg: dict, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every weight of the two towers from the seed: the LayerNorms in
    fp32 (as they are served), the rest in ``dtype``, each group drawn by
    one call on ``device`` and cut into leaves."""
    return draw_leaves(list(weight_leaves(cfg)), seed, "weights", device, dtype)


def draw_leaves(leaves, seed: int, tag: str, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """(name, shape, kind) leaves (``weight_leaves``' kinds) from the seed:
    the LayerNorms in fp32, the rest in ``dtype``, each group drawn by one
    call of the ``tag`` generator on ``device`` and cut into leaves."""
    is_ln = [isinstance(k, str) and k.startswith("ln_") for _, _, k in leaves]
    sizes = [math.prod(s) for _, s, _ in leaves]
    gen = generator(seed, tag, device)
    flat = {
        False: torch.empty(sum(n for n, ln in zip(sizes, is_ln) if not ln), dtype=dtype, device=device),
        True: torch.empty(sum(n for n, ln in zip(sizes, is_ln) if ln), dtype=torch.float32, device=device),
    }
    for buf in flat.values():
        buf.normal_(generator=gen)
    out, off = {}, {False: 0, True: 0}
    with torch.no_grad():
        for (name, shape, kind), n, ln in zip(leaves, sizes, is_ln):
            w = flat[ln][off[ln] : off[ln] + n].view(shape)
            off[ln] += n
            if kind == "ln_weight":
                w.mul_(0.02).add_(1.0)
            elif isinstance(kind, int):
                w.mul_(1.0 / math.sqrt(kind))
            else:
                w.mul_(0.02)
            out[name] = w
    return out


# -- texts ---------------------------------------------------------------------

_LETTERS = np.array(list("etaoinshrdlucmfwypvbgkjqxz"))
_LETTER_P = np.array(
    [12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8, 2.8, 2.4, 2.2, 2.4, 2.0, 2.0, 1.0, 1.5, 2.0, 0.8, 0.2, 0.1, 0.2, 0.1]
)


def vocabulary(n_words: int = 8192) -> List[str]:
    """A fixed list of pseudo-words, 2 to 10 letters drawn by English
    letter frequencies (the same for every seed, as a language is)."""
    rng = np.random.default_rng(20260101)
    lengths = np.clip(rng.poisson(4.2, n_words) + 2, 2, 10)
    p = _LETTER_P / _LETTER_P.sum()
    return ["".join(rng.choice(_LETTERS, size=int(n), p=p)) for n in lengths]


def word_counts(n: int, lo: int, hi: int, alpha: float) -> np.ndarray:
    """``n`` word counts from a Pareto tail of index ``alpha`` above
    ``lo``, cut at ``hi``, taken at the n mid-quantiles: the same multiset
    for every seed."""
    u = (np.arange(n) + 0.5) / n
    return np.minimum(hi, np.floor(lo / (1.0 - u) ** (1.0 / alpha))).astype(int)


def make_texts(n_requests: int, per_request: int, lo: int, hi: int, alpha: float, seed: int) -> List[List[str]]:
    """``n_requests`` requests of ``per_request`` distinct texts: every
    request holds the same multiset of word counts (``word_counts``) in a
    seeded order, its words drawn from the seed."""
    vocab = np.array(vocabulary())
    counts = word_counts(per_request, lo, hi, alpha)
    rng = np.random.default_rng(sub_seed(seed, "texts"))
    out = []
    for r in range(n_requests):
        order = rng.permutation(counts)
        words = vocab[rng.integers(0, len(vocab), int(order.sum()))]
        texts, at = [], 0
        for c in order:
            texts.append(" ".join(words[at : at + c]))
            at += c
        out.append(texts)
    return out


def make_text_stream(n: int, lo: int, hi: int, alpha: float, seed: int, tag: str = "text-stream") -> List[str]:
    """``n`` texts, one a request: their word counts are the window's
    ``word_counts(n, ...)`` (the same multiset every seed) in a seeded
    order, their words drawn from the seed."""
    vocab = np.array(vocabulary())
    rng = np.random.default_rng(sub_seed(seed, tag))
    counts = rng.permutation(word_counts(n, lo, hi, alpha))
    words = vocab[rng.integers(0, len(vocab), int(counts.sum()))]
    bounds = np.concatenate([[0], np.cumsum(counts)])
    return [" ".join(words[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


# -- store rows and schedules ---------------------------------------------------


def app_metadata(ids: Sequence[str]) -> List[dict]:
    """The metadata dict the app stores with each image (pipeline/ingest's
    keys), for the benchmark's own ids."""
    return [
        {
            "id": i,
            "filename": f"{i}.jpg",
            "description": i,
            "custom_metadata": "",
            "url": f"/static/processed/{i}.png",
            "thumbnail_url": f"/static/processed/{i}.png",
            "processed_url": f"processed/{i}.png",
            "created_at": "2026-01-01T00:00:00",
        }
        for i in ids
    ]


def make_rows(n: int, dim: int, seed: int, device) -> torch.Tensor:
    """(n, dim) unit fp32 rows on ``device``: the store's library."""
    gen = generator(seed, "rows", device)
    rows = torch.randn((n, dim), generator=gen, device=device, dtype=torch.float32)
    return rows / torch.linalg.vector_norm(rows, dim=1, keepdim=True)


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Open-loop due times in [0, seconds): round(rate x seconds) arrivals
    whose gaps are the exponential distribution's mid-quantiles (a Poisson
    process's gaps, the same multiset every seed) in a seeded order,
    scaled to end inside the window."""
    n = max(1, int(round(rate * seconds)))
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) / rate
    gaps = np.random.default_rng(sub_seed(seed, "arrivals")).permutation(gaps)
    times = np.cumsum(gaps)
    return times * (seconds * (1.0 - 0.5 / n) / times[-1])


# -- frames ----------------------------------------------------------------------


def make_frames(sizes: Sequence[Sequence[int]], n: int, seed: int, device, tag: str = "frames") -> List[np.ndarray]:
    """``n`` (H, W, 3) uint8 RGB frames whose (W, H) geometries cycle
    through ``sizes`` in a seeded order (the same multiset every seed).
    Each is a seeded 1/32-scale colour field, bilinearly upsampled, plus
    pixel noise: structure that survives the towers' downsampling, so
    that two frames differ at the models' resolution. Drawn on
    ``device``, returned on the host."""
    order = np.random.default_rng(sub_seed(seed, f"{tag}-sizes")).permutation(
        [tuple(sizes[i % len(sizes)]) for i in range(n)])
    gen = generator(seed, tag, device)
    out = []
    for w, h in order:
        coarse = torch.rand((1, 3, -(-int(h) // 32), -(-int(w) // 32)), generator=gen, device=device) * 255.0
        field = torch.nn.functional.interpolate(coarse, size=(int(h), int(w)), mode="bilinear", align_corners=False)
        noise = torch.randn((1, 3, int(h), int(w)), generator=gen, device=device) * 8.0
        px = (field + noise).clamp_(0.0, 255.0).round_().to(torch.uint8)
        out.append(px[0].permute(1, 2, 0).contiguous().cpu().numpy())
    return out

