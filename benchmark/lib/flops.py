"""Operations and bytes from shapes: the towers' useful work and each
kernel's least traffic. A multiply-add counts as two operations. A
kernel's bytes count each input read once and each output written once,
whatever the kernel reads again; a roofline share is the least time
these give, max(operations / peak, bytes / bandwidth), over the measured
device time."""

from __future__ import annotations

from . import peaks


def _layer_flops(n: int, d: int, inter: int, attn_pairs: float) -> float:
    """One pre-LN encoder layer over n positions: q, k, v and out
    projections (8 n d^2), the MLP (4 n d inter), and scores plus the
    weighted sum over ``attn_pairs`` (query, key) pairs (4 d a pair)."""
    return 8.0 * n * d * d + 4.0 * n * d * inter + 4.0 * d * attn_pairs


def text_flops(cfg: dict, n_tokens: int) -> float:
    """The useful work of one text of ``n_tokens`` ids through its eos:
    the causal layers over those positions alone (the eos-padding beyond
    them changes nothing that is read) and the projection of the pooled
    position."""
    t = cfg["text_config"]
    d, n = t["hidden_size"], n_tokens
    pairs = n * (n + 1) / 2.0
    layers = t["num_hidden_layers"] * _layer_flops(n, d, t["intermediate_size"], pairs)
    return layers + 2.0 * d * cfg["projection_dim"]


def scoring_flops(rows: int, dim: int, queries: int) -> float:
    """Scoring ``queries`` against ``rows`` of width ``dim``: 2 N D Q."""
    return 2.0 * rows * dim * queries


def k1_launch(rows: int, dim: int, queries: int, tile_n: int, elt: int = 2):
    """(operations, bytes) of one tile-max launch: the (rows, dim) scoring
    corpus, its one-byte validity mask and the queries read once, the
    (queries, rows / tile_n) fp32 tile maxima written once."""
    ops = scoring_flops(rows, dim, queries)
    nbytes = rows * dim * elt + rows + queries * dim * elt + queries * (rows // tile_n) * 4
    return ops, float(nbytes)


def bound_s(ops: float, nbytes: float, flops: float = peaks.BF16_FLOPS) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / flops, nbytes / peaks.HBM_BYTES_PER_S)


def image_flops(cfg: dict) -> float:
    """One image through the CLIP image tower: the patch convolution, the
    encoder over the class token and the patches (every pair), the
    projection of the class token."""
    v = cfg["vision_config"]
    d, p = v["hidden_size"], v["patch_size"]
    n = (v["image_size"] // p) ** 2 + 1
    layers = v["num_hidden_layers"] * _layer_flops(n, d, v["intermediate_size"], float(n * n))
    return 2.0 * (n - 1) * 3 * p * p * d + layers + 2.0 * d * cfg["projection_dim"]


def md_encode_flops(cc: dict) -> float:
    """One image through a Moondream captioner's vision tower and projector
    (``captioners/moondream.py``'s block): the patch convolution, the
    encoder over every patch pair, the projector MLP on each patch."""
    v = cc["vision_config"]
    d, p = v["hidden_size"], v["patch_size"]
    n = (v["image_size"] // p) ** 2
    layers = v["num_hidden_layers"] * _layer_flops(n, d, v["intermediate_size"], float(n * n))
    proj = 2.0 * n * (d * cc["projector_hidden_size"] + cc["projector_hidden_size"] * cc["text_config"]["hidden_size"])
    return 2.0 * n * 3 * p * p * d + layers + proj


def md_decoder_flops(cc: dict, start: int, n: int, last: int = 1) -> float:
    """``n`` new positions from position ``start`` through a Phi decoder,
    each attending to itself and every earlier position, and the LM head
    at the ``last`` of them (a prefill reads one, a decode step its one)."""
    t = cc["text_config"]
    d = t["hidden_size"]
    pairs = n * start + n * (n + 1) / 2.0
    layers = t["num_hidden_layers"] * _layer_flops(n, d, t["intermediate_size"], pairs)
    return layers + 2.0 * d * t["vocab_size"] * last


def k2_launch(batch: int, heads: int, seq: int, head_dim: int, causal: bool, elt: int = 2):
    """(operations, bytes) of one flash-attention launch: scores and the
    weighted sum over the (query, key) pairs it must compute (every pair,
    or those on and below the diagonal), q, k and v read once and the
    output written once."""
    pairs = seq * (seq + 1) / 2.0 if causal else float(seq * seq)
    ops = 4.0 * batch * heads * head_dim * pairs
    return ops, float(4 * batch * heads * seq * head_dim * elt)
