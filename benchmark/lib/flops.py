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
