"""Experiment: K6, tile max over a transposed corpus, beside K1 on the card.

Port of ``scripts/exp_pallas_search.py``, the only caller of its Pallas
kernel ``_tile_max_kernel_T``. The TPU question was whether phase 1 of the
exact search pays a relayout when the corpus enters the matrix unit
row-major, and whether padding the penalty feature to 528 instead of 640
columns helps (the script's hypotheses A-C). On the card the layout is a
question of the load pattern: K1 streams corpus rows, K6 streams feature
rows with neighbouring threads on neighbouring columns. Parts, one JSON
line, every time by CUDA events on the card named in the ``card`` key:

- the corpus: 2^20 unit rows of 512, about 1% invalid, bf16, the penalty
  feature at column 512 (0 valid, -4 invalid; the query has 1 there),
  padded to 640 columns as the Pallas kernel needs;
- K1 row-major at Dp 640, tile_n 1024 / 2048 / 4096 (every row marked
  valid in K1's mask, since the penalty column carries validity);
- K6 at Dp 640 (tiles 1024 / 2048 / 4096) and 528 (2048 / 4096):
  ``transposed_matches`` holds K6 at 640 to K1 within atol 1e-6, and
  ``transposed_528_matches`` within 2e-3 (the script's reason: the 528-wide
  contraction sums the same products in another order);
- the plain-PyTorch counterparts of the script's XLA variants, one
  ``torch.matmul`` + ``amax`` on each layout (bf16 products, bf16 output);
- the int8 stream through ``torch._int_mm`` (its first dimension must
  exceed 16, so the 8 queries are padded to 32 rows: the ``q32pad`` keys),
  int8 codes multiplied as bf16, and int4 storage, which PyTorch cannot
  multiply (``int4_error``);
- the engine A/B through the port's own ``prepare_device_corpus`` and
  ``tilemax_topk``: bf16 and int8 scoring at tile 512, and int8 codes
  scored as bf16 (phase 1 only);
- floors of one read of each corpus at the H100's 3.35 TB/s.

Run on the card: ``python -m imatch_tpu_torch.scripts.exp_pallas_search``.
``--device cpu --rows 16384`` runs the K1/K6 agreement checks at a small
size on the plain versions, with no timings.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from imatch_tpu_torch.device import resolve_device
from imatch_tpu_torch.index.search import prepare_device_corpus, tilemax_topk
from imatch_tpu_torch.ops.kernels.topk import NEG_INF, tile_max
from imatch_tpu_torch.ops.kernels.topk_t import tile_max_t
from imatch_tpu_torch.scripts._common import (
    HBM_BYTES_PER_S,
    StreamDict,
    card,
    cuda_ms,
    unit_rows,
)

N = 1 << 20  # pow2, so every tile_n of the sweep divides it
D = 512
QP = 8  # padded query rows
INVALID_PENALTY = -4.0  # added to invalid rows' scores through the penalty feature
INT_MM_ROWS = 32  # torch._int_mm on CUDA takes a first dimension above 16


def make_data(n: int, d_pad: int, device, seed: int = 0):
    """Row-major scoring (n, d_pad) bf16 with the penalty at column D, and
    padded queries (QP, d_pad) bf16 with q[:, D] = 1 (only row 0 is a real
    query). The same seed gives the same rows at any d_pad."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = unit_rows(g, (n, D), device)
    valid = torch.rand((n,), generator=g, device=device) > 0.01
    scoring = torch.zeros((n, d_pad), dtype=torch.bfloat16, device=device)
    scoring[:, :D] = c.to(torch.bfloat16)
    del c
    scoring[:, D] = torch.where(valid, 0.0, INVALID_PENALTY).to(torch.bfloat16)
    qf = torch.zeros((QP, d_pad), device=device)
    qf[:1, :D] = unit_rows(g, (1, D), device)
    qf[:, D] = 1.0
    return scoring, qf.to(torch.bfloat16)


def _rowmajor(qs, scoring, tile_n):
    """K1 on the row-major corpus: validity is in the penalty column, so
    the mask marks every row valid."""
    ones = torch.ones((scoring.shape[0],), dtype=torch.bool, device=scoring.device)
    return lambda: tile_max(qs, scoring, ones, tile_n)


def _matmul_amax(qs, rhs, tile_n):
    """One torch.matmul + amax; ``rhs`` is (Dp, N): the transposed corpus,
    or a transposed view of the row-major one."""
    n = rhs.shape[1]
    return lambda: torch.matmul(qs, rhs).view(qs.shape[0], n // tile_n, tile_n).amax(2)


def layouts(out: dict, device, n: int, iters: int, timed: bool) -> None:
    """K1 row-major against K6 transposed, at Dp 640 and 528."""
    scoring640, qs640 = make_data(n, 640, device)
    tiles = [t for t in (1024, 2048, 4096) if n % t == 0]
    base = None
    for tile_n in tiles:
        f = _rowmajor(qs640, scoring640, tile_n)
        if timed:
            out[f"rowmajor_640_t{tile_n}_ms"] = cuda_ms(f, iters)
        if tile_n == 2048:
            base = f()[0]
    scoring_t640 = scoring640.T.contiguous()
    for tile_n in tiles:
        f = lambda: tile_max_t(qs640, scoring_t640, tile_n)  # noqa: E731
        if timed:
            out[f"transposed_640_t{tile_n}_ms"] = cuda_ms(f, iters)
        if tile_n == 2048:
            got = f()[0]
            out["transposed_matches"] = bool(torch.allclose(got, base, rtol=0, atol=1e-6))
            out["transposed_max_abs_diff"] = float((got - base).abs().max())
    del scoring_t640

    scoring528, qs528 = make_data(n, 528, device)
    scoring_t528 = scoring528.T.contiguous()
    del scoring528
    for tile_n in (t for t in (2048, 4096) if n % t == 0):
        f = lambda: tile_max_t(qs528, scoring_t528, tile_n)  # noqa: E731
        if timed:
            out[f"transposed_528_t{tile_n}_ms"] = cuda_ms(f, iters)
        if tile_n == 2048:
            got = f()[0]
            # atol 2e-3, not 1e-6: the 528-wide contraction sums the same
            # bf16 products with other zero padding and in another order
            # than the 640-wide base, so the fp32 sums round differently;
            # the actual gap is recorded beside it
            out["transposed_528_matches"] = bool(torch.allclose(got, base, rtol=0, atol=2e-3))
            out["transposed_528_max_abs_diff"] = float((got - base).abs().max())
    del scoring_t528
    if not timed:
        return

    # plain PyTorch on each layout: is the gap the layout or the kernel?
    for tile_n in (512, 2048):
        out[f"torch_matmul_amax_rowmajor_640_t{tile_n}_ms"] = cuda_ms(
            _matmul_amax(qs640, scoring640.T, tile_n), iters
        )
    scoring_t640 = scoring640.T.contiguous()
    for tile_n in (512, 2048):
        f = _matmul_amax(qs640, scoring_t640, tile_n)
        out[f"torch_matmul_amax_transposed_640_t{tile_n}_ms"] = cuda_ms(f, iters)
        if tile_n == 2048:
            got = f()[0].float()
            out["torch_matmul_transposed_matches"] = bool(
                torch.allclose(got, base, rtol=0, atol=2e-2)
            )
    del scoring_t640
    low_precision(out, scoring640, qs640, iters)
    engine_ab(out, scoring640, qs640, iters)
    out["hbm_floor_640_ms"] = n * 640 * 2 / HBM_BYTES_PER_S * 1e3
    out["hbm_floor_528_ms"] = n * 528 * 2 / HBM_BYTES_PER_S * 1e3


def low_precision(out: dict, scoring640, qs640, iters: int) -> None:
    """The int8 stream, int8 codes multiplied as bf16, and int4 storage."""
    n = scoring640.shape[0]
    ci8 = torch.clamp(torch.round(scoring640[:, :D].float() * 127.0), -127, 127).to(torch.int8)
    qi8 = torch.zeros((INT_MM_ROWS, D), dtype=torch.int8, device=ci8.device)
    qi8[:QP] = torch.clamp(torch.round(qs640[:, :D].float() * 127.0), -127, 127).to(torch.int8)

    def int_mm(rhs, tile_n):
        return lambda: torch._int_mm(qi8, rhs)[:QP].view(QP, n // tile_n, tile_n).amax(2)

    ci8t = ci8.T.contiguous()
    for layout, rhs in (("rowmajor", ci8.T), ("transposed", ci8t)):
        for tile_n in (512, 2048):
            key = f"torch_int_mm_{layout}_q{INT_MM_ROWS}pad_t{tile_n}_ms"
            try:
                out[key] = cuda_ms(int_mm(rhs, tile_n), iters)
            except RuntimeError as e:  # the layout or shape _int_mm refuses
                out[key.replace("_ms", "_error")] = str(e)[:160]
    del ci8t
    out["hbm_floor_int8_512_ms"] = n * 512 / HBM_BYTES_PER_S * 1e3

    # int8 storage, bf16 products with the per-row dequant scale
    qbf = qs640[:, :D].contiguous()
    scale1 = torch.ones((n,), device=ci8.device)

    def int8_as_bf16(codes, tile_n):
        def f():
            s = torch.matmul(qbf, codes.to(torch.bfloat16).T).float() * scale1[None, :]
            return s.view(QP, n // tile_n, tile_n).amax(2)

        return f

    for tile_n in (512, 2048):
        out[f"torch_int8_as_bf16_t{tile_n}_ms"] = cuda_ms(int8_as_bf16(ci8, tile_n), iters)

    # int4 storage: PyTorch has no int4 tensor a product accepts
    try:
        ci4 = torch.clamp(torch.round(scoring640[:, :D].float() * 7.0), -7, 7).to(torch.int4)
        for tile_n in (512, 2048):
            out[f"torch_int4_as_bf16_t{tile_n}_ms"] = cuda_ms(int8_as_bf16(ci4, tile_n), iters)
        out["hbm_floor_int4_512_ms"] = n * 256 / HBM_BYTES_PER_S * 1e3
    except (AttributeError, RuntimeError, TypeError) as e:
        out["int4_error"] = f"{type(e).__name__}: {e}"[:160]


def engine_ab(out: dict, scoring640, qs640, iters: int) -> None:
    """The port's engine on the same rows: bf16 and int8 scoring end to
    end (phase 1 on K1 and its int8 variant, phase 2 in PyTorch), and int8
    codes scored as bf16 for phase 1 only."""
    c32 = scoring640[:, :D].float()
    valid = scoring640[:, D] == 0
    q1 = qs640[:1, :D].float()
    dc = prepare_device_corpus(c32, valid, tile_n=512, device=c32.device)
    out["tilemax_full_ms"] = cuda_ms(lambda: tilemax_topk(q1, dc, k=10), iters)
    del dc
    dc8 = prepare_device_corpus(
        c32, valid, tile_n=512, score_dtype=torch.int8, margin=16, device=c32.device
    )
    del c32
    out["tilemax_int8_full_ms"] = cuda_ms(lambda: tilemax_topk(q1, dc8, k=16), iters)
    n_tiles = dc8.scoring.shape[0] // 512

    def int8_as_bf16_phase1():
        s = torch.matmul(q1.to(torch.bfloat16), dc8.scoring.to(torch.bfloat16).T).float()
        s = torch.where(dc8.valid[None, :], s * dc8.scale[None, :], NEG_INF)
        tmax = s.view(1, n_tiles, 512).amax(2)
        return torch.topk(tmax, min(16 + 16, n_tiles), dim=1).indices

    out["tilemax_int8_as_bf16_phase1_ms"] = cuda_ms(int8_as_bf16_phase1, iters)


def main(device=None, iters: int = 30, rows: int = N) -> dict:
    """Run the experiment and print its JSON line. On the CPU only the
    K1/K6 agreement checks run (plain versions, no timings)."""
    device = resolve_device(device)
    out = StreamDict({"n": rows, "d": D, "iters": iters, "card": card(device)})
    layouts(out, device, rows, iters, timed=device.type == "cuda")
    out = dict(out)
    print(json.dumps(out), flush=True)
    return out


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--iters", type=int, default=int(os.environ.get("ITERS", "30")))
    ap.add_argument("--rows", type=int, default=N, help="corpus rows, a multiple of 4096")
    args = ap.parse_args(argv)
    main(args.device, args.iters, args.rows)


if __name__ == "__main__":
    _cli()
