"""Experiment: K5, the int4 tile-max kernel, on the card.

Port of ``scripts/exp_int4_kernel.py``, the only caller of its Pallas
kernel. A 4-bit capacity tier would store each corpus row as int4 codes
nibble-packed in halves (byte b holds feature b low and feature b + 256
high, so the unpack needs no interleave), with an (8, N) bf16 side array
of per-row scale and validity, and select candidate tiles from 4-bit tile
maxima before an exact fp32 rescore. Three parts, one JSON line:

1. correctness: K5 against its plain PyTorch version (``int4_tile_max_plain``)
   at 4096 x 512 with a tombstone every 97th row, tile 512, atol 1e-5 (fp32
   sums in another order);
2. speed at 2^20 x 512, tile_n 512 / 1024 / 2048, by CUDA events, beside
   the packed megabytes as stored (codes and the whole side array) and the
   floor of one read of what the kernel reads (codes, side rows 0 and 1)
   at the H100's 3.35 TB/s;
3. selection fidelity: recall@10 of int4 tile selection + fp32 rescore
   against the fp32 oracle on random and clustered corpora of 2^17 rows,
   for candidate-tile margins 4, 16, 32 and 64.

Run on the card: ``python -m imatch_tpu_torch.scripts.exp_int4_kernel``.
``--device cpu`` runs part 1 only, on the plain version, as the JAX script
does off the TPU. Every time is the card's, named in the ``card`` key.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from imatch_tpu_torch.device import resolve_device
from imatch_tpu_torch.ops.kernels.int4_topk import (
    int4_tile_max,
    int4_tile_max_plain,
    pack_int4,
)
from imatch_tpu_torch.scripts._common import (
    HBM_BYTES_PER_S,
    StreamDict,
    card,
    cuda_ms,
    unit_rows,
)

N = 1 << 20
D = 512
HALF = D // 2
QP = 8
N_CHECK = 4096
N_RECALL = 1 << 17  # keeps the fp32 oracle small
TILES = (512, 1024, 2048)
MARGINS = (4, 16, 32, 64)


def correctness(out: dict, device) -> None:
    g = torch.Generator(device=device).manual_seed(0)
    cs = unit_rows(g, (N_CHECK, D), device)
    vs = torch.arange(N_CHECK, device=device) % 97 != 0  # some tombstones
    packed, side, _, _ = pack_int4(cs, vs)
    qbf = unit_rows(g, (QP, D), device).bfloat16()
    got = int4_tile_max(qbf, packed, side, 512)
    want = int4_tile_max_plain(qbf, packed, side, 512)
    out["kernel_matches_plain_torch"] = bool(torch.allclose(got, want, rtol=0, atol=1e-5))
    out["kernel_max_abs_diff"] = float((got - want).abs().max())


def speed(out: dict, device, iters: int) -> None:
    g = torch.Generator(device=device).manual_seed(0)
    c = unit_rows(g, (N, D), device)
    packed, side, _, _ = pack_int4(c, torch.ones((N,), dtype=torch.bool, device=device))
    del c
    qbf = unit_rows(g, (QP, D), device).bfloat16()
    for tile_n in TILES:
        out[f"int4_kernel_t{tile_n}_ms"] = cuda_ms(
            lambda: int4_tile_max(qbf, packed, side, tile_n), iters
        )
    read_bytes = N * HALF + 2 * N * 2  # codes + side rows 0 (scale) and 1 (valid)
    out["hbm_floor_packed_ms"] = read_bytes / HBM_BYTES_PER_S * 1e3
    out["packed_mb"] = (N * HALF + 8 * N * 2) / 1e6  # codes + side array


def recall_experiment(out, kind, corpus, queries, tile_n=512, k=10) -> None:
    """Tile selection from int4 maxima + exact fp32 rescore of the selected
    tiles, against the fp32 oracle; the margin sweep shows how many extra
    candidate tiles 4-bit selection needs."""
    n = corpus.shape[0]
    n_tiles = n // tile_n
    valid = torch.ones((n,), dtype=torch.bool, device=corpus.device)
    packed, side, _, _ = pack_int4(corpus, valid)
    tm = int4_tile_max(queries.bfloat16(), packed, side, tile_n)
    s_exact = queries @ corpus.T
    oracle = torch.sort(s_exact, dim=1, descending=True, stable=True).indices[:, :k]
    col = torch.arange(tile_n, device=corpus.device)
    for margin in MARGINS:
        kt = min(k + margin, n_tiles)
        hits = 0
        for qi in range(queries.shape[0]):
            tiles = torch.sort(tm[qi], descending=True, stable=True).indices[:kt]
            rows = (tiles[:, None] * tile_n + col).reshape(-1)
            es = corpus[rows] @ queries[qi]
            top = rows[torch.sort(es, descending=True, stable=True).indices[:k]]
            hits += len(set(top.tolist()) & set(oracle[qi].tolist()))
        out[f"recall@{k}_{kind}_m{margin}"] = hits / (queries.shape[0] * k)


def fidelity(out: dict, device) -> None:
    g = torch.Generator(device=device).manual_seed(1)
    # random corpus: near-uniform scores, the adversarial case
    cr = unit_rows(g, (N_RECALL, D), device)
    qr = unit_rows(g, (QP, D), device)
    recall_experiment(out, "random", cr, qr)
    del cr
    # clustered: rows around 256 centres, queries perturbed rows
    cents = torch.randn((256, D), generator=g, device=device)
    assign = torch.randint(0, 256, (N_RECALL,), generator=g, device=device)
    cc = cents[assign] + 0.35 * torch.randn((N_RECALL, D), generator=g, device=device)
    cc = cc / cc.norm(dim=1, keepdim=True)
    qc = cc[:QP] + 0.05 * torch.randn((QP, D), generator=g, device=device)
    qc = qc / qc.norm(dim=1, keepdim=True)
    recall_experiment(out, "clustered", cc, qc)


def main(device=None, iters: int = 30) -> dict:
    """Run the experiment and print its JSON line: on the card every part,
    on the CPU (``device="cpu"``) the correctness part only."""
    device = resolve_device(device)
    out = StreamDict({"n": N, "d": D, "iters": iters, "card": card(device)})
    correctness(out, device)
    if device.type == "cuda":
        speed(out, device, iters)
        fidelity(out, device)
    out = dict(out)
    print(json.dumps(out), flush=True)
    return out


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--iters", type=int, default=int(os.environ.get("ITERS", "30")))
    args = ap.parse_args(argv)
    main(args.device, args.iters)


if __name__ == "__main__":
    _cli()
