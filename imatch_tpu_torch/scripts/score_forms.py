"""Which form of an fp32 row-query dot gives a row the same bits whatever
rows and queries are scored beside it:

    python -m imatch_tpu_torch.scripts.score_forms [--device cpu]

Three forms score the first 48 of R seeded unit rows of width 768 against
c seeded unit queries, for R from 48 to 65536 and c of 1, 2, 5 and 16:
``torch.bmm`` (index/search.py's phase-2 ranking), an elementwise product
summed over D (``search.final_topk``) and a float64 ``bmm`` rounded to
fp32. For each form and (c, R): whether the 48 rows' scores equal that
form's at c = 16, R = 10240 (phase 2's shape at k 16) bit for bit. Then
each form's CUDA-event ms at one query over 1004 x 512 rows (phase 2 at
k 1000). The engines' final scores must not depend on the batch: the
``sharded`` engine scores a row in a shard's batch, the IVF probe in its
survivors', ``tilemax`` in the whole corpus's. Prints one JSON line with
the card's name and power limit (no timings on the CPU).
"""

from __future__ import annotations

import argparse
import json

import torch

from imatch_tpu_torch.device import resolve_device
from imatch_tpu_torch.scripts._common import card, cuda_ms, unit_rows

DIM = 768
ROWS = 48  # the rows every shape scores first
SHAPES_C = (16, 1, 2, 5)
SHAPES_R = (10240, 48, 64, 100, 128, 512, 1024, 2048, 4096, 8192, 16384, 65536)


def bmm(rows, q):
    return torch.bmm(rows, q[:, :, None])[:, :, 0]


def mul_sum(rows, q):
    return (rows * q[:, None, :]).sum(-1)


def f64(rows, q):
    return torch.bmm(rows.double(), q.double()[:, :, None])[:, :, 0].float()


FORMS = {"bmm": bmm, "mul_sum": mul_sum, "f64_bmm": f64}


def main(device=None) -> dict:
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    base = unit_rows(g, (max(SHAPES_R), DIM), dev)
    qs = unit_rows(g, (max(SHAPES_C), DIM), dev)
    out = {"card": card(dev), "dim": DIM, "rows_compared": ROWS, "equal_to_c16_r10240": {}}
    for name, fn in FORMS.items():
        ref, res = None, {}
        for c in SHAPES_C:
            for r in SHAPES_R:
                s = fn(base[:r][None].expand(c, r, DIM).contiguous(), qs[:c])[:, :ROWS]
                ref = s if ref is None else ref
                res[f"c{c}_r{r}"] = bool(torch.equal(s, ref[:c]))
        out["equal_to_c16_r10240"][name] = res
    if dev.type == "cuda":
        rows = unit_rows(g, (1004 * 512, DIM), dev)[None]
        out["ms_one_query_514048_rows"] = {
            name: cuda_ms(lambda fn=fn: fn(rows, qs[:1]), 10) for name, fn in FORMS.items()
        }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    main(ap.parse_args().device)
