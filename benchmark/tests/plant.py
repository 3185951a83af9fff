"""Run a cell several times in one process, with the program as it is,
with the control in its place, or with one fault planted under its timed
path, and print one JSON line a run: the numbers compared beside their
limits, and the end-to-end metrics. The readings each limit is set from
come from these runs, made on a card at the cell's own size:

    python3 benchmark/tests/plant.py --workload <cell> --seeds 11,12,13 --seconds 20
    python3 benchmark/tests/plant.py --workload <cell> --seeds 11,12,13 --seconds 20 --control
    python3 benchmark/tests/plant.py --workload <cell> --seeds 11,12,13 --seconds 20 --fault caption-token-altered

``--rates`` instead runs one seed at each offered rate (the sweep that
finds a mix's knee): besides, each line gives the 95th percentile, how
many requests were still unanswered when the window closed, and of them
those due more than 2 s before it (a backlog). One
process pays the imports and the kernel build once; no run here is
traced, since a profiler session slows every later launch in its
process.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None, help="one name of gpu_bench_faults.CAPTION_FAULTS, or several, comma-separated")
    p.add_argument("--rates", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=str(ROOT), help="the checkout whose BENCHMARK.json names the cell")
    args = p.parse_args(argv)
    import pytest

    from benchmark import run as bench_run
    from benchmark.lib import stats
    from gpu_bench_faults import CAPTION_FAULTS

    bench_run._environment()
    seeds = [int(s) for s in args.seeds.split(",")]
    rates = [float(r) for r in args.rates.split(",")] if args.rates else [None]
    faults = args.fault.split(",") if args.fault else [None]
    for fault, rate in ((f, r) for f in faults for r in rates):
        for seed in seeds if rate is None else seeds[:1]:
            with pytest.MonkeyPatch.context() as mp:
                if fault:
                    CAPTION_FAULTS[fault](mp)
                t = time.time()
                spec, ctx = bench_run.run_cell(Path(args.root), args.workload, seed, args.seconds, False, args.device,
                                               control=args.control, rate=rate, t_proc=t)
            out = bench_run.result_line(spec, ctx)
            line = {"seed": seed, "rate": ctx.rate, "fault": fault, "control": args.control,
                    "correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
                    "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                    "checks": {k: v["value"] for k, v in out["checks"].items()},
                    "limits": {k: v["limit"] for k, v in out["checks"].items()},
                    "run_s": time.time() - t, "memory_peak_bytes": out["device"]["memory_peak_bytes"],
                    "notes": {k: v for k, v in ctx.notes.items() if not k.startswith("setup_") or k == "setup_warm_requests_s"}}
            if ctx.requests:
                lat = stats.open_loop_latencies([r["due"] for r in ctx.requests],
                                                [r["done"] if r["ok"] else None for r in ctx.requests],
                                                ctx.notes["wait_end_s"])
                line["p95_ms"] = stats.percentile(lat, 95) * 1e3
                line["unanswered_at_close"] = sum(1 for r in ctx.requests if r["done"] is None or r["done"] > ctx.seconds)
                line["backlog_2s"] = sum(1 for r in ctx.requests if r["due"] < ctx.seconds - 2.0
                                         and (r["done"] is None or r["done"] > ctx.seconds))
            t_ = ctx.program_metrics.get("timings", {})
            line["span_ms"] = {k: v["total_s"] / v["count"] * 1e3 for k, v in t_.items() if v.get("count")}
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
