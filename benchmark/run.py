"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads BENCHMARK.json at the checkout's root, finds the cell's
configuration and traffic mix by name, makes every input and weight from
the seed on the card, warms the cell's shapes, measures for ``--seconds``
and checks what the timed path produced against the plain references
(``benchmark/reference``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared, beside its limit. Without a CUDA device, or with fewer
than the cell asks for, it prints no result and exits 2.

``--control 1`` runs the cell's control in the program's place (the
references in W8A8 int8); it has to come out not correct. ``--rate``
overrides a search mix's fixed rate; it exists for the sweep that found
that rate. The check of each change runs neither.
"""

import time

T_PROC = time.time()


def _process_start() -> float:
    """The wall time this process started (Linux), else the first line's."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        import os

        return min(T_PROC, boot + ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, StopIteration):
        return T_PROC

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "imatch_tpu"}


def _environment() -> None:
    """Kernel caches inside the checkout at fixed paths; no library may
    load JAX by itself."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20,
        ).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def result_line(spec, ctx) -> dict:
    import torch

    from benchmark.lib import peaks, trace
    from benchmark.lib.spec import read_metrics

    on_card = ctx.device.type == "cuda"
    device = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(ctx.device) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": ctx.memory_peak_bytes,
        "power_limit_w": _power_limit_w() if on_card else None,
        "peak_bf16_flops": peaks.BF16_FLOPS,
        "peak_bytes_per_s": peaks.HBM_BYTES_PER_S,
    }
    out = {
        "correct": ctx.correct,
        "attempted": ctx.attempted,
        "failed": ctx.failed,
        "metrics": read_metrics(spec, ctx.workload["name"], ctx.trace, ctx),
        "device": device,
    }
    if ctx.trace and ctx.trace_summary is not None:
        device["busy_s"] = ctx.trace_summary["busy_s"]
        device["window_s"] = ctx.trace_summary["window_s"]
        out["breakdown"] = trace.breakdown(ctx.trace_summary)
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in ctx.checks.items()}
    return out


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device: str,
             control: bool = False, rate=None, t_proc: float = None):
    """One run of ``workload`` on ``device``: (spec, filled Context). The
    command line asks for a card; tests call this on the CPU."""
    from benchmark.lib import cell, program
    from benchmark.lib.spec import Spec

    spec = Spec(root)
    wl = spec.workload(workload)
    cfg = spec.config(wl["config"])
    mix = spec.mix(wl["traffic"])
    program.settle_environment(cfg, spec.bench_dir)
    ctx = cell.Context(wl, cfg, mix, seed, seconds, trace, device, _process_start() if t_proc is None else t_proc,
                       control=control, rate=rate, bench_dir=spec.bench_dir)
    return spec, cell.run(ctx)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--rate", type=float, default=None)
    args = p.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    from benchmark.lib.spec import Spec

    chips = Spec(ROOT).workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    spec, ctx = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                         control=bool(args.control), rate=args.rate)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if loaded:
        print(f"benchmark: the process loaded {', '.join(loaded[:8])}: no result", file=sys.stderr)
        return 3
    out = result_line(spec, ctx)
    for k, v in ctx.notes.items():
        print(f"note {k} {v!r}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
