"""A checkout of the benchmark at toy sizes for the CPU tests: the real
harness and metric readers, a tiny CLIP configuration (and one with a tiny
captioner), small mixes and a BENCHMARK.json of one cell each (``data/``), written into a
temporary root."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"


def tiny_root(tmp: Path, extra_entries: dict = None) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for f in DATA.glob("tiny-*.json"):
        (root / "benchmark" / "configs" / f.name).write_text(f.read_text())
    for f in (DATA / "traffic").glob("*.json"):
        (root / "benchmark" / "traffic" / f.name).write_text(f.read_text())
    spec = json.loads((DATA / "BENCHMARK.json").read_text())
    for key, items in (extra_entries or {}).items():
        spec[key].extend(items)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def run(root: Path, workload: str, seed: int = 7, seconds: float = 0.3, trace: bool = False, control: bool = False):
    import sys
    import time

    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from benchmark import run as bench_run

    spec, ctx = bench_run.run_cell(root, workload, seed, seconds, trace, "cpu", control=control, t_proc=time.time())
    return ctx, bench_run.result_line(spec, ctx)
