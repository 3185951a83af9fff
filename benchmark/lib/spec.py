"""Find a cell's files by the names in BENCHMARK.json.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's file is the one its ``configs`` entry gives;
the mix is ``traffic/<mix>.json``; each metric is read by
``metrics/<metric>.py``. A later change adds a cell, a configuration, a
mix or a metric by adding files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench_dir = self.root / "benchmark"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                cfg = json.loads((self.root / c["file"]).read_text())
                cfg["name"] = name
                return cfg
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        mix = json.loads((self.bench_dir / "traffic" / f"{name}.json").read_text())
        mix["name"] = name
        return mix

    def metrics(self, workload: str, trace: bool) -> List[dict]:
        """The metrics a run of ``workload`` reports: the end-to-end ones
        with ``--trace 0``, the per-layer ones with ``--trace 1``. A metric
        with a ``workloads`` key belongs to the cells it lists; a
        per-layer metric without one belongs to every cell that reports
        the end-to-end metric it moves."""
        e2e = [m for m in self.data["end_to_end"] if workload in m.get("workloads", [workload])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [
            m
            for m in self.data["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)
        ]

    def reader(self, metric: str) -> Callable:
        """``read(ctx)`` of ``metrics/<metric>.py``: a number, or None
        where the run has nothing to read."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def read_metrics(spec: Spec, workload: str, trace: bool, ctx) -> Dict[str, dict]:
    out = {}
    for m in spec.metrics(workload, trace):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
