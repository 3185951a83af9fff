"""One run of one cell: what a driver fills in and the metric readers
read, and the run itself."""

from __future__ import annotations

import gc
import importlib
import time
from typing import Dict, Optional, Tuple

import torch


class Context:
    """A run's inputs and everything measured in it. Drivers fill the
    measured fields; ``metrics/<name>.py`` readers read them."""

    def __init__(self, workload: dict, cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
                 device, t_proc: float, control: bool = False, rate: Optional[float] = None, bench_dir=None):
        from . import program

        self.workload, self.cfg, self.mix = workload, cfg, mix
        self.bench_dir = program.BENCH_DIR if bench_dir is None else bench_dir  # where captioners/ lies
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.t_proc, self.control = t_proc, control
        self.rate = rate if rate is not None else mix.get("rate")
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.t0: Optional[float] = None  # host perf_counter at the window's start
        self.texts: list = []  # search: each request's texts (caption search: the text its tower embedded)
        self.captions: dict = {}  # caption search: each request's generated-token count
        self.attempted = 0
        self.failed = 0
        self.requests: list = []  # search: one record a request due in the window
        self.program_metrics: Dict = {}  # the program's METRICS over the window
        self.trace_summary: Optional[dict] = None  # lib/trace.summarize over the stretch
        self.stretch: Optional[Tuple[float, float]] = None  # host perf_counter bounds of the stretch
        self.memory_peak_bytes = 0
        self.store_rows = 0
        self.checks: Dict[str, Tuple[float, float]] = {}  # name -> (value, limit)
        self.notes: Dict[str, float] = {}  # further readings printed on stderr

    def mark(self, stage: str) -> None:
        """Note the set-up's seconds so far at the end of ``stage``."""
        self.notes[f"setup_{stage}_s"] = time.time() - self.t_proc

    def start_window(self) -> float:
        """Mark the window's start: the end of set-up. Returns the host
        perf_counter there."""
        self.t0 = now()
        self.setup_s = time.time() - self.t_proc
        return self.t0

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(v <= lim for v, lim in self.checks.values())


def now() -> float:
    return time.perf_counter()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free_device(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def peak_memory(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if torch.device(device).type == "cuda" else 0


def run(ctx: Context) -> Context:
    """Run the cell through ``drivers/<driver>.py``, the module the mix's
    ``driver`` names."""
    driver = importlib.import_module(f"benchmark.drivers.{ctx.mix['driver']}")
    return driver.run(ctx)
