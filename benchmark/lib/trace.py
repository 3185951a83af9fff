"""The traced stretch: a torch.profiler session over part of a window,
and the reading of its Chrome trace.

The session records the card's kernels and copies (CUPTI) and the host
operators of every thread where PyTorch can. The benchmark's own spans
(``record_function`` names starting ``bench.``) mark its calls into each
layer; ``bench.stretch`` marks the traced stretch itself. ``read`` turns
the trace into: device time by kernel name and by kind of copy,
the union of the device's busy intervals inside the stretch, the part of
the stretch in which some request was in its call (the union of the
``bench.<driver>.request`` spans, on any thread) and the device's busy
time inside that part, the idle gaps labelled by what the host was
doing, and the device time of each kernel by the span that launched it
(the innermost span open on the launching thread when it called the
launch, or the graph launch, that the kernel's correlation id names).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    """Start and stop on one thread. ``stop`` keeps the trace; ``read``
    after the window writes it to a file under TMPDIR, parses it and
    deletes the file."""

    def __init__(self):
        self._prof = None
        self._mark = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        kw = {"activities": acts}
        try:
            from torch._C._profiler import _ExperimentalConfig

            kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        self._prof = profile(**kw)
        self._prof.start()
        self._mark = torch.autograd.profiler.record_function("bench.stretch")
        self._mark.__enter__()

    @property
    def started(self) -> bool:
        return self._prof is not None

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.stop()

    def read(self) -> Optional[dict]:
        if self._prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        self._prof = None
        return summarize(events.get("traceEvents", events) if isinstance(events, dict) else events)


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip().lstrip(":")[:96] or name[:96]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def summarize(events: List[dict]) -> Optional[dict]:
    """The trace's numbers, in seconds. None when the stretch mark is
    missing."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in xs if e.get("name") == "bench.stretch" and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    t0 = float(marks[0]["ts"])
    t1 = t0 + float(marks[0]["dur"])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    kernels: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    copies: Dict[str, float] = defaultdict(float)
    busy = []
    for e in dev:
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        busy.append((a, b))
        if e["cat"] == "kernel":
            kernels[short_name(e["name"])] += (b - a) * 1e-6
            launches[short_name(e["name"])] += 1
        else:
            kind = e["name"].split(" (")[0]
            copies[kind] += (b - a) * 1e-6
    busy = _union(busy)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    # host context of each idle gap: the innermost benchmark span and the
    # innermost host operator open at the gap's middle, on any thread
    spans = [e for e in xs if e.get("cat") == "user_annotation" and e["name"].startswith("bench.") and e["name"] != "bench.stretch"]
    ops = [e for e in xs if e.get("cat") == "cpu_op"]
    in_call = _union([
        (max(float(e["ts"]), t0), min(float(e["ts"]) + float(e["dur"]), t1))
        for e in spans
        if e["name"].endswith(".request") and float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) > t0
    ])
    gaps: Dict[str, float] = defaultdict(float)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    spans_of = list(zip(edges[0::2], edges[1::2]))
    mids = [(a + b) / 2 for a, b in spans_of]
    for (a, b), s_name, o_name in zip(spans_of, _innermost(spans, mids), _innermost(ops, mids)):
        if b > a:
            gaps[f"{s_name} / {o_name}"] += (b - a) * 1e-6
    return {
        "kernel_by_span": _kernel_by_span(xs, dev, t0, t1),
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": busy_s,
        "request_s": sum(b - a for a, b in in_call) * 1e-6,
        "busy_in_request_s": _overlap(busy, in_call) * 1e-6,
        "kernel_s": dict(kernels),
        "kernel_launches": dict(launches),
        "copy_s": dict(copies),
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1]),
    }


def _kernel_by_span(xs: List[dict], dev: List[dict], t0: float, t1: float) -> Dict[str, List[float]]:
    """``"<kernel>|<span>": [seconds, launches]`` of the kernels wholly
    inside the stretch, by the innermost user span (``record_function``:
    the program's and the benchmark's) open on the thread that launched
    each, at the launch ("-" for none)."""
    launch = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e.get("pid"), e.get("tid"), float(e["ts"]))
    by_thread: Dict[tuple, List[Tuple[float, dict]]] = defaultdict(list)
    for e in dev:
        a = float(e["ts"])
        c = e.get("args", {}).get("correlation")
        if e["cat"] == "kernel" and a >= t0 and a + float(e["dur"]) <= t1 and c in launch:
            pid, tid, ts = launch[c]
            by_thread[(pid, tid)].append((ts, e))
    spans: Dict[tuple, List[dict]] = defaultdict(list)
    for e in xs:
        if e.get("cat") == "user_annotation" and e["name"] != "bench.stretch":
            spans[(e.get("pid"), e.get("tid"))].append(e)
    out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for key, launched in by_thread.items():
        launched.sort(key=lambda te: te[0])
        for (_, e), span in zip(launched, _innermost(spans.get(key, []), [ts for ts, _ in launched])):
            acc = out[f"{short_name(e['name'])}|{span}"]
            acc[0] += float(e["dur"]) * 1e-6
            acc[1] += 1
    return dict(out)


def _innermost(events: List[dict], times: List[float]) -> List[str]:
    """For each of the ascending ``times``, the name of the shortest event
    open at that time ("-" for none): one sweep over the events by start."""
    evs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events)
    out, active, j = [], [], 0
    for t in times:
        while j < len(evs) and evs[j][0] <= t:
            active.append(evs[j])
            j += 1
        active = [e for e in active if e[1] >= t]
        out.append(min(active, key=lambda e: e[1] - e[0])[2] if active else "-")
    return out


def kernel_time(summary: dict, name: str) -> Tuple[float, int]:
    """(device seconds, launches) of the kernels whose short name is
    ``name``."""
    return summary["kernel_s"].get(name, 0.0), summary["kernel_launches"].get(name, 0)


def breakdown(summary: dict) -> dict:
    ops = sorted(list(summary["kernel_s"].items()) + list(summary["copy_s"].items()), key=lambda kv: -kv[1])
    return {
        "device_ops": [[k, v] for k, v in ops[:10]],
        "idle_gaps": [[k, v] for k, v in summary["idle_gaps"][:10]],
    }
