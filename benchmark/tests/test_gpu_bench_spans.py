"""The readers of the program's search-path spans, on the CPU: a traced
run of the tiny search cell, with BENCHMARK.json's five span metrics
added for it, reports each as a positive number, and the store's copy of
its results to the host lies inside the store query."""

import json

import pytest

from gpu_bench_support import REPO, run, tiny_root

SPAN_METRICS = ("tower_wait_ms.search", "tokenize_ms.search", "store_fetch_ms.search",
                "store_rows_ms.search", "result_rows_ms.search")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = [dict(m, workloads=["tiny-search"]) for m in spec["per_layer"] if m["name"] in SPAN_METRICS]
    assert [m["name"] for m in entries] == list(SPAN_METRICS)
    root = tiny_root(tmp_path_factory.mktemp("bench"), extra_entries={"per_layer": entries})
    ctx, out = run(root, "tiny-search", seconds=0.5, trace=True)
    assert out["correct"], out["checks"]
    return out["metrics"]


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metric_reports_a_positive_number(traced, name):
    assert traced[name]["unit"] == "ms" and traced[name]["value"] > 0


def test_store_fetch_within_store_query(traced):
    assert traced["store_fetch_ms.search"]["value"] <= traced["store_query_ms.search"]["value"]
