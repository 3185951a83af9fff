"""The harness is driven by data: a new cell is a configuration file, a
mix file, a metric reader and entries in BENCHMARK.json, with no other
file edited; every setting of a configuration file reaches the program
or is refused. And no module of the benchmark imports JAX or the JAX
package; the references import nothing of the port."""

import ast
import hashlib
import json
import os
from pathlib import Path

import pytest
import torch

from gpu_bench_support import BENCH, DATA, run, tiny_root

FORBIDDEN = {"jax", "jaxlib", "flax", "imatch_tpu"}


def _tops(path: Path):
    """The top-level name of every module a file imports (the part before
    the first dot, compared whole)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = list(BENCH.rglob("*.py"))
    assert len(files) > 15
    for f in files:
        bad = FORBIDDEN & set(_tops(f))
        assert not bad, f"{f} imports {bad}"


def test_references_import_nothing_of_the_program():
    for f in (BENCH / "reference").rglob("*.py"):
        tops = set(_tops(f))
        assert "imatch_tpu_torch" not in tops, f
        src = f.read_text()
        assert "lib.program" not in src and "imatch_tpu_torch" not in src.replace("the port", "")


def test_a_new_cell_by_files_alone(tmp_path):
    root = tiny_root(tmp_path)
    bench = root / "benchmark"
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in bench.rglob("*") if p.is_file()}
    (bench / "configs" / "tiny-clip-wide.json").write_text(
        json.dumps(dict(json.loads((DATA / "tiny-clip.json").read_text()), projection_dim=64)))
    (bench / "traffic" / "tiny-search-small.json").write_text(json.dumps(
        {"driver": "search", "rate": 20.0, "per_request": 3, "limit": 5, "workers": 1, "min_words": 2, "max_words": 6,
         "alpha": 1.0, "store_rows": 1024, "warm_requests": 3, "check_requests": 2, "trace_from": 0.0, "trace_seconds": 0.1}))
    (bench / "metrics" / "requests.search.py").write_text(
        '"""requests.search: requests due in the window."""\n\n\ndef read(ctx):\n    return len(ctx.requests) or None\n')
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-clip-wide", "source": "https://huggingface.co/openai/clip-vit-base-patch32",
                            "file": "benchmark/configs/tiny-clip-wide.json", "reduced": ["projection_dim"], "why": "test"})
    spec["workloads"].append({"name": "tiny-new", "config": "tiny-clip-wide", "traffic": "tiny-search-small",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tiny-search" in m.get("workloads", []):
            m["workloads"].append("tiny-new")
    spec["per_layer"].append({"name": "requests.search", "unit": "requests", "better": "higher", "source": "host_clock",
                              "layer": "store and engine", "moves": "search_p50_ms", "workloads": ["tiny-new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in bench.rglob("*") if p.is_file() and p in before}
    assert after == before  # nothing that was there changed
    ctx, out = run(root, "tiny-new", seconds=0.2, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["requests.search"]["value"] == 4
    assert ctx.cfg["projection_dim"] == 64
    ctx, out = run(root, "tiny-new", seconds=0.2)
    assert set(out["metrics"]) == {"search_p50_ms", "setup_s"}


def _with_config(tmp_path, **changes):
    root = tiny_root(tmp_path)
    path = root / "benchmark" / "configs" / "tiny-clip.json"
    cfg = json.loads(path.read_text())
    for key, value in changes.items():
        if key.startswith("store_"):
            cfg["store"][key[len("store_"):]] = value
        else:
            cfg[key] = value
    path.write_text(json.dumps(cfg))
    return root


@pytest.mark.parametrize("change, message", [
    ({"batch_size": 8}, "keys the harness does not read"),
    ({"store_persist_dir": "journal"}, "persist_dir"),
    ({"store_nprobe": 8}, "store settings"),
    ({"quant": "int4"}, "quant"),
    ({"dtype": "float16"}, "dtype"),
])
def test_a_setting_the_harness_cannot_honour_is_refused(tmp_path, change, message):
    root = _with_config(tmp_path, **change)
    with pytest.raises(ValueError, match=message):
        run(root, "tiny-search", seconds=0.2)


def test_the_program_runs_as_the_configuration_states(tmp_path, monkeypatch):
    """Coalescing, the image tower's quantization and the served type come
    from the configuration file, whatever the caller's environment says."""
    from benchmark.lib import program

    monkeypatch.setenv("IMATCH_COALESCE", "0")
    monkeypatch.setenv("IMATCH_SCORE_DTYPE", "int8")
    root = _with_config(tmp_path, quant="int8", store_coalesce=True)
    seen = {}
    real_embedder, real_store = program.embedder, program.store

    def embedder(cfg, weights, device):
        seen["emb"] = real_embedder(cfg, weights, device)
        return seen["emb"]

    def store(cfg, device, capacity=None):
        seen["store"] = real_store(cfg, device, capacity)
        return seen["store"]

    monkeypatch.setattr(program, "embedder", embedder)
    monkeypatch.setattr(program, "store", store)
    ctx, out = run(root, "tiny-search", seconds=0.3)
    assert out["correct"], out["checks"]
    assert seen["emb"].quant == "int8" and seen["emb"].compute_dtype == torch.float32
    assert seen["store"].stats()["coalescing"]
    assert os.environ["IMATCH_COALESCE"] == "1" and os.environ["IMATCH_SCORE_DTYPE"] == "bf16"
