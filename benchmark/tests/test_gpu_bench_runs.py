"""Whole runs of the harness at toy sizes on the CPU (the look for a card
skipped): sound runs come out correct; the control and every fault
planted under the timed path come out not correct. On a card,
``test_cell_on_card`` runs a real cell through the command line."""

import json
import subprocess
import sys

import pytest
import torch

from gpu_bench_faults import answer_altered
from gpu_bench_support import REPO, run, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_sound_run_is_correct(root):
    ctx, out = run(root, "tiny-search", seconds=0.5, trace=False)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"emb_gap_max", "emb_bias", "store_rank_gap", "store_score_gap", "results_missing"}
    assert set(out["metrics"]) == {"search_p50_ms", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_traced_run_reads_its_layers(root):
    ctx, out = run(root, "tiny-search", seconds=0.5, trace=True)
    assert out["correct"], out["checks"]
    assert "breakdown" in out and out["device"]["window_s"] > 0
    assert ctx.trace_summary["request_s"] > 0  # the request spans were traced
    # the CPU has no device trace: those metrics are left out, never 0
    assert {"tower_dispatch_ms.search", "store_query_ms.search"} <= set(out["metrics"])
    assert not any(k.startswith(("k1_", "idle_", "mfu")) for k in out["metrics"])


def test_control_is_not_correct(root):
    ctx, out = run(root, "tiny-search", seconds=0.3, control=True)
    assert not out["correct"]
    assert out["checks"]["emb_bias"]["value"] > out["checks"]["emb_bias"]["limit"]


def _tower_fault(fault):
    """Break the text tower's output for each batch: ``fault(e)`` returns
    the served (Q, D) embeddings."""

    def plant(monkeypatch):
        from imatch_tpu_torch.pipeline.embedder import ClipEmbedder

        real = ClipEmbedder.embed_texts_device

        def broken(self, texts):
            return fault(real(self, texts))

        monkeypatch.setattr(ClipEmbedder, "embed_texts_device", broken)

    return plant


def _half_the_queries(e):
    """Half the batch left out: the rest served their mean."""
    h = max(1, e.shape[0] // 2)
    return torch.cat([e[:h], e[:h].mean(0, keepdim=True).expand(e.shape[0] - h, -1)])


def _permuted(e):
    """The outputs in another order than the texts' (sorted by a key and
    not put back): every slot another query's answer, the mean unmoved."""
    return e.roll(1, dims=0)


def _one_slot_altered(e):
    """One answer a batch altered where it is produced: the last slot's
    embedding moved by 0.003, three times the tiny configuration's limit;
    over the checked requests of 4 texts the mean moves by a quarter of
    that, under the limit (at the cells' sizes, 32-256 texts a request
    dilute one slot's move in the mean further)."""
    e = e.clone()
    x = e[-1].float()
    d = torch.ones_like(x) - (torch.ones_like(x) @ x) * x
    e[-1] = torch.nn.functional.normalize(x + 0.003 * d / torch.linalg.vector_norm(d), dim=0).to(e.dtype)
    return e


FAULTS = {
    "search-answer-altered": answer_altered,
    "search-half-the-batch": _tower_fault(_half_the_queries),
    "search-tower-permuted": _tower_fault(_permuted),
    "search-one-slot-altered": _tower_fault(_one_slot_altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(root, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    ctx, out = run(root, "tiny-search", seconds=0.3)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["search-tower-permuted", "search-one-slot-altered"])
def test_mean_alone_misses_a_wrong_slot(root, monkeypatch, fault):
    """The faults that emb_gap_max is there for: the mean difference
    (emb_bias) and the store, which follows the served queries, pass
    them."""
    FAULTS[fault](monkeypatch)
    ctx, out = run(root, "tiny-search", seconds=0.3)
    c = out["checks"]
    assert c["emb_gap_max"]["value"] > c["emb_gap_max"]["limit"]
    assert all(c[k]["value"] <= c[k]["limit"] for k in c if k != "emb_gap_max"), c


def test_cell_on_card(cuda):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "longclip-search-q32", "--seed", "2147483659",
                        "--seconds", "5", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
