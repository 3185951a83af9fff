"""The caption-search cell at toy sizes on the CPU (tiny CLIP, the port's
tiny-md captioner; the look for a card skipped): a sound run comes out
correct and reads its layers; the control and every fault planted under
the timed path come out not correct."""

import pytest

from gpu_bench_faults import CAPTION_FAULTS
from gpu_bench_support import run, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def test_caption_search_is_correct(root):
    ctx, out = run(root, "tiny-caption-search", seconds=0.5, trace=True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"cap_prefill_gap", "cap_decode_gap", "cap_greedy_gap_max", "enhanced_text_mismatch", "emb_gap_max",
                                  "emb_bias", "store_rank_gap", "store_score_gap", "results_missing"}
    # the spans' readers read, the search path's as well; the CPU has no device trace, so those are left out, never 0
    assert set(out["metrics"]) == {"vlm_encode_ms.caption_search", "vlm_caption_ms.caption_search", "tower_dispatch_ms.search",
                                   "store_query_ms.search", "tokenize_ms.search"}
    assert ctx.notes["cap_tokens_checked"] == 3 * 48  # every checked caption, each greedy token
    assert all(c["generated"] == 48 for c in ctx.captions.values())
    assert all(len(t[0]) > 0 for t in ctx.texts)


def test_caption_control_is_not_correct(root):
    """The control: the program's own int8 paths (the captioner's int8
    weights, W8A8 prefill and int8 cache; the image tower's W8A8)."""
    ctx, out = run(root, "tiny-caption-search", seconds=0.3, control=True)
    c = out["checks"]
    assert not out["correct"]
    for name in ("cap_prefill_gap", "cap_decode_gap", "emb_gap_max"):
        assert c[name]["value"] > c[name]["limit"], c


@pytest.mark.parametrize("fault", sorted(CAPTION_FAULTS))
def test_caption_fault_is_not_correct(root, monkeypatch, fault):
    CAPTION_FAULTS[fault](monkeypatch)
    ctx, out = run(root, "tiny-caption-search", seconds=0.5)
    assert not out["correct"], out["checks"]

