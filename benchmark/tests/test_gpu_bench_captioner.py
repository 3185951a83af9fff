"""A captioner family comes in by files alone: a family module under
``captioners/``, a configuration that names it and a cell, with no file
that was there changed. A family or a key the harness does not read is
refused before the run, and the configurations with no captioner read as
before. The K2 roofline's launches by span, and the captioner's
arithmetic."""

import hashlib
import json

import pytest

from gpu_bench_support import BENCH, DATA, REPO, run, tiny_root

TINY_FAMILY = '''"""A family for the test: the port's Moondream, its block naming only the
port's geometry and the served type; every width is the geometry's."""

import dataclasses
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("tinyfam_moondream", Path(__file__).with_name("moondream.py"))
md = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(md)
KEYS = {"model_type", "port_config", "dtype"}


def _full(cc):
    from imatch_tpu_torch.models.moondream.configs import MD_CONFIGS

    if set(cc) != KEYS:
        raise ValueError(f"tinyfam: keys the harness does not read {sorted(set(cc) - KEYS)}")
    c = MD_CONFIGS[cc["port_config"]]
    v, t = c.vision, c.text
    return {"model_type": "moondream", "port_config": cc["port_config"], "dtype": cc["dtype"],
            "projector_hidden_size": c.proj_hidden,
            "vision_config": {"hidden_size": v.hidden_size, "intermediate_size": v.mlp_size,
                              "num_hidden_layers": v.num_layers, "num_attention_heads": v.num_heads,
                              "patch_size": v.patch_size, "image_size": v.image_size,
                              "layer_norm_eps": v.layer_norm_eps, "hidden_act": "gelu_pytorch_tanh"},
            "text_config": {"hidden_size": t.hidden_size, "intermediate_size": t.mlp_size,
                            "num_hidden_layers": t.num_layers, "num_attention_heads": t.num_heads,
                            "partial_rotary_factor": t.rotary_dim / t.head_dim, "vocab_size": t.vocab_size,
                            "max_position_embeddings": t.max_seq, "layer_norm_eps": t.layer_norm_eps,
                            "eos_token_id": t.eos_token_id, "bos_token_id": t.bos_token_id,
                            "hidden_act": "gelu_new", "rope_theta": 10000.0}}


def validate(cc):
    md.validate(_full(cc))


def settings(cc, inputs):
    return md.settings(_full(cc), inputs)


def build(cc, seed, device, inputs, control=False):
    return md.build(_full(cc), seed, device, inputs, control)


record = md.record
CHECKS = md.CHECKS


def tokenizer(cc):
    return md.tokenizer(_full(cc))


def prompt_ids(cc, bpe):
    return md.prompt_ids(_full(cc), bpe)


def request_flops(cc, n_prompt, n_generated):
    return md.request_flops(_full(cc), n_prompt, n_generated)


def k2_shapes(cc):
    return md.k2_shapes(_full(cc))


def check(cc, seed, device, items):
    return md.check(_full(cc), seed, device, items)
'''


def _hashes(bench):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in bench.rglob("*") if p.is_file()}


def test_a_captioner_family_by_files_alone(tmp_path):
    root = tiny_root(tmp_path)
    bench = root / "benchmark"
    before = _hashes(bench)
    (bench / "captioners" / "tinyfam.py").write_text(TINY_FAMILY)
    cfg = json.loads((DATA / "tiny-clip-md.json").read_text())
    cfg["captioner"] = {"model_type": "tinyfam", "port_config": "tiny-md", "dtype": "float32"}
    (bench / "configs" / "tiny-clip-tinyfam.json").write_text(json.dumps(cfg))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-clip-tinyfam", "source": "https://huggingface.co/vikhyatk/moondream2",
                            "file": "benchmark/configs/tiny-clip-tinyfam.json", "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-new-captioner", "config": "tiny-clip-tinyfam",
                              "traffic": "tiny-caption-search", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tiny-caption-search" in m.get("workloads", []):
            m["workloads"].append("tiny-new-captioner")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert {p: h for p, h in _hashes(bench).items() if p in before} == before  # nothing that was there changed
    ctx, out = run(root, "tiny-new-captioner", seconds=0.3, trace=True)
    assert out["correct"], out["checks"]
    assert {"cap_prefill_gap", "cap_decode_gap", "cap_greedy_gap_max", "enhanced_text_mismatch"} <= set(out["checks"])
    assert "vlm_caption_ms.caption_search" in out["metrics"]
    assert type(ctx).__name__ == "Context" and ctx.cfg["captioner"]["model_type"] == "tinyfam"


def _captioner(**changes):
    cfg = dict(json.loads((DATA / "tiny-clip-md.json").read_text()), name="tiny-clip-md")
    cc = json.loads(json.dumps(cfg["captioner"]))
    for key, value in changes.items():
        group, _, leaf = key.partition("__")
        if leaf:
            cc[group][leaf] = value
        elif value is None:
            del cc[group]
        else:
            cc[group] = value
    cfg["captioner"] = cc
    return cfg


@pytest.mark.parametrize("changes, message", [
    ({"model_type": "nosuchfamily"}, "no family module"),
    ({"model_type": "../configs/x"}, "no family module"),
    ({"temperature": 0.7}, "keys the harness does not read"),
    ({"text_config__num_key_value_heads": 8}, "keys the harness does not read"),
    ({"vision_config__patch_size": None}, "missing"),
    ({"projector_hidden_size": None}, "missing"),
    ({"text_config__hidden_size": 64}, "the port's tiny-md has 32"),
    ({"text_config__partial_rotary_factor": 0.25}, "partial_rotary_factor"),
    ({"vision_config__hidden_act": "gelu"}, "the port serves"),
    ({"port_config": "moondream3"}, "port_config"),
    ({"dtype": "float16"}, "dtype"),
])
def test_a_captioner_the_harness_cannot_honour_is_refused(changes, message):
    from benchmark.lib import program

    cfg = _captioner(**changes)
    if "vision_config__patch_size" in changes:
        del cfg["captioner"]["vision_config"]["patch_size"]
    with pytest.raises(ValueError, match=message):
        program.validate(cfg)


def test_a_refused_captioner_stops_the_run_before_it_starts(tmp_path):
    root = tiny_root(tmp_path)
    path = root / "benchmark" / "configs" / "tiny-clip-md.json"
    cfg = json.loads(path.read_text())
    cfg["captioner"]["max_new_tokens"] = 64
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="keys the harness does not read"):
        run(root, "tiny-caption-search", seconds=0.2)


def _moondream2():
    """The moondream2 configuration at published widths: the file the
    caption-search cell will run (PERF.md, open questions)."""
    cfg = json.loads((BENCH / "configs" / "longclip-l14-248-moondream2.json").read_text())
    cfg["name"] = "longclip-l14-248-moondream2"
    return cfg


SETTINGS = {"IMATCH_INDEX_ENGINE": "tilemax", "IMATCH_SCORE_DTYPE": "bf16", "IMATCH_COALESCE": "0", "IMATCH_EMBED_QUANT": ""}


@pytest.mark.parametrize("name", ["longclip-l14-248", "clip-vit-b32"])
def test_the_configurations_without_a_captioner_read_as_before(name):
    from benchmark.lib import program
    from benchmark.lib.spec import Spec

    cfg = Spec(REPO).config(name)
    assert "captioner" not in cfg
    program.validate(cfg)
    assert program.settings(cfg) == SETTINGS
    state = program.State(None, None)
    assert type(state.captioner).__name__ == "NullCaptioner" and not state.captioner.available
    assert type(program.captioner(cfg, 1, "cpu")).__name__ == "NullCaptioner"


def test_the_caption_cell_states_its_settings():
    from benchmark.lib import program

    cfg = _moondream2()
    out = program.settings(cfg)
    assert {k: out[k] for k in SETTINGS} == SETTINGS
    assert out["IMATCH_CAPTIONER"] == "moondream" and out["IMATCH_MD_CONFIG"] == "moondream2"
    assert out["IMATCH_MD_PARAM_DTYPE"] == "bf16"
    assert out["IMATCH_MD_VOCAB"].endswith("build/bench_inputs/moondream-vocab-51200-50256/vocab.json")


def test_every_cell_limits_what_its_run_compares():
    """Each configuration's ``limits`` for its cells' drivers name every
    number the run compares, and nothing else; the moondream2
    configuration's for the caption-search driver."""
    from benchmark.lib import program
    from benchmark.lib.spec import Spec

    spec = Spec(REPO)
    search = {"emb_gap_max", "emb_bias", "store_rank_gap", "store_score_gap", "results_missing"}
    runs = [(w["name"], spec.config(w["config"]), spec.mix(w["traffic"])["driver"]) for w in spec.data["workloads"]]
    runs.append(("moondream2", _moondream2(), "caption_search"))
    for name, cfg, driver in runs:
        if driver == "search":
            assert set(cfg["limits"]["search"]) == search, name
        else:
            checks = set(program.family(cfg["captioner"]).CHECKS) | search | {"enhanced_text_mismatch"}
            assert set(cfg["limits"][driver]) == checks, name


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_kernels_by_launching_span_and_the_k2_roofline():
    """Three K2 launches: one from ``vlm.encode`` on thread 1, one from
    ``embed.image`` on thread 2 (inside that thread's request span), one
    whose launch lies outside the stretch's kernels (it ends past it) and
    is left out; a kernel with no launch event is left out."""
    from benchmark.lib import flops, trace
    from benchmark.lib.spec import Spec

    k2 = "void flash_fwd_mma_kernel<true>(Params)"
    events = [
        _ev("bench.stretch", "user_annotation", 0, 1000),
        _ev("bench.caption_search.request", "user_annotation", 10, 900, tid=1),
        _ev("vlm.encode", "user_annotation", 20, 100, tid=1),
        _ev("bench.caption_search.request", "user_annotation", 30, 900, tid=2),
        _ev("embed.image", "user_annotation", 200, 100, tid=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 50, 5, tid=1, corr=7),
        _ev("cudaLaunchKernel", "cuda_runtime", 210, 5, tid=2, corr=8),
        _ev("cudaLaunchKernel", "cuda_runtime", 220, 5, tid=2, corr=9),
        _ev(k2, "kernel", 100, 30, tid=9, corr=7),
        _ev(k2, "kernel", 400, 10, tid=9, corr=8),
        _ev(k2, "kernel", 995, 10, tid=9, corr=9),
        _ev(k2, "kernel", 600, 10, tid=9, corr=99),
    ]
    s = trace.summarize(events)
    assert s["kernel_by_span"] == {"flash_fwd_mma_kernel|vlm.encode": [pytest.approx(30e-6), 1],
                                   "flash_fwd_mma_kernel|embed.image": [pytest.approx(10e-6), 1]}
    cfg = _moondream2()

    class Ctx:
        trace_summary, requests, bench_dir = s, [{}], BENCH

    Ctx.cfg = cfg
    want = flops.bound_s(*flops.k2_launch(1, 16, 729, 72, False)) + flops.bound_s(*flops.k2_launch(1, 16, 257, 64, False))
    assert Spec(REPO).reader("k2_roofline.caption_search")(Ctx) == pytest.approx(100 * want / 40e-6)


def test_moondream_arithmetic():
    from benchmark.lib import flops

    cc = _moondream2()["captioner"]
    d, inter, n = 1152, 4304, 729
    layer = 8 * n * d * d + 4 * n * d * inter + 4 * d * n * n
    assert flops.md_encode_flops(cc) == 2 * n * 588 * d + 27 * layer + 2 * n * (d * 8192 + 8192 * 2048)
    d, inter = 2048, 8192
    step = 24 * (8 * d * d + 4 * d * inter + 4 * d * 742) + 2 * d * 51200
    assert flops.md_decoder_flops(cc, 741, 1) == step
    prefill = 24 * (8 * 741 * d * d + 4 * 741 * d * inter + 4 * d * 741 * 742 / 2) + 2 * d * 51200
    assert flops.md_decoder_flops(cc, 0, 741) == prefill
    # a caption with a 12-id prompt: the encode about 0.71 T, the prefill of 741 positions 1.84 T, 47 steps of about 2.8 G
    from benchmark.lib.program import family

    total = family(cc).request_flops(cc, 12, 48)
    assert 2.5e12 < total < 2.9e12
