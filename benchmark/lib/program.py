"""The system under test, built from a configuration file: the port's
``ClipEmbedder`` and ``VectorStore`` at the file's widths and settings,
with the seed's weights, and the app's captioner. With the program's
captioner families (``captioners/<model_type>.py``), the only modules of
the harness that import the program (the references import none of it).

Every key of a configuration file is read here or is documentation
(``DOC_KEYS``); a file with any other key, or a setting this harness
cannot honour, is refused before the run, so no setting is silently
left at the program's default.

An optional ``captioner`` block names its family by ``model_type``: the
module ``captioners/<model_type>.py`` beside ``lib/``, loaded by path,
validates the block (refusing any key it does not read), gives the
program's settings for it, builds the served captioner with the seed's
weights, records what it produced and holds that to its reference. A
family is added by that file alone; a block whose family has no module
is refused before the run. Without the block the state's captioner is
the app's ``NullCaptioner``, as in the app with none configured."""

from __future__ import annotations

import importlib.util
import os
from pathlib import Path
from typing import Dict

import torch

BENCH_DIR = Path(__file__).resolve().parents[1]

DOC_KEYS = {"source", "about", "model_type", "reduced", "assumed", "limits_readings"}
READ_KEYS = {"name", "projection_dim", "vision_config", "text_config", "dtype", "quant", "store", "limits"}
OPTIONAL_KEYS = {"captioner"}
STORE_KEYS = {"engine", "score_dtype", "coalesce", "persist_dir"}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
QUANTS = ("none", "int8")


def family(cc: dict, bench_dir: Path = BENCH_DIR):
    """The captioner family module ``captioners/<model_type>.py`` under
    ``bench_dir``, loaded by path."""
    name = str(cc.get("model_type", ""))
    path = Path(bench_dir) / "captioners" / f"{name}.py"
    if not name.replace("_", "").replace("-", "").isalnum() or not path.is_file():
        raise ValueError(f"captioner model_type {name!r}: no family module captioners/{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_captioner_{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs_dir(bench_dir: Path = BENCH_DIR) -> Path:
    """Where the benchmark writes the input files it makes (a captioner's
    vocabulary): a fixed directory in the checkout's build/."""
    return Path(bench_dir).parent / "build" / "bench_inputs"


def validate(cfg: dict, bench_dir: Path = BENCH_DIR) -> None:
    """Refuse a configuration with a key or a value the harness does not
    honour."""
    extra = sorted(set(cfg) - DOC_KEYS - READ_KEYS - OPTIONAL_KEYS)
    if extra:
        raise ValueError(f"configuration {cfg.get('name')!r}: keys the harness does not read: {extra}")
    missing = sorted((READ_KEYS - {"name"}) - set(cfg))
    if missing:
        raise ValueError(f"configuration {cfg.get('name')!r}: missing {missing}")
    if cfg["dtype"] not in DTYPES:
        raise ValueError(f"dtype {cfg['dtype']!r}: expected one of {sorted(DTYPES)}")
    if cfg["quant"] not in QUANTS:
        raise ValueError(f"quant {cfg['quant']!r}: expected one of {QUANTS}")
    s = cfg["store"]
    if set(s) != STORE_KEYS:
        raise ValueError(f"store settings {sorted(s)}: expected exactly {sorted(STORE_KEYS)}")
    if s["persist_dir"] is not None:
        raise ValueError("store.persist_dir: the benchmark journals nothing to disk; it must be null")
    if "captioner" in cfg:
        family(cfg["captioner"], bench_dir).validate(cfg["captioner"])


def settings(cfg: dict, bench_dir: Path = BENCH_DIR) -> Dict[str, str]:
    """The program's environment settings, from the configuration: the
    store's engine, score type and coalescing, the image tower's
    quantization, and the captioner family's."""
    s = cfg["store"]
    out = {
        "IMATCH_INDEX_ENGINE": s["engine"],
        "IMATCH_SCORE_DTYPE": s["score_dtype"],
        "IMATCH_COALESCE": "1" if s["coalesce"] else "0",
        "IMATCH_EMBED_QUANT": "" if cfg["quant"] == "none" else cfg["quant"],
    }
    if "captioner" in cfg:
        out.update(family(cfg["captioner"], bench_dir).settings(cfg["captioner"], inputs_dir(bench_dir)))
    return out


def settle_environment(cfg: dict, bench_dir: Path = BENCH_DIR) -> None:
    """Every setting the program reads from the environment is the
    configuration's, not the caller's."""
    validate(cfg, bench_dir)
    for k in [k for k in os.environ if k.startswith("IMATCH_")]:
        del os.environ[k]
    os.environ.update(settings(cfg, bench_dir))


def served_dtype(cfg: dict) -> torch.dtype:
    """The type the towers are served in, as the configuration states."""
    return DTYPES[cfg["dtype"]]


def clip_config(cfg: dict):
    from imatch_tpu_torch.models.clip.configs import CLIPConfig, TextConfig, VisionConfig

    v, t = cfg["vision_config"], cfg["text_config"]
    for tower in (v, t):
        if tower["intermediate_size"] != 4 * tower["hidden_size"] or tower["hidden_act"] != "quick_gelu":
            raise ValueError("the port's CLIP towers take an MLP of 4 x hidden with quick_gelu")
    return CLIPConfig(
        name=cfg["name"],
        vision=VisionConfig(
            image_size=v["image_size"],
            patch_size=v["patch_size"],
            hidden_size=v["hidden_size"],
            num_layers=v["num_hidden_layers"],
            num_heads=v["num_attention_heads"],
            layer_norm_eps=v["layer_norm_eps"],
        ),
        text=TextConfig(
            vocab_size=t["vocab_size"],
            max_positions=t["max_position_embeddings"],
            hidden_size=t["hidden_size"],
            num_layers=t["num_hidden_layers"],
            num_heads=t["num_attention_heads"],
            layer_norm_eps=t["layer_norm_eps"],
            eos_token_id=t["eos_token_id"],
        ),
        projection_dim=cfg["projection_dim"],
    )


def embedder(cfg: dict, weights: Dict[str, torch.Tensor], device):
    """The port's embedder at the configuration's widths, type and
    quantization, serving ``weights``: its own seeded init is replaced
    leaf by leaf, on the device, before any call. Every served leaf must
    be in the tree. A quantized image tower (``quant``) is made by the
    program from the weights held in fp32, then cast as it casts them
    (what IMATCH_EMBED_QUANT serves)."""
    from imatch_tpu_torch.pipeline.embedder import ClipEmbedder

    served = served_dtype(cfg)
    if cfg["quant"] == "none":
        emb = ClipEmbedder(config=clip_config(cfg), device=device, quant="none", compute_dtype=served)
        _install(emb.model, weights)
        return emb
    from imatch_tpu_torch.models.clip.model import quantize_and_cast

    emb = ClipEmbedder(config=clip_config(cfg), device=device, quant="none", compute_dtype=torch.float32)
    _install(emb.model, weights)
    emb.model = quantize_and_cast(emb.model, served, cfg["quant"])
    emb.compute_dtype, emb.quant = served, cfg["quant"]
    return emb


@torch.no_grad()
def _install(model, weights: Dict[str, torch.Tensor]) -> None:
    served = {n: p for n, p in model.named_parameters() if n != "logit_scale"}
    missing = sorted(set(served) - set(weights))
    extra = sorted(set(weights) - set(served))
    if missing or extra:
        raise ValueError(f"weight tree and served model differ: missing {missing[:3]}, extra {extra[:3]}")
    for name, p in served.items():
        w = weights[name]
        if tuple(w.shape) != tuple(p.shape):
            raise ValueError(f"{name}: tree {tuple(w.shape)} against served {tuple(p.shape)}")
        p.copy_(w)


def store(cfg: dict, device, capacity=None):
    from imatch_tpu_torch.index.store import VectorStore

    s = cfg["store"]
    return VectorStore(
        dim=cfg["projection_dim"], engine=s["engine"], score_dtype=s["score_dtype"], capacity=capacity, device=device,
        coalesce=bool(s["coalesce"]),
    )


def captioner(cfg: dict, seed: int, device, bench_dir: Path = BENCH_DIR, control: bool = False):
    """The configuration's captioner, built by its family with the seed's
    weights (``control``: with the program's own lower-precision path on);
    the app's ``NullCaptioner`` where the file names none."""
    if "captioner" not in cfg:
        from imatch_tpu_torch.pipeline.captioner import NullCaptioner

        return NullCaptioner()
    cc = cfg["captioner"]
    return family(cc, bench_dir).build(cc, seed, device, inputs_dir(bench_dir), control)


class State:
    """What ``pipeline.search`` reads of the app's state: the embedder,
    the store and the captioner (the app's ``NullCaptioner`` unless one is
    given)."""

    def __init__(self, emb, st, cap=None):
        if cap is None:
            from imatch_tpu_torch.pipeline.captioner import NullCaptioner

            cap = NullCaptioner()
        self.embedder, self.store, self.captioner = emb, st, cap

    def get_embedder(self):
        return self.embedder


def search_entry():
    """``pipeline.search.search_by_text_batch``: the batch route's call."""
    from imatch_tpu_torch.pipeline.search import search_by_text_batch

    return search_by_text_batch


def caption_search_entries():
    """The legacy /search route with ``enhance_with_caption``:
    (``enhance_query_with_caption``, ``search_multimodal``) of
    ``pipeline.search``, called one after the other as the route does."""
    from imatch_tpu_torch.pipeline.search import enhance_query_with_caption, search_multimodal

    return enhance_query_with_caption, search_multimodal


def metrics():
    from imatch_tpu_torch.utils.metrics import METRICS

    return METRICS
