"""The Moondream family of captioners: a configuration file's
``"captioner": {"model_type": "moondream", ...}``, served by the port's
``MoondreamTorch`` (``pipeline/captioner.get_captioner`` with
IMATCH_CAPTIONER=moondream) at one of its named geometries.

The block holds moondream2's published keys: the SigLIP vision tower's
(HF ``SiglipVisionConfig``), the projector's width and the Phi decoder's
(HF ``PhiConfig``), each equal to the port's geometry named in
``port_config`` (IMATCH_MD_CONFIG); none may be missing, none may differ.
``dtype`` is the served type (bf16 on a card: the port computes the
captioner in bf16 there and in fp32 on the CPU).

Weights are drawn from the seed on the device (matrices normal(0,
1/sqrt(fan_in)), embeddings and biases normal(0, 0.02), LayerNorm scales
1 + normal(0, 0.02)) and installed leaf by leaf into the served model, the
packed q/k/v/MLP-in projection of each decoder layer as the concatenation
of its four leaves. The vocabulary is the benchmark's: GPT-2's byte
layout with every other id a lowercase token of 2-4 letters, so that
every id a random-weight model emits decodes to text
(IMATCH_MD_VOCAB/MERGES, written once into the checkout's build/).

``check`` holds what the captioner produced for the checked requests to
``reference/moondream.py``: the prefill's and each decode step's logits,
and each greedy token by the reference's logits over the program's own
tokens. The control is the program's own int8 path (``build``'s
``control``).
"""

from __future__ import annotations

import itertools
import json
import os
import string
from pathlib import Path
from typing import Dict

import torch

CHECKS = ("cap_prefill_gap", "cap_decode_gap", "cap_greedy_gap_max")  # the numbers ``check`` returns
PROMPT = "\n\nQuestion: Describe this image.\n\nAnswer:"  # moondream2's caption prompt, the route's
MAX_NEW = 48  # new tokens of the route's caption (pipeline.search's call to caption())

DOC_KEYS = {"source", "about", "assumed"}
READ_KEYS = {"model_type", "port_config", "dtype", "projector_hidden_size", "vision_config", "text_config"}
VISION = {"hidden_size": "hidden_size", "intermediate_size": "mlp_size", "num_hidden_layers": "num_layers",
          "num_attention_heads": "num_heads", "patch_size": "patch_size", "image_size": "image_size",
          "layer_norm_eps": "layer_norm_eps"}
TEXT = {"hidden_size": "hidden_size", "intermediate_size": "mlp_size", "num_hidden_layers": "num_layers",
        "num_attention_heads": "num_heads", "vocab_size": "vocab_size", "max_position_embeddings": "max_seq",
        "layer_norm_eps": "layer_norm_eps", "eos_token_id": "eos_token_id", "bos_token_id": "bos_token_id"}
FIXED = {"vision_config": {"hidden_act": "gelu_pytorch_tanh"},
         "text_config": {"hidden_act": "gelu_new", "rope_theta": 10000.0}}
DTYPES = {"bfloat16": ("bf16", torch.bfloat16), "float32": ("fp32", torch.float32)}


def _port_config(name: str):
    from imatch_tpu_torch.models.moondream.configs import MD_CONFIGS

    if name not in MD_CONFIGS:
        raise ValueError(f"captioner port_config {name!r}: the port has {sorted(MD_CONFIGS)}")
    return MD_CONFIGS[name]


def validate(cc: dict) -> None:
    """Refuse a key the family does not read, a missing key, and a width
    that is not the port's named geometry's."""
    extra = sorted(set(cc) - DOC_KEYS - READ_KEYS)
    missing = sorted(READ_KEYS - set(cc))
    if extra or missing:
        raise ValueError(f"captioner: keys the harness does not read {extra}, missing {missing}")
    if cc["dtype"] not in DTYPES:
        raise ValueError(f"captioner dtype {cc['dtype']!r}: expected one of {sorted(DTYPES)}")
    port = _port_config(cc["port_config"])
    for group, names, want in (("vision_config", VISION, port.vision), ("text_config", TEXT, port.text)):
        block = cc[group]
        known = set(names) | set(FIXED[group]) | ({"partial_rotary_factor"} if group == "text_config" else set())
        if set(block) != known:
            raise ValueError(f"captioner {group}: keys the harness does not read {sorted(set(block) - known)}, "
                             f"missing {sorted(known - set(block))}")
        for key, value in FIXED[group].items():
            if block[key] != value:
                raise ValueError(f"captioner {group}.{key} {block[key]!r}: the port serves {value!r}")
        for key, attr in names.items():
            if block[key] != getattr(want, attr):
                raise ValueError(f"captioner {group}.{key} {block[key]!r}: the port's {cc['port_config']} "
                                 f"has {getattr(want, attr)!r}")
    t = cc["text_config"]
    if t["partial_rotary_factor"] * port.text.head_dim != port.text.rotary_dim:
        raise ValueError(f"captioner partial_rotary_factor {t['partial_rotary_factor']}: the port rotates "
                         f"{port.text.rotary_dim} of {port.text.head_dim} dims")
    if cc["projector_hidden_size"] != port.proj_hidden:
        raise ValueError(f"captioner projector_hidden_size {cc['projector_hidden_size']}: the port's is {port.proj_hidden}")


def _vocab_paths(cc: dict, inputs: Path):
    t = cc["text_config"]
    d = Path(inputs) / f"moondream-vocab-{t['vocab_size']}-{t['eos_token_id']}"
    return d / "vocab.json", d / "merges.txt"


def settings(cc: dict, inputs: Path) -> Dict[str, str]:
    vocab, merges = _vocab_paths(cc, inputs)
    return {
        "IMATCH_CAPTIONER": "moondream",
        "IMATCH_MD_CONFIG": cc["port_config"],
        "IMATCH_MD_PARAM_DTYPE": DTYPES[cc["dtype"]][0],
        "IMATCH_MD_VOCAB": str(vocab),
        "IMATCH_MD_MERGES": str(merges),
    }


def served_dtype(cc: dict) -> torch.dtype:
    return DTYPES[cc["dtype"]][1]


# -- inputs --------------------------------------------------------------------------


def byte_table() -> Dict[int, str]:
    from benchmark.reference.gpt2 import byte_table as table

    return table()


def vocabulary(cc: dict):
    """(vocab, merges): the 256 byte tokens, ``<|endoftext|>`` at the
    decoder's eos id, and every other id a merged lowercase token of 2-4
    letters."""
    t = cc["text_config"]
    b2u = byte_table()
    vocab = {b2u[b]: b for b in range(256)}
    vocab["<|endoftext|>"] = t["eos_token_id"]
    free = [i for i in range(256, t["vocab_size"]) if i != t["eos_token_id"]]
    words = itertools.chain.from_iterable(itertools.product(string.ascii_lowercase, repeat=n) for n in (2, 3, 4))
    merges = []
    for i, word in zip(free, words):
        merges.append(("".join(word[:-1]), word[-1]))
        vocab["".join(word)] = i
    return vocab, merges


def _write_vocabulary(cc: dict, inputs: Path) -> None:
    vocab_path, merges_path = _vocab_paths(cc, inputs)
    if vocab_path.exists() and merges_path.exists():
        return
    vocab, merges = vocabulary(cc)
    vocab_path.parent.mkdir(parents=True, exist_ok=True)
    for path, text in ((merges_path, "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n"),
                       (vocab_path, json.dumps(vocab))):
        tmp = path.with_name(path.name + ".part")
        tmp.write_text(text, encoding="utf-8")
        os.replace(tmp, path)


def weight_leaves(cc: dict):
    """(name, shape, kind) of every weight, in the checkpoint's layout
    (separate q, k, v and MLP-in projections), kinds as
    ``lib/data.weight_leaves``'."""
    v, t, ph = cc["vision_config"], cc["text_config"], cc["projector_hidden_size"]
    dv, p, dt, inter = v["hidden_size"], v["patch_size"], t["hidden_size"], t["intermediate_size"]
    yield "vision.patch_embedding.weight", (dv, 3, p, p), 3 * p * p
    yield "vision.patch_embedding.bias", (dv,), "bias"
    yield "vision.position_embedding", ((v["image_size"] // p) ** 2, dv), "embedding"
    for i in range(v["num_hidden_layers"]):
        n, m = f"vision.encoder.layers.{i}", v["intermediate_size"]
        for leaf, shape, kind in (("ln1.weight", (dv,), "ln_weight"), ("ln1.bias", (dv,), "ln_bias"),
                                  ("qkv.weight", (3 * dv, dv), dv), ("qkv.bias", (3 * dv,), "bias"),
                                  ("out.weight", (dv, dv), dv), ("out.bias", (dv,), "bias"),
                                  ("ln2.weight", (dv,), "ln_weight"), ("ln2.bias", (dv,), "ln_bias"),
                                  ("fc1.weight", (m, dv), dv), ("fc1.bias", (m,), "bias"),
                                  ("fc2.weight", (dv, m), m), ("fc2.bias", (dv,), "bias")):
            yield f"{n}.{leaf}", shape, kind
    yield "vision.post_ln.weight", (dv,), "ln_weight"
    yield "vision.post_ln.bias", (dv,), "ln_bias"
    yield "projector.fc1.weight", (ph, dv), dv
    yield "projector.fc1.bias", (ph,), "bias"
    yield "projector.fc2.weight", (dt, ph), ph
    yield "projector.fc2.bias", (dt,), "bias"
    yield "text.token_embedding.weight", (t["vocab_size"], dt), "embedding"
    for i in range(t["num_hidden_layers"]):
        n = f"text.layers.{i}"
        yield f"{n}.ln.weight", (dt,), "ln_weight"
        yield f"{n}.ln.bias", (dt,), "ln_bias"
        for c, width in (("q", dt), ("k", dt), ("v", dt), ("fc1", inter)):
            yield f"{n}.{c}.weight", (width, dt), dt
            yield f"{n}.{c}.bias", (width,), "bias"
        yield f"{n}.out.weight", (dt, dt), dt
        yield f"{n}.out.bias", (dt,), "bias"
        yield f"{n}.fc2.weight", (dt, inter), inter
        yield f"{n}.fc2.bias", (dt,), "bias"
    yield "text.final_ln.weight", (dt,), "ln_weight"
    yield "text.final_ln.bias", (dt,), "ln_bias"
    yield "text.lm_head.weight", (t["vocab_size"], dt), dt
    yield "text.lm_head.bias", (t["vocab_size"],), "bias"


def make_weights(cc: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    from benchmark.lib import data

    return data.draw_leaves(list(weight_leaves(cc)), seed, "captioner-weights", device, served_dtype(cc))


# -- the program ----------------------------------------------------------------------

PACKED = ("q", "k", "v", "fc1")  # the order of the served qkv_mlp projection


@torch.no_grad()
def _install(model, weights: Dict[str, torch.Tensor]) -> None:
    used = set()
    for name, p in model.named_parameters():
        if ".qkv_mlp." in name:
            head, leaf = name.split(".qkv_mlp.")
            parts = [f"{head}.{c}.{leaf}" for c in PACKED]
            w = torch.cat([weights[n] for n in parts]) if all(n in weights for n in parts) else None
        else:
            parts = [name]
            w = weights.get(name)
        if w is None:
            raise ValueError(f"weight tree lacks the served leaf {name}")
        if tuple(w.shape) != tuple(p.shape):
            raise ValueError(f"{name}: tree {tuple(w.shape)} against served {tuple(p.shape)}")
        p.copy_(w)
        used.update(parts)
    extra = sorted(set(weights) - used)
    if extra:
        raise ValueError(f"weight tree has leaves the served model lacks: {extra[:3]}")


def build(cc: dict, seed: int, device, inputs: Path, control: bool = False):
    """The port's captioner at the file's geometry, through the app's
    factory, serving the seed's weights. ``control``: with the program's
    own path one precision step below bf16 switched on, as
    IMATCH_MD_QUANT, _ACT and _CACHE=int8 serve it: the int8 KV cache from
    the factory, then the seed's weights quantized by the program's
    ``quantize_int8`` (after the cast and the packing, the constructor's
    order) and the W8A8 prefill."""
    from imatch_tpu_torch.device import default_compute_dtype, resolve_device
    from imatch_tpu_torch.models.moondream.model import quantize_int8
    from imatch_tpu_torch.pipeline.captioner import get_captioner

    served = default_compute_dtype(resolve_device(device))
    if served != served_dtype(cc):
        raise ValueError(f"the port serves the captioner in {served} on {device}, the file states {cc['dtype']}")
    _write_vocabulary(cc, inputs)
    if control:
        os.environ["IMATCH_MD_CACHE"] = "int8"
    cap = get_captioner(device)
    if type(cap).__name__ != "MoondreamTorch" or cap.cfg.name != cc["port_config"]:
        raise ValueError(f"the app built {type(cap).__name__} {getattr(cap, 'cfg', None)}, not {cc['port_config']}")
    weights = make_weights(cc, seed, cap.device)
    _install(cap.model, weights)
    if control:
        quantize_int8(cap.model)
        cap.act_quant = True
    return cap


def record(cap, sink):
    """Wrap the logits of the captioner's decoder (its prefill's and each
    decode step's, ``generate.lm_logits``) and its decoding of the
    generated ids: ``sink("logits", logits)`` with each (V,) fp32 row in
    the order computed, and ``sink("generated", (tokens, length))`` with
    the row's tokens and their count (through the first eos), all left on
    the device. The captioner runs one call at a time under its lock.
    Returns the function that unwraps them."""
    from imatch_tpu_torch.models.moondream import generate

    lm_logits, decode_texts = generate.lm_logits, cap._decode_texts

    def recording_logits(model, hidden):
        out = lm_logits(model, hidden)
        if model is cap.model:
            sink("logits", out[0, -1])
        return out

    def recording_decode(result, rows):
        texts = decode_texts(result, rows)
        sink("generated", (result.tokens[0], result.lengths[0]))
        return texts

    generate.lm_logits, cap._decode_texts = recording_logits, recording_decode

    def undo():
        generate.lm_logits = lm_logits
        del cap._decode_texts

    return undo


# -- the check -------------------------------------------------------------------------


def prompt_ids(cc: dict, bpe) -> list:
    """BOS, then the caption prompt's ids."""
    return [cc["text_config"]["eos_token_id"]] + bpe.encode(PROMPT)


def tokenizer(cc: dict):
    from benchmark.reference.gpt2 import BPE

    vocab, merges = vocabulary(cc)
    return BPE(vocab, merges, specials=(cc["text_config"]["eos_token_id"],))


def request_flops(cc: dict, n_prompt: int, n_generated: int) -> float:
    """One caption's useful operations: the encode, the prefill of BOS,
    the patches and the prompt, and a decode step for each generated
    token after the first."""
    from benchmark.lib import flops

    v = cc["vision_config"]
    s = (v["image_size"] // v["patch_size"]) ** 2 + n_prompt
    return (flops.md_encode_flops(cc) + flops.md_decoder_flops(cc, 0, s, last=1)
            + sum(flops.md_decoder_flops(cc, s + j, 1, last=1) for j in range(n_generated - 1)))


def k2_shapes(cc: dict) -> Dict[str, tuple]:
    """The K2 launches of a caption, by the program span that launches
    them: (batch, heads, positions, head width, causal)."""
    v = cc["vision_config"]
    h = v["num_attention_heads"]
    return {"vlm.encode": (1, h, (v["image_size"] // v["patch_size"]) ** 2, v["hidden_size"] // h, False)}


@torch.no_grad()
def check(cc: dict, seed: int, device, items: dict) -> tuple:
    """``items[i]``: ``frame`` (the request's image), ``logits`` (the (V,)
    rows the captioner computed: its prefill's, then each decode step's)
    and ``tokens`` (the generated ids through the first eos). Per request,
    the reference's one full forward over [BOS; patches; prompt; tokens] in
    fp32. Returns ({name: value}, {i: the caption the reference decodes
    from the tokens}, {name: value} printed only).

    ``cap_prefill_gap``: the largest |program - reference| over the prefill
    logits, over the reference logits' std. ``cap_decode_gap``: the same
    over every decode step's logits (the KV cache's path). Both see a lower
    precision. ``cap_greedy_gap_max``: at each generated position, the
    reference's best logit less its logit at the program's token, over
    that position's std: zero where the program's greedy choice is the
    reference's, at most about the logits' error where rounding flips a
    near tie, and several stds for a token altered where it is produced."""
    from benchmark.reference import clip as ref_clip
    from benchmark.reference import moondream as ref_md
    from benchmark.reference import resize

    ref_clip.no_tf32()
    tree = {k: w.float() for k, w in make_weights(cc, seed, device).items()}
    bpe = tokenizer(cc)
    ids = prompt_ids(cc, bpe)
    size = cc["vision_config"]["image_size"]
    out = {"cap_prefill_gap": 0.0, "cap_decode_gap": 0.0, "cap_greedy_gap_max": 0.0}
    n_gaps, flips, captions = 0, 0, {}
    for i, it in items.items():
        toks = list(it["tokens"])
        captions[i] = bpe.decode(toks).strip()
        pixels = resize.squash_pixels(it["frame"], size, device)[None]
        img = ref_md.encode_image(tree, cc, pixels)[0]
        ref = ref_md.logits(tree, cc, img, ids + toks[:-1], len(toks))
        std = ref.std(dim=-1)
        got = torch.stack(list(it["logits"][: len(toks)])).to(device).float()
        gap = (got - ref[: len(got)]).abs().max(-1).values / std[: len(got)]
        out["cap_prefill_gap"] = max(out["cap_prefill_gap"], float(gap[0]))
        if len(got) > 1:
            out["cap_decode_gap"] = max(out["cap_decode_gap"], float(gap[1:].max()))
        g = (ref.max(-1).values - ref.gather(1, torch.as_tensor(toks, device=device)[:, None])[:, 0]) / std
        out["cap_greedy_gap_max"] = max(out["cap_greedy_gap_max"], float(g.max()))
        n_gaps += len(toks)
        flips += int((g > 0).sum())
        if len(got) != len(toks):
            out["cap_decode_gap"] = float("inf")  # a step whose logits never came
    del tree
    return out, captions, {"cap_greedy_flips": float(flips), "cap_tokens_checked": float(n_gaps)}
