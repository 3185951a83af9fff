"""The Moondream port (imatch_tpu_torch/models/moondream) against the JAX
package, on the CPU.

Weights: JAX's ``init_md_params(jax.random.key(0), cfg)`` as numpy,
loaded by ``md_params_from_numpy``; JAX runs on the CPU as
tests/test_moondream.py runs it (attention through XLA), the port its
plain versions, both in fp32. Configs: ``tiny-md`` (head dim 8) and DH72,
built here, with the moondream2 vision tower's head dim 72 and 25
patches, a count that is not a multiple of 16.

Tolerances: vision features rtol/atol 1e-5 and prefill logits 1e-4 (fp32
sums in another order, through a few layers); greedy tokens, lengths and
yes/no answers equal; the port against itself (packed against unpacked,
cache-free against cached, a prefill against one token at a time) at the
bars tests/test_moondream.py holds JAX to. The framework-free copies
(configs, the GPT-2 tokenizer, the converter) give the same fields, ids
and trees as their originals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imatch_tpu.models.moondream import configs as jax_configs
from imatch_tpu.models.moondream.convert import convert_md_state_dict as jax_convert
from imatch_tpu.models.moondream.generate import (
    greedy_generate as jax_greedy,
    prefill as jax_prefill,
    vqa_yes_no as jax_vqa,
)
from imatch_tpu.models.moondream.model import (
    encode_image_features as jax_encode,
    init_md_params,
)
from imatch_tpu.ops.tokenizer_gpt2 import GPT2Tokenizer as JaxGPT2Tokenizer
from imatch_tpu_torch.models.moondream import configs
from imatch_tpu_torch.models.moondream.bridge import md_params_from_numpy
from imatch_tpu_torch.models.moondream.convert import convert_md_state_dict
from imatch_tpu_torch.models.moondream.generate import (
    finish_gen,
    gen_segment,
    greedy_generate,
    init_gen_state,
    prefill,
    vqa_yes_no,
)
from imatch_tpu_torch.models.moondream.model import (
    decoder_forward,
    embed_tokens,
    encode_image_features,
    init_cache,
    lm_logits,
)
from imatch_tpu_torch.ops.tokenizer_gpt2 import GPT2Tokenizer


def _dh72(mod):
    """image 70 / patch 14 -> 25 patches; width 144 over 2 heads -> Dh 72,
    in the tower and the decoder."""
    return mod.MoondreamConfig(
        name="dh72",
        vision=mod.MDVisionConfig(
            image_size=70, patch_size=14, hidden_size=144, num_layers=2, num_heads=2, mlp_size=96
        ),
        text=mod.MDTextConfig(
            vocab_size=300, hidden_size=144, num_layers=2, num_heads=2, rotary_dim=32,
            mlp_size=96, max_seq=128, eos_token_id=257, bos_token_id=256,
        ),
        proj_hidden=64,
    )


CONFIGS = {
    "tiny-md": (jax_configs.TINY_MD, configs.TINY_MD),
    "dh72": (_dh72(jax_configs), _dh72(configs)),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(jax cfg, port cfg, jax params, port model packed, port unpacked)."""
    jcfg, pcfg = CONFIGS[request.param]
    jparams = init_md_params(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.array, jparams)
    return (
        jcfg,
        pcfg,
        jparams,
        md_params_from_numpy(tree, pcfg),
        md_params_from_numpy(tree, pcfg, packed=False),
    )


def _feats(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.vision.num_patches, cfg.text.hidden_size)).astype(np.float32)


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (b, s))
    toks[:, 0] = cfg.text.bos_token_id
    return toks


def test_configs_equal_field_by_field():
    assert sorted(configs.MD_CONFIGS) == sorted(jax_configs.MD_CONFIGS)
    for name, cfg in configs.MD_CONFIGS.items():
        ref = jax_configs.get_md_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert configs.get_md_config(name) is cfg
        assert cfg.vision.num_patches == ref.vision.num_patches
        assert (cfg.vision.head_dim, cfg.text.head_dim) == (ref.vision.head_dim, ref.text.head_dim)
    assert configs.MOONDREAM2.vision.num_patches == 729 and configs.MOONDREAM2.vision.head_dim == 72


def _bpe_files(tmp_path):
    """A small GPT-2-layout vocab: the 256 byte tokens, a few merges,
    <|endoftext|> last."""
    from imatch_tpu_torch.ops.tokenizer import bytes_to_unicode

    b2u = bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    merges = [("Y", "e"), ("Ye", "s"), ("Ġ", "Y"), ("ĠY", "es"), ("N", "o"), ("y", "e"), ("ye", "s")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    import json

    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    return str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")


@pytest.mark.parametrize("kind", ["byte_fallback", "from_files"])
def test_gpt2_tokenizer_ids_equal(kind, tmp_path):
    if kind == "byte_fallback":
        port, ref = GPT2Tokenizer.byte_fallback(), JaxGPT2Tokenizer.byte_fallback()
    else:
        files = _bpe_files(tmp_path)
        port, ref = GPT2Tokenizer.from_files(*files), JaxGPT2Tokenizer.from_files(*files)
    for text in ("Hello, Yes/No é中", "Yes or No: is there a red drill? yes no", "\n\nAnswer:"):
        ids = port.encode(text)
        assert ids == ref.encode(text)
        assert port.decode(ids) == ref.decode(ids)
    assert (port.bos_id, port.eos_id, port.vocab_size) == (ref.bos_id, ref.eos_id, ref.vocab_size)
    for word in ("yes", "no", "maybe"):
        assert port.token_ids_for_word(word) == ref.token_ids_for_word(word)


def _synthetic_hf_state_dict(cfg):
    """tests/test_moondream.py:115's state dict in the moondream2 naming."""
    v, t = cfg.vision, cfg.text
    rng = np.random.default_rng(0)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {}
    vis = "vision_encoder.encoder.model.visual"
    sd[f"{vis}.patch_embed.linear.weight"] = r(v.hidden_size, 3 * v.patch_size * v.patch_size)
    sd[f"{vis}.patch_embed.linear.bias"] = r(v.hidden_size)
    sd[f"{vis}.pos_embed"] = r(1, v.num_patches, v.hidden_size)
    for i in range(v.num_layers):
        p = f"{vis}.blocks.{i}"
        for n, shape in (
            ("norm1.weight", (v.hidden_size,)), ("norm1.bias", (v.hidden_size,)),
            ("attn.qkv.weight", (3 * v.hidden_size, v.hidden_size)), ("attn.qkv.bias", (3 * v.hidden_size,)),
            ("attn.proj.weight", (v.hidden_size, v.hidden_size)), ("attn.proj.bias", (v.hidden_size,)),
            ("norm2.weight", (v.hidden_size,)), ("norm2.bias", (v.hidden_size,)),
            ("mlp.fc1.weight", (v.mlp_size, v.hidden_size)), ("mlp.fc1.bias", (v.mlp_size,)),
            ("mlp.fc2.weight", (v.hidden_size, v.mlp_size)), ("mlp.fc2.bias", (v.hidden_size,)),
        ):
            sd[f"{p}.{n}"] = r(*shape)
    sd[f"{vis}.norm.weight"] = r(v.hidden_size)
    sd[f"{vis}.norm.bias"] = r(v.hidden_size)
    proj = "vision_encoder.projection"
    sd[f"{proj}.mlp.fc1.weight"] = r(cfg.proj_hidden, v.hidden_size)
    sd[f"{proj}.mlp.fc1.bias"] = r(cfg.proj_hidden)
    sd[f"{proj}.mlp.fc2.weight"] = r(t.hidden_size, cfg.proj_hidden)
    sd[f"{proj}.mlp.fc2.bias"] = r(t.hidden_size)
    txt = "text_model.transformer"
    sd[f"{txt}.embd.wte.weight"] = r(t.vocab_size, t.hidden_size)
    for i in range(t.num_layers):
        p = f"{txt}.h.{i}"
        for n, shape in (
            ("ln.weight", (t.hidden_size,)), ("ln.bias", (t.hidden_size,)),
            ("mixer.Wqkv.weight", (3 * t.hidden_size, t.hidden_size)), ("mixer.Wqkv.bias", (3 * t.hidden_size,)),
            ("mixer.out_proj.weight", (t.hidden_size, t.hidden_size)), ("mixer.out_proj.bias", (t.hidden_size,)),
            ("mlp.fc1.weight", (t.mlp_size, t.hidden_size)), ("mlp.fc1.bias", (t.mlp_size,)),
            ("mlp.fc2.weight", (t.hidden_size, t.mlp_size)), ("mlp.fc2.bias", (t.hidden_size,)),
        ):
            sd[f"{p}.{n}"] = r(*shape)
    sd["text_model.lm_head.ln.weight"] = r(t.hidden_size)
    sd["text_model.lm_head.ln.bias"] = r(t.hidden_size)
    sd["text_model.lm_head.linear.weight"] = r(t.vocab_size, t.hidden_size)
    sd["text_model.lm_head.linear.bias"] = r(t.vocab_size)
    return sd


def test_converter_gives_the_same_tree_and_runs():
    jcfg, pcfg = CONFIGS["tiny-md"]
    sd = _synthetic_hf_state_dict(pcfg)
    got = convert_md_state_dict(sd, pcfg)
    want = jax_convert(sd, jcfg)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # the converted tree loads and runs in the port as in JAX; its weights
    # are unit normals, so the features reach ~100 and the bar is 1e-5 of
    # their scale
    pixels = np.zeros((1, pcfg.vision.image_size, pcfg.vision.image_size, 3), np.float32)
    feats = encode_image_features(md_params_from_numpy(got, pcfg), torch.from_numpy(pixels))
    ref = np.asarray(jax_encode(jax.tree.map(jnp.asarray, want), jnp.asarray(pixels), jcfg))
    np.testing.assert_allclose(feats.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_vision_features_match_jax(pair):
    jcfg, pcfg, jparams, model, _ = pair
    size = pcfg.vision.image_size
    pixels = np.random.default_rng(5).uniform(-1, 1, (3, size, size, 3)).astype(np.float32)
    got = encode_image_features(model, torch.from_numpy(pixels)).numpy()
    want = np.asarray(jax_encode(jparams, jnp.asarray(pixels), jcfg))
    assert got.shape == (3, pcfg.vision.num_patches, pcfg.text.hidden_size)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_cache", [True, False])
def test_prefill_logits_match_jax(pair, use_cache):
    jcfg, pcfg, jparams, model, _ = pair
    feats, toks = _feats(pcfg, 2, 6), _tokens(pcfg, 2, 7, 6)
    got, cache, pos = prefill(
        model, torch.from_numpy(feats), torch.from_numpy(toks), max_new=8, use_cache=use_cache
    )
    want, jcache, jpos = jax_prefill(
        jparams, jcfg, jnp.asarray(feats), jnp.asarray(toks, jnp.int32), max_new=8, use_cache=use_cache
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert [pos, pos] == np.asarray(jpos).tolist()
    if use_cache:
        # the same 128-slot bucket, JAX's (L, B, H, Dh, S) laid out (L, B, H, S, Dh)
        np.testing.assert_allclose(
            cache.k.numpy(), np.asarray(jcache.k).transpose(0, 1, 2, 4, 3), rtol=1e-4, atol=1e-4
        )
    else:
        assert cache is None and jcache is None


def test_cachefree_prefill_matches_cached(pair):
    """tests/test_moondream.py:335 on the port."""
    _, pcfg, _, model, _ = pair
    feats = torch.from_numpy(_feats(pcfg, 3, 21))
    toks = torch.from_numpy(_tokens(pcfg, 3, 4, 21))
    l_cached, cache, pos = prefill(model, feats, toks, max_new=1)
    l_free, no_cache, pos2 = prefill(model, feats, toks, use_cache=False)
    assert no_cache is None and pos == pos2
    torch.testing.assert_close(l_cached, l_free, rtol=1e-6, atol=1e-6)


def test_prefill_matches_incremental_decode(pair):
    """tests/test_moondream.py:31 on the port: one prefill through the
    cache equals the same tokens fed one at a time."""
    _, pcfg, _, model, _ = pair
    b, s = 2, 7
    embeds = embed_tokens(model, torch.from_numpy(np.random.default_rng(0).integers(0, 256, (b, s))))
    h_full, _ = decoder_forward(model, embeds, init_cache(pcfg, b, device="cpu", dtype=torch.float32), 0)
    cache = init_cache(pcfg, b, device="cpu", dtype=torch.float32)
    outs = []
    for i in range(s):
        h, cache = decoder_forward(model, embeds[:, i : i + 1], cache, i)
        outs.append(h)
    torch.testing.assert_close(h_full, torch.cat(outs, dim=1), rtol=2e-4, atol=2e-5)


def test_packed_layers_match_unpacked(pair):
    """tests/test_moondream.py:199 on the port."""
    _, pcfg, _, packed, unpacked = pair
    assert all(hasattr(layer, "qkv_mlp") and not hasattr(layer, "q") for layer in packed.text.layers)
    assert all(not hasattr(layer, "qkv_mlp") for layer in unpacked.text.layers)
    feats = torch.from_numpy(_feats(pcfg, 2, 3))
    toks = torch.tensor([[256, 5, 9, 2], [256, 7, 4, 8]])
    l0, c0, p0 = prefill(unpacked, feats, toks, max_new=8)
    l1, c1, p1 = prefill(packed, feats, toks, max_new=8)
    torch.testing.assert_close(l0, l1, rtol=1e-5, atol=1e-5)
    r0 = greedy_generate(unpacked, l0, c0, p0, max_new=8)
    r1 = greedy_generate(packed, l1, c1, p1, max_new=8)
    assert torch.equal(r0.tokens, r1.tokens)


def test_greedy_generate_equals_jax(pair):
    jcfg, pcfg, jparams, model, _ = pair
    feats, toks = _feats(pcfg, 2, 1), _tokens(pcfg, 2, 5, 1)
    logits, cache, pos = prefill(model, torch.from_numpy(feats), torch.from_numpy(toks), max_new=12)
    got = greedy_generate(model, logits, cache, pos, max_new=12)
    jl, jc, jp = jax_prefill(jparams, jcfg, jnp.asarray(feats), jnp.asarray(toks, jnp.int32), max_new=12)
    want = jax_greedy(jparams, jcfg, jl, jc, jp, max_new=12)
    assert got.tokens.shape == (2, 12) and got.lengths.shape == (2,)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


def test_vqa_yes_no_equals_jax(pair):
    jcfg, pcfg, jparams, model, _ = pair
    feats, toks = _feats(pcfg, 6, 2), _tokens(pcfg, 6, 4, 2)
    for yes, no in (((89, 121), (78, 110)), ((1,), (2,))):
        got = vqa_yes_no(model, torch.from_numpy(feats), torch.from_numpy(toks), yes, no)
        want = jax_vqa(jparams, jcfg, jnp.asarray(feats), jnp.asarray(toks, jnp.int32), yes, no)
        assert got.dtype == torch.bool and got.shape == (6,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seg", [1, 3, 4, 11, 16])
def test_segmented_decode_matches_monolithic(pair, seg):
    """tests/test_moondream.py:403 on the port, every segment size."""
    _, pcfg, _, model, _ = pair
    feats = torch.from_numpy(_feats(pcfg, 2, 3))
    toks = torch.from_numpy(_tokens(pcfg, 2, 5, 3))
    logits, cache, pos = prefill(model, feats, toks, max_new=11)
    ref = greedy_generate(model, logits, cache, pos, max_new=11)
    logits, cache, pos = prefill(model, feats, toks, max_new=11)
    state = init_gen_state(model, logits, cache, pos, max_new=11)
    for _ in range(-(-11 // seg)):
        state = gen_segment(model, state, steps=seg, max_new=11)
    got = finish_gen(state, eos=pcfg.text.eos_token_id, max_new=11)
    assert torch.equal(got.tokens, ref.tokens) and torch.equal(got.lengths, ref.lengths)


def test_lm_logits_and_embeddings_are_fp32_and_compute_dtype(pair):
    _, pcfg, _, model, _ = pair
    h = torch.randn(1, 2, pcfg.text.hidden_size)
    assert lm_logits(model, h).dtype == torch.float32
    assert embed_tokens(model, torch.tensor([[1, 2]])).dtype == model.dtype == torch.float32


# -- the runtime's batch paths (tests/test_moondream.py:256, :287, :304, :436)


@pytest.fixture(scope="module")
def tiny_tree():
    return jax.tree.map(np.array, init_md_params(jax.random.key(0), jax_configs.TINY_MD))


def _svc(tiny_tree):
    from imatch_tpu_torch.models.moondream.runtime import MoondreamTorch

    return MoondreamTorch(config="tiny-md", params=tiny_tree, device="cpu")


def _imgs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]


def test_batch_paths_chunk_and_match_single(tiny_tree, monkeypatch):
    """Chunks of 2 over 5 images (2 + 2 + 1): the padded rows do not leak
    into the results, which equal the single-image paths'."""
    for var in ("IMATCH_VLM_CAP_CHUNK", "IMATCH_VLM_VQA_CHUNK", "IMATCH_VLM_ENC_CHUNK"):
        monkeypatch.setenv(var, "2")
    svc = _svc(tiny_tree)
    imgs = _imgs(9, [(40, 56)] * 5)
    encs = svc.encode_image_batch(imgs)
    for e, im in zip(encs, imgs):
        np.testing.assert_allclose(e["features"], svc.encode_image(im)["features"], rtol=2e-4, atol=2e-5)
    caps = svc.caption_batch(encs, max_new=6)
    assert len(caps) == 5
    assert caps == [svc.caption(e, max_new=6)["caption"] for e in encs]
    q = "Yes or No: is this a drill?"
    answers = svc.query_yes_no_batch(encs, q)
    assert answers == [svc.query(e, q)["answer"] == "Yes" for e in encs]


def test_batch_vqa_long_question_budgeted(tiny_tree):
    """A question long enough to overflow max_seq is cut by the shared
    prompt budget in the batch path too, and agrees with query()."""
    svc = _svc(tiny_tree)
    enc = svc.encode_image(_imgs(11, [(32, 32)])[0])
    q = "Yes or No: " + "is there a very shiny red cordless drill " * 20
    single = svc.query(enc, q)["answer"]
    assert svc.query_yes_no_batch([enc, enc, enc], q) == [single == "Yes"] * 3
    assert len(svc.caption_batch([enc], max_new=4)) == 1


def test_encode_batch_mixed_geometry_one_dispatch(tiny_tree, monkeypatch):
    """Every geometry preprocesses to one (S, S, 3) shape: five sizes in
    a chunk of 8 are one tower call of 8 rows (5 padded to the bucket)."""
    import imatch_tpu_torch.models.moondream.runtime as runtime

    monkeypatch.setenv("IMATCH_VLM_ENC_CHUNK", "8")
    svc = _svc(tiny_tree)
    calls = []
    orig = runtime.encode_image_features

    def counting(model, pixels):
        calls.append(pixels.shape[0])
        return orig(model, pixels)

    monkeypatch.setattr(runtime, "encode_image_features", counting)
    imgs = _imgs(12, [(40, 56), (64, 32), (33, 33), (50, 20), (28, 80)])
    encs = svc.encode_image_batch(imgs)
    assert calls == [8]
    for im, e in zip(imgs, encs):
        np.testing.assert_allclose(e["features"], svc.encode_image(im)["features"], rtol=2e-4, atol=2e-5)


def test_caption_batch_segmented_matches(tiny_tree, monkeypatch):
    monkeypatch.setenv("IMATCH_MD_SEG", "0")
    svc = _svc(tiny_tree)
    encs = svc.encode_image_batch(_imgs(9, [(40 + 8 * i, 52) for i in range(3)]))
    mono = svc.caption_batch(encs, max_new=10)
    monkeypatch.setenv("IMATCH_MD_SEG", "4")
    assert svc.caption_batch(encs, max_new=10) == mono
