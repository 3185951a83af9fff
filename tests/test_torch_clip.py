"""CLIP towers and weight bridge of the PyTorch port against the JAX package.

Weights come from the JAX init (``init_params(jax.random.key(0), ...)``)
carried across as numpy through ``models/clip/bridge.py``; both sides run
fp32 on the CPU, so the bar is cosine >= 0.9999 per row. The port's
copies of the configs and the HF converter are held to the originals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imatch_tpu.models.clip import configs as jax_configs
from imatch_tpu.models.clip import convert as jax_convert
from imatch_tpu.models.clip.model import encode_image as jax_encode_image
from imatch_tpu.models.clip.model import encode_text as jax_encode_text
from imatch_tpu.models.clip.model import init_params
from imatch_tpu_torch.models.clip import configs, convert
from imatch_tpu_torch.models.clip.bridge import params_from_numpy, params_to_numpy
from imatch_tpu_torch.models.clip.model import encode_image, encode_text

TINY = configs.TINY


def _cut(cfg, layers):
    return dataclasses.replace(
        cfg,
        vision=dataclasses.replace(cfg.vision, num_layers=layers),
        text=dataclasses.replace(cfg.text, num_layers=layers),
    )


@pytest.fixture(scope="module")
def tiny_tree():
    return jax.tree.map(np.asarray, init_params(jax.random.key(0), jax_configs.TINY))


@pytest.fixture(scope="module")
def tiny_model(tiny_tree):
    return params_from_numpy(tiny_tree, TINY)


def _trees_equal(a, b):
    return jax.tree.all(jax.tree.map(np.array_equal, a, b))


@pytest.mark.parametrize("name", ["tiny", "vit-b32"])
def test_bridge_round_trip_exact(name, tiny_tree):
    if name == "tiny":
        tree, cfg = tiny_tree, TINY
    else:  # depth cut to 2 layers a tower
        tree = jax.tree.map(
            np.asarray,
            init_params(jax.random.key(1), _cut(jax_configs.get_config(name), 2)),
        )
        cfg = _cut(configs.get_config(name), 2)
    back = params_to_numpy(params_from_numpy(tree, cfg))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert _trees_equal(back, tree)


def test_configs_copy_matches_original():
    assert set(configs.CONFIGS) == set(jax_configs.CONFIGS)
    for name, cfg in configs.CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_configs.CONFIGS[name])


def test_encode_image_matches_jax(tiny_tree, tiny_model):
    px = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax_encode_image(tiny_tree, jnp.asarray(px), jax_configs.TINY))
    got = encode_image(tiny_model, torch.from_numpy(px)).numpy()
    assert got.shape == (4, TINY.projection_dim) and got.dtype == np.float32
    assert (np.sum(ref * got, axis=1) >= 0.9999).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def _ids(rows, width=16, eos=98, bos=97):
    out = np.full((len(rows), width), eos, np.int32)
    for r, toks in enumerate(rows):
        out[r, 0] = bos
        out[r, 1 : 1 + len(toks)] = toks
    return out


def test_encode_text_matches_jax(tiny_tree, tiny_model):
    ids = _ids([[1, 2, 3], list(range(5, 18)), [], [40] * 6])
    ref = np.asarray(jax_encode_text(tiny_tree, jnp.asarray(ids), jax_configs.TINY))
    got = encode_text(tiny_model, torch.from_numpy(ids).long()).numpy()
    assert (np.sum(ref * got, axis=1) >= 0.9999).all()


def test_text_pools_at_first_eos(tiny_tree, tiny_model):
    """eos padding: tokens after the FIRST eos never reach the pooled
    state (causal mask), so rows that differ only there embed the same;
    a different eos override pools elsewhere, as in JAX."""
    a = _ids([[1, 2, 3]])
    b = a.copy()
    b[0, 5:9] = [7, 8, 9, 10]  # after the first eos (position 4)
    ea = encode_text(tiny_model, torch.from_numpy(a).long()).numpy()
    eb = encode_text(tiny_model, torch.from_numpy(b).long()).numpy()
    np.testing.assert_allclose(ea, eb, rtol=1e-6, atol=1e-6)
    got = encode_text(tiny_model, torch.from_numpy(b).long(), eos_token_id=9).numpy()
    ref = np.asarray(
        jax_encode_text(tiny_tree, jnp.asarray(b), jax_configs.TINY, eos_token_id=9)
    )
    assert (np.sum(ref * got, axis=1) >= 0.9999).all()
    assert not np.allclose(got, ea, atol=1e-4)


SMALL_248 = configs.CLIPConfig(
    name="small-248",
    vision=configs.VisionConfig(
        image_size=64, patch_size=16, hidden_size=128, num_layers=4, num_heads=4
    ),
    text=configs.TextConfig(
        vocab_size=512, max_positions=248, hidden_size=96, num_layers=4, num_heads=4,
        eos_token_id=511,
    ),
    projection_dim=64,
)


def _hf_model(cfg):
    """A random-init ``transformers.CLIPModel`` of ``cfg``'s geometry."""
    transformers = pytest.importorskip("transformers")
    hf = transformers.CLIPConfig(
        text_config=transformers.CLIPTextConfig(
            vocab_size=cfg.text.vocab_size,
            hidden_size=cfg.text.hidden_size,
            intermediate_size=cfg.text.mlp_size,
            num_hidden_layers=cfg.text.num_layers,
            num_attention_heads=cfg.text.num_heads,
            max_position_embeddings=cfg.text.max_positions,
            eos_token_id=cfg.text.eos_token_id,
            bos_token_id=cfg.text.eos_token_id - 1,
            hidden_act=cfg.text.hidden_act,
        ).to_dict(),
        vision_config=transformers.CLIPVisionConfig(
            hidden_size=cfg.vision.hidden_size,
            intermediate_size=cfg.vision.mlp_size,
            num_hidden_layers=cfg.vision.num_layers,
            num_attention_heads=cfg.vision.num_heads,
            image_size=cfg.vision.image_size,
            patch_size=cfg.vision.patch_size,
            hidden_act=cfg.vision.hidden_act,
        ).to_dict(),
        projection_dim=cfg.projection_dim,
    )
    torch.manual_seed(0)
    return transformers.CLIPModel(hf).eval()


def test_hf_converter_copy_matches_original():
    sd = _hf_model(TINY).state_dict()
    ours = convert.convert_hf_state_dict(sd, TINY)
    theirs = jax_convert.convert_hf_state_dict(sd, jax_configs.TINY)
    assert _trees_equal(ours, theirs)
    pe = np.random.default_rng(0).standard_normal((77, 8)).astype(np.float32)
    assert np.array_equal(
        convert._stretch_positions(pe, 248), jax_convert._stretch_positions(pe, 248)
    )


@pytest.mark.parametrize("cfg", [TINY, SMALL_248], ids=lambda c: c.name)
def test_towers_match_hf_clip(cfg):
    """The port's towers on an HF checkpoint's weights against
    ``transformers.CLIPModel`` itself (tests/test_clip_parity.py's bar)."""
    hf = _hf_model(cfg)
    model = params_from_numpy(convert.convert_hf_state_dict(hf.state_dict(), cfg), cfg)
    rng = np.random.default_rng(0)
    px = rng.standard_normal((3, cfg.vision.image_size, cfg.vision.image_size, 3))
    px = px.astype(np.float32)
    ids = rng.integers(1, cfg.text.vocab_size - 2, size=(3, cfg.text.max_positions))
    for b, length in enumerate((2, 9, cfg.text.max_positions)):
        ids[b, length - 1 :] = cfg.text.eos_token_id
    with torch.no_grad():
        ref_img = hf.get_image_features(pixel_values=torch.from_numpy(px).permute(0, 3, 1, 2))
        ref_txt = hf.get_text_features(input_ids=torch.from_numpy(ids).long())
    ref_img = (ref_img / ref_img.norm(dim=1, keepdim=True)).numpy()
    ref_txt = (ref_txt / ref_txt.norm(dim=1, keepdim=True)).numpy()
    got_img = encode_image(model, torch.from_numpy(px)).numpy()
    got_txt = encode_text(model, torch.from_numpy(ids).long()).numpy()
    assert np.sum(got_img * ref_img, axis=1).min() > 0.999
    assert np.sum(got_txt * ref_txt, axis=1).min() > 0.999
    np.testing.assert_allclose(got_img, ref_img, atol=2e-4)
    np.testing.assert_allclose(got_txt, ref_txt, atol=2e-4)


def test_embedder_loads_hf_checkpoint_directory(tmp_path):
    from imatch_tpu_torch.pipeline.embedder import ClipEmbedder

    hf = _hf_model(TINY)
    hf.save_pretrained(tmp_path)
    emb = ClipEmbedder(config=TINY, checkpoint=str(tmp_path), device="cpu")
    img = np.random.default_rng(0).integers(0, 256, (32, 32, 3), np.uint8)
    ours = emb.embed_image(img)
    from imatch_tpu_torch.ops.preprocess import preprocess_images

    pixels = preprocess_images([img], device=torch.device("cpu"), out_size=32)
    with torch.no_grad():
        ref = hf.get_image_features(pixel_values=pixels.permute(0, 3, 1, 2))[0]
    ref = (ref / ref.norm()).numpy()
    assert float(np.dot(ours, ref)) >= 0.999


def test_random_init_has_jax_init_layout_and_distribution(tiny_tree):
    """Without params or a checkpoint the port draws from a torch
    Generator: the JAX init's tree layout and shapes, unit LayerNorms,
    zero biases, normal(0.02) weights, and the same draw for one seed."""
    from imatch_tpu_torch.models.clip.model import init_random

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return params_to_numpy(
            init_random(TINY, device="cpu", dtype=torch.float32, generator=gen)
        )

    tree = draw(0)
    assert jax.tree.structure(tree) == jax.tree.structure(tiny_tree)
    assert jax.tree.all(jax.tree.map(lambda a, b: a.shape == b.shape, tree, tiny_tree))
    layers = tree["vision"]["layers"]
    assert (layers["ln1"]["scale"] == 1).all() and (layers["ln1"]["bias"] == 0).all()
    assert (layers["attn"]["bq"] == 0).all() and (layers["mlp"]["b2"] == 0).all()
    assert abs(float(tree["text"]["token_embedding"].std()) - 0.02) < 0.002
    assert _trees_equal(draw(0), tree) and not _trees_equal(draw(1), tree)
