"""The references against the port at a tiny CLIP on the CPU: the same
weights and texts give the same tokens and query embeddings, and the
brute force gives the exact top k. The port is imported here only; the
references import none of it."""

import json

import numpy as np
import pytest
import torch

from benchmark.lib import data, program
from benchmark.reference import clip as ref_clip
from benchmark.reference import tokenizer as ref_tok
from benchmark.reference import topk as ref_topk
from gpu_bench_support import DATA

CFG = dict(json.loads((DATA / "tiny-clip.json").read_text()), name="tiny-clip")


@pytest.fixture(scope="module")
def served():
    weights = data.make_weights(CFG, 3, "cpu", torch.float32)
    return program.embedder(CFG, weights, "cpu"), ref_clip.fp32_tree(weights)


def _texts():
    return data.make_texts(1, 6, 3, 12, 1.2, 8)[0] + ["Café, the <|endoftext|> 42!"]


def test_text_embeddings_and_tokens_match(served):
    emb, tree = served
    texts = _texts()
    assert np.array_equal(emb._tokenize(texts), ref_tok.encode_batch(texts, 16))
    got = emb.embed_texts(texts)
    want = ref_clip.encode_text(tree, CFG, torch.from_numpy(ref_tok.encode_batch(texts, 16)), ref_tok.EOS).numpy()
    assert np.abs(got - want).max() < 1e-5


def test_int8_control_is_further_than_fp32(served):
    _, tree = served
    ids = torch.from_numpy(ref_tok.encode_batch(_texts(), 16))
    gap = torch.linalg.vector_norm(
        ref_clip.encode_text(tree, CFG, ids, ref_tok.EOS, int8=True) - ref_clip.encode_text(tree, CFG, ids, ref_tok.EOS), dim=1)
    assert float(gap.max()) > 1e-3


def test_image_embeddings_match(served):
    """The image tower from frames of several geometries, each side from
    its own preprocessing: the program's fp32 resize matrices against the
    reference's float64 ones can round a pixel to the next uint8 level."""
    from benchmark.reference import resize

    emb, tree = served
    frames = data.make_frames([[40, 30], [30, 50], [64, 64]], 3, 9, "cpu")
    got = emb.embed_images(frames)
    pixels = torch.stack([resize.clip_pixels(f, CFG["vision_config"]["image_size"]) for f in frames])
    want = ref_clip.encode_image(tree, CFG, pixels).numpy()
    assert np.abs(got - want).max() < 1e-3
    int8 = ref_clip.encode_image(tree, CFG, pixels, int8=True).numpy()
    assert np.abs(int8 - want).max() > 3e-3


def test_brute_force_topk_is_exact():
    rows = data.make_rows(300, 16, 4, "cpu")
    queries = data.make_rows(5, 16, 5, "cpu")
    scores, idx = ref_topk.topk(rows, queries, 7, block=2)
    full = queries @ rows.T
    want, want_idx = torch.topk(full, 7, dim=1)
    assert torch.equal(idx, want_idx) and torch.allclose(scores, want)
    assert torch.allclose(ref_topk.scores_of(rows, queries, idx), want)
