"""The Moondream reference against the port at tiny-md on the CPU, with
the benchmark's seeded weights installed in the port's captioner: the
port's prefill, then decoding through its KV cache, agrees in logits at
every position with the reference's one full forward over the same ids;
the vision tower and projector agree too, from the same frame through
each side's own preprocessing. And the reference's tokenizer gives the
port's ids for the caption prompt and the port's text for the ids."""

import json

import numpy as np
import pytest
import torch

from benchmark.captioners import moondream as fam
from benchmark.lib import data
from benchmark.reference import moondream as ref_md
from benchmark.reference import resize
from gpu_bench_support import DATA

CC = json.loads((DATA / "tiny-clip-md.json").read_text())["captioner"]
# Both sides compute in fp32: the gaps are summation order (the cache's
# attention against the full forward's, the packed projection) and
# the port's resize matrices held in fp32 against the reference's
# float64, about 1e-6 of the logits' spread; 1e-4 leaves room for that
# and is far below what a wrong position or a dropped term moves
# (0.3 and more in the planted faults).
TOL = 1e-4
STEPS = 12


@pytest.fixture(scope="module")
def served(tmp_path_factory, monkeypatch_module):
    inputs = tmp_path_factory.mktemp("inputs")
    for k, v in fam.settings(CC, inputs).items():
        monkeypatch_module.setenv(k, v)
    return fam.build(CC, 5, "cpu", inputs)


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_prefill_and_cached_decode_match_the_full_forward(served):
    from imatch_tpu_torch.models.moondream.model import decoder_forward, embed_tokens, lm_logits

    cap = served
    frame = data.make_frames([[40, 30]], 1, 6, "cpu")[0]
    feats = torch.from_numpy(cap.encode_image(frame)["features"])[None]
    ids = fam.prompt_ids(CC, fam.tokenizer(CC))
    logits, cache, pos = cap._prefill(feats, torch.tensor([ids]), STEPS)
    got, toks = [logits[0]], []
    for _ in range(STEPS - 1):
        toks.append(int(got[-1].argmax()))
        h, cache = decoder_forward(cap.model, embed_tokens(cap.model, torch.tensor([[toks[-1]]])), cache, pos)
        got.append(lm_logits(cap.model, h)[0, 0])
        pos += 1
    tree = {k: w.float() for k, w in fam.make_weights(CC, 5, "cpu").items()}
    pixels = resize.squash_pixels(frame, CC["vision_config"]["image_size"])[None]
    img = ref_md.encode_image(tree, CC, pixels)[0]
    assert float((img - feats[0]).abs().max() / img.std()) < TOL
    want = ref_md.logits(tree, CC, img, ids + toks, STEPS)
    gap = (torch.stack(got) - want).abs().max(-1).values / want.std(-1)
    assert float(gap.max()) < TOL, gap


def test_prompt_ids_and_caption_text_match_the_port(served):
    cap = served
    bpe = fam.tokenizer(CC)
    assert fam.prompt_ids(CC, bpe) == cap._prompt_id_list(fam.PROMPT, max_new=fam.MAX_NEW)
    ids = np.random.default_rng(3).integers(0, CC["text_config"]["vocab_size"], 64).tolist()
    assert bpe.decode(ids) == cap.tokenizer.decode(ids)
    text = "a red drill, 42 times\n\nAnswer: zebra"
    assert bpe.encode(text) == cap.tokenizer.encode(text)
