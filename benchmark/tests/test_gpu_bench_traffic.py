"""The generators: the same seed gives the same inputs; another seed
gives other data with the same sizes and arrivals."""

import numpy as np
import torch

from benchmark.lib import data

TINY = {
    "projection_dim": 8,
    "vision_config": {"hidden_size": 16, "intermediate_size": 64, "num_hidden_layers": 1, "patch_size": 8,
                      "image_size": 16, "num_attention_heads": 2},
    "text_config": {"hidden_size": 8, "intermediate_size": 32, "num_hidden_layers": 1, "num_attention_heads": 2,
                    "max_position_embeddings": 6, "vocab_size": 20},
}


def test_texts_deterministic_and_same_word_counts():
    a = data.make_texts(3, 16, 3, 60, 1.2, seed=2**31 + 5)
    b = data.make_texts(3, 16, 3, 60, 1.2, seed=2**31 + 5)
    c = data.make_texts(3, 16, 3, 60, 1.2, seed=6)
    assert a == b and a != c
    for req in a + c:
        assert len(set(req)) == len(req)
        assert sorted(len(t.split()) for t in req) == sorted(data.word_counts(16, 3, 60, 1.2))
    counts = data.word_counts(256, 3, 60, 1.2)
    assert counts.min() == 3 and counts.max() == 60


def test_arrivals_same_gaps_other_order():
    a, b, c = data.arrivals(40, 10, 1), data.arrivals(40, 10, 1), data.arrivals(40, 10, 2)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert len(a) == len(c) == 400
    assert 0 < a[0] and a[-1] < 10 and np.all(np.diff(a) > 0)
    # the same gaps, in another order (the first gap is the first time)
    assert np.allclose(np.sort(np.diff(np.r_[0, a])), np.sort(np.diff(np.r_[0, c])))


def test_rows_and_weights_deterministic():
    r1, r2, r3 = data.make_rows(64, 8, 3, "cpu"), data.make_rows(64, 8, 3, "cpu"), data.make_rows(64, 8, 4, "cpu")
    assert torch.equal(r1, r2) and not torch.equal(r1, r3)
    assert torch.allclose(torch.linalg.vector_norm(r1, dim=1), torch.ones(64))
    w1 = data.make_weights(TINY, 4, "cpu", torch.float32)
    w2 = data.make_weights(TINY, 4, "cpu", torch.float32)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert torch.allclose(w1["vision.pre_ln.weight"], torch.ones(16), atol=0.2)
    assert abs(float(w1["vision.encoder.layers.0.fc1.weight"].std()) - 16**-0.5) < 0.05
