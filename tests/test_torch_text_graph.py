"""The text tower as one CUDA graph per row bucket (pipeline/embedder.py
``_replay_text``).

On the CPU (counted in tier-1): the graph path stays off there and the
embeddings are ``encode_text``'s; the eligibility check refuses a CPU
device, data shards, model shards and a model row across processes; a
search leaves no graph counter in METRICS; and the graph cache drops its
graphs when the text tower's storage or the model changes, and only then
(the capture replaced by a stand-in).

On the card (every test skips without one, decided inside the ``card``
fixture): the replayed tower equals the eager one bit for bit at buckets
1, 32 and 256 for ViT-B/32's and LongCLIP's text widths, also after a
later replay of the same bucket; 8 threads embedding at once each get
their own texts' embeddings; an entry of the text LRU survives later
replays; new storage for the weights, or a new model, is read by the next
call; and each replay counts the tower's K2 launches, the capture none.
This file imports torch and the port only, so on the card it runs as

    python -m pytest tests/test_torch_text_graph.py --noconftest -q
"""

import threading

import numpy as np
import pytest
import torch

from imatch_tpu_torch.index.store import VectorStore
from imatch_tpu_torch.models.clip.configs import LONGCLIP_L14_248, TINY, VIT_B32, CLIPConfig
from imatch_tpu_torch.models.clip.model import cast_compute, encode_text, init_random
from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
from imatch_tpu_torch.parallel.sharding import shard_model
from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
from imatch_tpu_torch.pipeline.search import search_by_text_batch
from imatch_tpu_torch.utils.metrics import METRICS

# LongCLIP's text tower (768 wide, 248 positions) beside a tiny image tower
LONGCLIP_TEXT = CLIPConfig(name="longclip-text", vision=TINY.vision, text=LONGCLIP_L14_248.text, projection_dim=768)


def _texts(n, tag):
    return [f"{tag} photo {i}: a red drill beside {i * 7 % 13} blue boxes" for i in range(n)]


def _eager(emb, texts):
    ids = torch.from_numpy(np.asarray(emb._tokenize(texts), np.int64)).to(emb.device)
    return encode_text(emb.model, ids, eos_token_id=emb._model_eos)


# -- CPU ---------------------------------------------------------------------


@pytest.fixture
def cpu_emb():
    return ClipEmbedder(config=TINY, device="cpu")


def test_cpu_embedder_runs_eager_and_keeps_no_graph(cpu_emb):
    texts = _texts(4, "cpu")
    got = cpu_emb.embed_texts_device(texts)
    assert torch.equal(got, _eager(cpu_emb, texts))
    assert cpu_emb._text_graphs == {} and not cpu_emb._text_graph_eligible()


def _on_card_in_name(emb):
    emb.device = torch.device("cuda")  # the check reads the device only
    return emb


@pytest.mark.parametrize(
    "placement, eligible",
    [
        ("cpu", False),
        ("cuda", True),
        ("cuda-two-data-shards", False),
        ("cuda-model-shards", False),
        ("cuda-row-group", False),
    ],
)
def test_graph_eligibility(placement, eligible):
    emb = ClipEmbedder(config=TINY, device="cpu", mesh=["cpu", "cpu"] if "data-shards" in placement else None)
    if placement.startswith("cuda"):
        _on_card_in_name(emb)
    if placement == "cuda-model-shards":
        emb.model = shard_model(emb.model, ["cpu", "cpu"])
        assert len(emb.model.peers) == 1
    if placement == "cuda-row-group":
        emb.model.row_group = object()
    assert emb._text_graph_eligible() is eligible


class _State:
    def __init__(self, emb, store):
        self.embedder, self.store = emb, store

    def get_embedder(self):
        return self.embedder


def test_cpu_search_leaves_no_graph_counter(cpu_emb):
    store = VectorStore(dim=cpu_emb.dim, device="cpu")
    rows = np.random.default_rng(0).standard_normal((8, cpu_emb.dim)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    store.add(ids=[f"img_{i:016x}" for i in range(8)], embeddings=rows, metadatas=[{} for _ in range(8)])
    METRICS.reset()
    res = search_by_text_batch(_State(cpu_emb, store), _texts(3, "search"), limit=2)
    assert len(res) == 3 and all(len(r) == 2 for r in res)
    snap = METRICS.snapshot()
    assert snap["timings"]["embed.text"]["count"] == 1
    assert not [k for k in snap["counters"] if k.startswith("embed.text_graph")]


def _mutate(emb, how):
    text = emb.model.text
    with torch.no_grad():
        if how == "weights-copied-in-place":
            for p in text.parameters():
                p.copy_(p * 2)
        elif how == "new-storage":
            p = text.encoder.layers[0].fc1.weight
            p.data = p.data.clone()
        elif how == "cast-compute":
            cast_compute(emb.model, torch.bfloat16)
        elif how == "new-model":
            emb.model = init_random(emb.cfg, device=emb.device, dtype=torch.float32,
                                    generator=torch.Generator().manual_seed(1))


@pytest.mark.parametrize(
    "how, captures",
    [("weights-copied-in-place", 1), ("new-storage", 2), ("cast-compute", 2), ("new-model", 2)],
)
def test_graph_cache_drops_graphs_when_storage_moves(cpu_emb, monkeypatch, how, captures):
    made = []

    def capture(model, shape):
        made.append((model, shape))
        return object()

    monkeypatch.setattr(cpu_emb, "_capture_text", capture)
    shape = (2, TINY.text.max_positions)
    first = cpu_emb._text_graph(cpu_emb.model, shape)
    assert cpu_emb._text_graph(cpu_emb.model, shape) is first and len(made) == 1
    _mutate(cpu_emb, how)
    again = cpu_emb._text_graph(cpu_emb.model, shape)
    assert len(made) == captures and (again is first) == (captures == 1)
    assert made[-1][0] is cpu_emb.model and list(cpu_emb._text_graphs) == [shape]
    cpu_emb._text_graph(cpu_emb.model, shape)
    assert len(made) == captures


# -- the card ------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph path runs only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_embs(card):
    return {cfg.name: ClipEmbedder(config=cfg, device=card) for cfg in (VIT_B32, LONGCLIP_TEXT)}


@pytest.mark.parametrize("config", [VIT_B32.name, LONGCLIP_TEXT.name])
@pytest.mark.parametrize("bucket", [1, 32, 256])
def test_graph_equals_eager_bit_for_bit(card_embs, config, bucket):
    emb = card_embs[config]
    assert emb._text_graph_eligible()
    first, second = _texts(bucket, "first"), _texts(bucket, "second")
    got_first = emb.embed_texts_device(first)
    got_second = emb.embed_texts_device(second)  # the same bucket's graph again
    assert (bucket, emb.cfg.text.max_positions) in emb._text_graphs
    assert torch.equal(got_first, _eager(emb, first))
    assert torch.equal(got_second, _eager(emb, second))


def test_concurrent_callers_get_their_own_embeddings(card_embs):
    emb = card_embs[VIT_B32.name]
    batches = [_texts(32, f"worker {k}") for k in range(8)]
    got = [None] * 8
    start = threading.Barrier(8)

    def worker(k):
        start.wait()
        for _ in range(4):
            got[k] = emb.embed_texts_device(batches[k])

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for k in range(8):
        assert torch.equal(got[k], _eager(emb, batches[k])), k


def test_text_lru_entry_survives_later_replays(card_embs):
    emb = card_embs[LONGCLIP_TEXT.name]
    held = emb.embed_text_device("a lone query held by the LRU")
    kept = held.clone()
    for text in _texts(4, "later"):
        emb.embed_text_device(text)
    assert emb.embed_text_device("a lone query held by the LRU") is held
    assert torch.equal(held, kept)
    assert torch.equal(held, _eager(emb, ["a lone query held by the LRU"])[0])


@pytest.mark.parametrize("how", ["new-storage", "new-model"])
def test_new_weights_are_read_by_the_next_call(card, how):
    emb = ClipEmbedder(config=VIT_B32, device=card)
    texts = _texts(32, "weights")
    METRICS.reset()
    before = emb.embed_texts_device(texts)
    with torch.no_grad():
        if how == "new-storage":
            for p in emb.model.text.parameters():
                p.data = (p.data * 1.5).to(p.dtype)
        else:
            emb.model = init_random(emb.cfg, device=card, dtype=emb.compute_dtype,
                                    generator=torch.Generator(device=card).manual_seed(1))
    after = emb.embed_texts_device(texts)
    assert torch.equal(after, _eager(emb, texts))
    assert not torch.equal(after, before)
    counters = METRICS.snapshot()["counters"]
    assert counters["embed.text_graph_capture"] == 2 and counters["embed.text_graph_replay"] == 2


def test_each_replay_counts_the_towers_k2_launches(card):
    emb = ClipEmbedder(config=VIT_B32, device=card)
    layers = emb.cfg.text.num_layers
    texts = _texts(16, "launches")
    start = flash_mha.launches
    emb.embed_texts_device(texts)  # capture and first replay
    assert flash_mha.launches - start == layers
    emb.embed_texts_device(texts)
    assert flash_mha.launches - start == 2 * layers
