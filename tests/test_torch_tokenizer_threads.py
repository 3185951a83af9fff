"""The port's CLIP tokenizer on the serving threads (ops/tokenizer.py).

A batched search tokenizes its texts on one of several worker threads.
The word cache is ``functools.lru_cache`` (no lock of its own) and the
regex matches keep the GIL (``_KEEP_GIL``): a lock taken twice a word and
matches that released the GIL made 8 threads tokenizing together run at a
fifteenth of one thread's rate. Held here: threads switching every few
microseconds get one thread's ids, the cache stays bounded, and the
matches are asked to keep the GIL where the ``regex`` module serves them.
"""

import sys
import threading

import numpy as np
import pytest

from imatch_tpu_torch.ops import tokenizer as tokenizer_mod
from imatch_tpu_torch.ops.tokenizer import CLIPTokenizer


def _captions(n, seed):
    rng = np.random.default_rng(seed)
    words = ["red", "drill", "on", "a", "wooden", "table", "café", "naïve", "42", "x-ray", "it's", "über", "日本"]
    return [" ".join(rng.choice(words, size=rng.integers(3, 40))) + f" {i}" for i in range(n)]


def test_threads_get_one_threads_ids():
    batches = [_captions(32, seed) for seed in range(16)]
    want = [CLIPTokenizer.byte_fallback().encode_batch(b, max_length=77) for b in batches]
    tok = CLIPTokenizer.byte_fallback()  # one cache shared by every thread
    got = [None] * len(batches)
    start = threading.Barrier(len(batches))

    def work(k):
        start.wait()
        for _ in range(3):
            got[k] = tok.encode_batch(batches[k], max_length=77)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(len(batches))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for k in range(len(batches)):
        assert np.array_equal(got[k], want[k]), k


def test_word_cache_is_bounded(monkeypatch):
    monkeypatch.setattr(CLIPTokenizer, "BPE_CACHE_WORDS", 64)
    tok = CLIPTokenizer.byte_fallback()
    tok.encode_batch([f"word{i} other{i}" for i in range(200)], max_length=16)
    info = tok.bpe.cache_info()
    assert info.maxsize == 64 and info.currsize <= 64
    # a word evicted and seen again gets the same ids
    assert tok.encode("word0") == CLIPTokenizer.byte_fallback().encode("word0")


class _Recorder:
    def __init__(self, pattern, seen):
        self.pattern, self.seen = pattern, seen

    def findall(self, *args, **kw):
        self.seen.append(kw)
        return self.pattern.findall(*args, **kw)

    def sub(self, *args, **kw):
        self.seen.append(kw)
        return self.pattern.sub(*args, **kw)


def test_regex_matches_keep_the_gil(monkeypatch):
    if not tokenizer_mod._HAS_REGEX:
        pytest.skip("the stdlib re module serves the matches and keeps the GIL itself")
    assert tokenizer_mod._KEEP_GIL == {"concurrent": False}
    want = CLIPTokenizer.byte_fallback().encode("a red drill")
    seen = []
    monkeypatch.setattr(tokenizer_mod, "_SPLIT", _Recorder(tokenizer_mod._SPLIT, seen))
    monkeypatch.setattr(tokenizer_mod, "_WHITESPACE", _Recorder(tokenizer_mod._WHITESPACE, seen))
    tok = CLIPTokenizer.byte_fallback()
    assert tok.encode("a red  drill") == want
    assert len(seen) == 2 and all(kw == {"concurrent": False} for kw in seen)
