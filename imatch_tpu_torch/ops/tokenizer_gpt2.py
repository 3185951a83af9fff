"""GPT-2-style byte-level BPE tokenizer for the Moondream decoder (a copy
of imatch_tpu/ops/tokenizer_gpt2.py).

Moondream's Phi-style LM uses a GPT-2-family vocab. ``from_files``
loads a real vocab.json + merges.txt (id parity with HF GPT2Tokenizer for
the checkpoint path); ``byte_fallback`` is a deterministic offline vocab —
ids are raw bytes plus <|bos|>/<|eos|> specials — used with
randomly-initialized models so the whole caption/VQA stack runs without
network access.
"""

from __future__ import annotations

import json
import re
import threading
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

from imatch_tpu_torch.ops.tokenizer import bpe_merge, bytes_to_unicode

# GPT-2's pre-tokenization pattern, minus the unicode-category classes
# (the `regex` package isn't a dependency); \w/\s approximate \p{L}\p{N}.
_PAT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+"
)


class GPT2Tokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        eos_token: str = "<|endoftext|>",
        bos_token: str | None = None,
    ):
        self.vocab = dict(vocab)
        self.decoder = {v: k for k, v in self.vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.eos_id = self.vocab[eos_token]
        self.bos_id = self.vocab[bos_token] if bos_token else self.eos_id
        # bounded, lock-guarded LRU: filter queries
        # and caption prompts are user-supplied, so an unbounded dict
        # grows server memory forever, and the serving thread pool
        # tokenizes concurrently
        self._cache: "OrderedDict[str, Tuple[str, ...]]" = OrderedDict()
        self._cache_cap = 32768
        self._cache_lock = threading.Lock()
        self._byte_mode = not merges and all(
            len(k) == 1 or k.startswith("<|") for k in vocab
        )

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str) -> "GPT2Tokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_file, encoding="utf-8") as f:
            for line in f.read().split("\n"):
                if line.startswith("#version") or not line.strip():
                    continue
                parts = tuple(line.split())
                if len(parts) == 2:
                    merges.append(parts)
        return cls(vocab, merges)

    @classmethod
    def byte_fallback(
        cls, bos_id: int = 256, eos_id: int = 257
    ) -> "GPT2Tokenizer":
        """Offline vocab: id == byte value, specials after (256=bos 257=eos)."""
        b2u = bytes_to_unicode()
        vocab = {b2u[b]: b for b in range(256)}
        vocab["<|bos|>"] = bos_id
        vocab["<|endoftext|>"] = eos_id
        return cls(vocab, merges=[], bos_token="<|bos|>")

    @property
    def vocab_size(self) -> int:
        return max(self.vocab.values()) + 1

    def _bpe(self, token: str) -> Tuple[str, ...]:
        with self._cache_lock:
            cached = self._cache.get(token)
            if cached is not None:
                self._cache.move_to_end(token)
                return cached
        word = bpe_merge(tuple(token), self.bpe_ranks)
        with self._cache_lock:
            self._cache[token] = word
            if len(self._cache) > self._cache_cap:
                self._cache.popitem(last=False)
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        if self._byte_mode:
            return [
                self.vocab[self.byte_encoder[b]]
                for b in text.encode("utf-8")
            ]
        for chunk in _PAT.findall(text):
            mapped = "".join(
                self.byte_encoder[b] for b in chunk.encode("utf-8")
            )
            ids.extend(self.vocab[t] for t in self._bpe(mapped))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        specials = {self.eos_id, self.bos_id}
        text = "".join(
            self.decoder[i] for i in ids if i not in specials and i in self.decoder
        )
        data = bytearray(
            self.byte_decoder[c] for c in text if c in self.byte_decoder
        )
        return data.decode("utf-8", errors="replace")

    def token_ids_for_word(self, word: str) -> List[int]:
        """Ids whose decoded text strips/casefolds to ``word`` — used to
        collect the 'Yes'/' yes' variants for the VQA fast path."""
        w = word.strip().lower()
        out = []
        for tok, i in self.vocab.items():
            if tok.startswith("<|"):
                continue
            data = bytearray(
                self.byte_decoder[c] for c in tok if c in self.byte_decoder
            )
            if data.decode("utf-8", errors="ignore").strip().lower() == w:
                out.append(i)
        return out
