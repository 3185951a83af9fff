"""CLIP byte-pair-encoding tokenizer — first-party, offline-capable.

A copy of ``imatch_tpu/ops/tokenizer.py``; tests/test_torch_preprocess_phash.py
holds its ids to the original's.

Replaces the HF ``tokenizers`` (Rust) dependency the reference uses via
``CLIPProcessor`` (reference app utils.py:88: tokenize, pad to
max_length=248 with eos, truncate). Implements the OpenAI CLIP BPE scheme:

- whitespace cleanup + lowercasing,
- CLIP's regex word splitter,
- GPT-2 byte->unicode mapping,
- BPE merges with an end-of-word ``</w>`` marker,
- ``[bos] + tokens + [eos]``, eos-padding to a fixed length (matching
  ``padding="max_length", truncation=True``).

Vocabulary sources:
- ``CLIPTokenizer.from_files(vocab_json, merges_txt)`` — loads the real
  CLIP vocab (49,408 entries) when checkpoint files are available; token
  ids then match HF exactly (verified in tests/test_tokenizer.py against
  ``transformers.CLIPTokenizer`` on a synthetic vocab, since the real one
  is not downloadable in this offline environment).
- ``CLIPTokenizer.byte_fallback()`` — a deterministic byte-level vocab
  (256 symbols x {mid-word, end-of-word} + specials, no merges) so the
  whole stack runs end-to-end with random-init models offline.

Pure Python with an LRU cache over words, which keeps the implementation
auditable. A batched search tokenizes its texts on the serving threads, so
neither the cache nor the regex matches release the GIL or wait on a lock
(``_KEEP_GIL``).
"""

from __future__ import annotations

import functools
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import unicodedata

try:  # CLIP's splitter needs unicode property classes; `regex` ships with transformers.
    import regex as _re

    _HAS_REGEX = True
except ImportError:  # pragma: no cover
    import re as _re

    _HAS_REGEX = False


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte -> printable unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return set(zip(word[:-1], word[1:]))


def bpe_merge(word: Tuple[str, ...], bpe_ranks: Dict) -> Tuple[str, ...]:
    """Iterated lowest-rank pair merging — the BPE core, ONE definition
    shared by the CLIP ('</w>'-suffixed) and GPT-2 (byte-level)
    tokenizers, which previously carried verbatim copies of this loop."""
    pairs = _get_pairs(word)
    while pairs:
        bigram = min(pairs, key=lambda p: bpe_ranks.get(p, float("inf")))
        if bigram not in bpe_ranks:
            break
        first, second = bigram
        new_word: List[str] = []
        i = 0
        while i < len(word):
            try:
                j = word.index(first, i)
            except ValueError:
                new_word.extend(word[i:])
                break
            new_word.extend(word[i:j])
            i = j
            if (
                i < len(word) - 1
                and word[i] == first
                and word[i + 1] == second
            ):
                new_word.append(first + second)
                i += 2
            else:
                new_word.append(word[i])
                i += 1
        word = tuple(new_word)
        if len(word) == 1:
            break
        pairs = _get_pairs(word)
    return word


_WHITESPACE = _re.compile(r"\s+")

if _HAS_REGEX:
    _SPLIT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
else:  # pragma: no cover - ASCII-only approximation
    _SPLIT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
        _re.IGNORECASE,
    )

# `regex` releases the GIL around every match unless told not to. The
# matches here are short (one text, one word), and with several threads
# tokenizing each release hands the GIL to another thread, as a lock
# around the word cache did: the two together left 8 threads tokenizing
# batches of captions a fifteenth of one thread's rate. The matches keep
# the GIL.
_KEEP_GIL = {"concurrent": False} if _HAS_REGEX else {}


class CLIPTokenizer:
    """CLIP BPE tokenizer with batched fixed-length encoding."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        bos_token: str = "<|startoftext|>",
        eos_token: str = "<|endoftext|>",
    ):
        self.vocab = dict(vocab)
        self.decoder = {v: k for k, v in self.vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_token = bos_token
        self.eos_token = eos_token
        self.bos_id = self.vocab[bos_token]
        self.eos_id = self.vocab[eos_token]
        # bounded LRU: a long-lived server seeing unbounded unique words
        # (filenames, adversarial queries) must not grow memory forever.
        # functools' cache stays coherent across the serving threads
        # without a lock of its own (see _KEEP_GIL).
        self.bpe = functools.lru_cache(maxsize=self.BPE_CACHE_WORDS)(self._bpe)

    BPE_CACHE_WORDS = 32768

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str) -> "CLIPTokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # skip header line(s); merges lines are "tok_a tok_b"
        merges = []
        for line in lines:
            if line.startswith("#version") or not line.strip():
                continue
            parts = tuple(line.split())
            if len(parts) == 2:
                merges.append(parts)
        return cls(vocab, merges)

    @classmethod
    def byte_fallback(cls) -> "CLIPTokenizer":
        """Deterministic byte-level vocab (no merges) for offline use."""
        b2u = bytes_to_unicode()
        vocab: Dict[str, int] = {}
        for ch in b2u.values():
            vocab[ch] = len(vocab)
        for ch in b2u.values():
            vocab[ch + "</w>"] = len(vocab)
        vocab["<|startoftext|>"] = len(vocab)
        vocab["<|endoftext|>"] = len(vocab)
        return cls(vocab, merges=[])

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- core BPE -----------------------------------------------------------

    def _bpe(self, token: str) -> str:
        """One word's merges (``bpe``, the cached form, is what callers use)."""
        word = bpe_merge(
            tuple(token[:-1]) + (token[-1] + "</w>",), self.bpe_ranks
        )
        return " ".join(word)

    def _tokenize_word(self, token: str) -> List[int]:
        token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
        return [self.vocab[t] for t in self.bpe(token).split(" ")]

    def encode(self, text: str) -> List[int]:
        """Token ids without specials."""
        # NFC first: HF's CLIP tokenizer normalizes composed forms (via
        # ftfy / the fast normalizer), so decomposed input (e.g. 'café'
        # pasted from macOS as e + U+0301) must map to the same ids.
        text = unicodedata.normalize("NFC", text)
        text = _WHITESPACE.sub(" ", text.strip(), **_KEEP_GIL).lower()
        ids: List[int] = []
        for tok in _SPLIT.findall(text, **_KEEP_GIL):
            if tok == self.bos_token or tok == self.eos_token:
                # HF treats the special literals as added tokens (one
                # id), not text to byte-encode through BPE
                ids.append(
                    self.bos_id if tok == self.bos_token else self.eos_id
                )
                continue
            ids.extend(self._tokenize_word(tok))
        return ids

    def encode_batch(
        self,
        texts: Iterable[str],
        max_length: int = 248,
        pad_to: Optional[int] = None,
    ) -> np.ndarray:
        """``[bos] + ids + [eos]``, truncated and eos-padded to a fixed length.

        Matches HF's ``padding="max_length", truncation=True`` semantics
        (reference app utils.py:88): sequences longer than ``max_length``
        keep the first ``max_length - 2`` content tokens. ``pad_to``
        (when given) is the exact row width: rows both pad AND truncate
        to it, so the returned array shape is always (N, pad_to).
        """
        width = pad_to if pad_to is not None else max_length
        rows = []
        for text in texts:
            ids = self.encode(text)[: min(max_length, width) - 2]
            row = [self.bos_id] + ids + [self.eos_id]
            row = row + [self.eos_id] * (width - len(row))
            rows.append(row)
        return np.asarray(rows, dtype=np.int32)

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(
            self.decoder[i]
            for i in ids
            if i not in (self.bos_id, self.eos_id)
        )
        raw = bytearray(
            self.byte_decoder.get(c, 0x20) for c in text.replace("</w>", " ")
        )
        return raw.decode("utf-8", errors="replace").strip()


@functools.lru_cache()
def default_tokenizer() -> CLIPTokenizer:
    """Real vocab if IMATCH_CLIP_VOCAB/IMATCH_CLIP_MERGES point at files,
    else the offline byte-level fallback."""
    import os

    vocab = os.environ.get("IMATCH_CLIP_VOCAB")
    merges = os.environ.get("IMATCH_CLIP_MERGES")
    if vocab and merges and os.path.exists(vocab) and os.path.exists(merges):
        return CLIPTokenizer.from_files(vocab, merges)
    return CLIPTokenizer.byte_fallback()
