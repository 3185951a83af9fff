"""CLIP's tokenizer with the byte-level vocabulary the program serves
when no vocabulary file is given: a frozen copy of the rules, written
out for that vocabulary (no merges, so every byte of a word is one id).

Text is NFC-normalized, whitespace collapsed, lower-cased, split by
CLIP's word pattern; each word's UTF-8 bytes map through GPT-2's
byte-to-unicode table to ids 0-255, the last byte of a word to 256-511
(its ``</w>`` form); ``<|startoftext|>`` is 512, ``<|endoftext|>`` 513.
A row is [bos] + ids + [eos], cut to ``max_length`` (keeping the first
``max_length - 2`` ids) and eos-padded to it.
"""

from __future__ import annotations

import unicodedata
from typing import List, Sequence

import numpy as np
import regex

_SPLIT = regex.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    regex.IGNORECASE,
)
_WS = regex.compile(r"\s+")


def _byte_order() -> List[int]:
    """GPT-2's byte order: the printable bytes first, then the rest."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    return bs + [b for b in range(256) if b not in bs]


_ID_OF_BYTE = {b: i for i, b in enumerate(_byte_order())}
BOS, EOS = 512, 513
VOCAB_SIZE = 514


def encode(text: str) -> List[int]:
    text = _WS.sub(" ", unicodedata.normalize("NFC", text).strip()).lower()
    ids: List[int] = []
    for word in _SPLIT.findall(text):
        if word == "<|startoftext|>":
            ids.append(BOS)
            continue
        if word == "<|endoftext|>":
            ids.append(EOS)
            continue
        raw = word.encode("utf-8")
        ids.extend(_ID_OF_BYTE[b] for b in raw[:-1])
        ids.append(256 + _ID_OF_BYTE[raw[-1]])
    return ids


def encode_batch(texts: Sequence[str], max_length: int) -> np.ndarray:
    rows = []
    for t in texts:
        row = [BOS] + encode(t)[: max_length - 2] + [EOS]
        rows.append(row + [EOS] * (max_length - len(row)))
    return np.asarray(rows, dtype=np.int64)


def token_counts(texts: Sequence[str], max_length: int) -> List[int]:
    """Each text's ids through its eos, as the tower reads them."""
    return [min(len(encode(t)), max_length - 2) + 2 for t in texts]
