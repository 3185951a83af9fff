"""GPT-2's byte-level BPE over a given vocabulary and merge list, the
tokenizer family of the Moondream decoder: written from GPT-2's published
rules (the byte-to-unicode table, the pre-tokenization pattern, merges by
rank), importing nothing of the program.

The vocabulary and merges are the benchmark's own input
(``captioners/moondream.py`` writes them); the program reads the same
files.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import regex

_PAT = regex.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")


def byte_table() -> Dict[int, str]:
    """GPT-2's reversible map of the 256 bytes to printable characters."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = list(bs)
    extra = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + extra)
            extra += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


class BPE:
    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]], specials: Sequence[int]):
        self.vocab = vocab
        self.token_of = {i: t for t, i in vocab.items()}
        self.rank = {tuple(m): r for r, m in enumerate(merges)}
        self.enc = byte_table()
        self.dec = {c: b for b, c in self.enc.items()}
        self.specials = set(specials)

    def _merge(self, word: Tuple[str, ...]) -> Tuple[str, ...]:
        while len(word) > 1:
            pairs = [(self.rank.get(p, None), k) for k, p in enumerate(zip(word, word[1:]))]
            ranked = [(r, k) for r, k in pairs if r is not None]
            if not ranked:
                break
            best = min(ranked)[0]
            out, k = [], 0
            while k < len(word):
                if k + 1 < len(word) and self.rank.get((word[k], word[k + 1])) == best:
                    out.append(word[k] + word[k + 1])
                    k += 2
                else:
                    out.append(word[k])
                    k += 1
            word = tuple(out)
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for chunk in _PAT.findall(text):
            word = tuple(self.enc[b] for b in chunk.encode("utf-8"))
            ids.extend(self.vocab[t] for t in self._merge(word))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        """The ids' text, special ids dropped, bytes that do not form UTF-8
        replaced."""
        chars = "".join(self.token_of[i] for i in ids if i not in self.specials and i in self.token_of)
        return bytes(self.dec[c] for c in chars if c in self.dec).decode("utf-8", errors="replace")
