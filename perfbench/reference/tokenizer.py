"""CLIP byte-pair-encoding tokenizer (SimpleTokenizer-compatible).

Implements the same scheme the reference uses through open_clip's tokenizer
(clipfusion.py:772, 894): byte->unicode mapping, BPE merges with an
end-of-word marker, lowercasing + whitespace cleanup, <|startoftext|> /
<|endoftext|> wrapping, pad/truncate to a 77-token context.

The standard merges table (`bpe_simple_vocab_16e6.txt.gz`) is loaded from a
file path when available (`ClipTokenizer(bpe_path=...)`). In environments
without the vocab file, a deterministic byte-level fallback vocabulary is
built (no merges): every text still round-trips to valid token ids, with
<|startoftext|>=49406 and <|endoftext|>=49407 at the standard positions so
EOT-argmax pooling works identically. Real deployments should provide the
standard vocab for checkpoint compatibility.
"""
from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import List, Optional, Sequence

import numpy as np

CONTEXT_LENGTH = 77
SOT_ID = 49406
EOT_ID = 49407


@lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode map (GPT-2/CLIP convention)."""
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


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    # the reference stack additionally runs ftfy; plain html-unescape +
    # whitespace collapse covers the ascii queries this system receives
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


_TOKEN_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
    r"""|[^\W\d_]+|\d|[^\s\w]+""",
    re.IGNORECASE | re.UNICODE,
)


class ClipTokenizer:
    def __init__(self, bpe_path: Optional[str] = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges: List[tuple] = []
        if bpe_path and os.path.exists(bpe_path):
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # line 0 is the version header; the standard table keeps
            # 49152 - 256 - 2 + 1 merge lines
            merge_lines = lines[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merge_lines if m]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        # pin the special ids to the standard CLIP positions so EOT stays the
        # max id even with a fallback (merge-free) vocabulary
        self.encoder["<|startoftext|>"] = SOT_ID
        self.encoder["<|endoftext|>"] = EOT_ID
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    @property
    def has_standard_vocab(self) -> bool:
        return len(self.bpe_ranks) > 0

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(_TOKEN_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def __call__(
        self, texts: Sequence[str], context_length: int = CONTEXT_LENGTH
    ) -> np.ndarray:
        """Tokenize a batch -> [B, context_length] int32, sot ... eot, 0-padded.
        Over-long inputs are truncated with EOT kept as the final token."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [SOT_ID] + self.encode(text) + [EOT_ID]
            if len(ids) > context_length:
                ids = ids[:context_length]
                ids[-1] = EOT_ID
            out[i, : len(ids)] = ids
        return out
