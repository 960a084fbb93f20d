"""CLIP byte-pair-encoding tokenizer, the counterpart of
``openess_tpu/models/fcclip/tokenizer.py``.

The published CLIP BPE scheme (gpt-2-style byte-level BPE with ``</w>``
word-end markers, vocab 49408 with the start/end specials) against a
user-supplied ``bpe_simple_vocab_16e6.txt.gz`` merges file; the reference
reaches it through ``open_clip.get_tokenizer`` (clip.py:41,104-106).

The JAX file splits the text with the ``regex`` package's pattern
``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
[^\\s\\p{L}\\p{N}]+``. The standard library's ``re`` has no ``\\p``, and
``\\w``/``\\d`` are other classes (``_`` is a word character; ``½`` and
``Ⅻ`` are numbers but not digits), so this module scans the text itself
(:func:`pre_tokenize`) with the pattern's three classes taken from
``unicodedata``: letters (category ``L*``), numbers (``N*``), and the rest
that is not whitespace, whitespace being Unicode's ``White_Space``
property as ``regex``'s ``\\s`` has it. Every character that Python's
``unicodedata`` knows (Unicode 15.0 under Python 3.12) splits as the JAX
pattern splits it; a character assigned in a later Unicode version is
"other" here where a newer ``regex`` may know it as a letter. Like the JAX
file it skips ``ftfy.fix_text`` and keeps the two rounds of
``html.unescape``.
"""
from __future__ import annotations

import gzip
import html
import unicodedata
from functools import lru_cache
from typing import List, Sequence

import numpy as np

CONTEXT_LENGTH = 77
SPECIALS = ("<|startoftext|>", "<|endoftext|>")
# the pattern's alternatives in order: the first that matches wins
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")

# Unicode's White_Space property (regex's \s on str); str.isspace() also
# takes U+001C-U+001F, which the JAX pattern does not
WHITE_SPACE = frozenset(
    [chr(c) for c in range(0x09, 0x0E)]
    + [chr(c) for c in (0x20, 0x85, 0xA0, 0x1680, 0x2028, 0x2029, 0x202F,
                        0x205F, 0x3000)]
    + [chr(c) for c in range(0x2000, 0x200B)])


@lru_cache()
def bytes_to_unicode():
    """gpt-2 byte <-> unicode table (reversible, no whitespace/control)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


# the pattern matches case-insensitively: the only character the
# lower-cased text can hold that folds onto a literal's letter is the long s
CASE_FOLD = {"\u017f": "s"}


@lru_cache(maxsize=None)
def _kind(ch: str) -> str:
    """'s' whitespace, 'L' letter, 'N' number, 'o' anything else, '-' for a
    character no alternative matches: not a letter or number itself, but
    its upper case is one, so the case-insensitive ``[^\\s\\p{L}\\p{N}]``
    refuses it (U+0345, whose upper case is a Greek capital iota)."""
    if ch in WHITE_SPACE:
        return "s"
    cat = unicodedata.category(ch)[0]
    if cat in "LN":
        return cat
    up = ch.upper()
    if len(up) == 1 and unicodedata.category(up)[0] in "LN":
        return "-"
    return "o"


def _starts(text: str, lit: str, i: int) -> bool:
    """``lit`` at ``text[i:]``, the case-insensitive way."""
    part = text[i:i + len(lit)]
    return len(part) == len(lit) and all(
        CASE_FOLD.get(a, a) == b for a, b in zip(part, lit))


def pre_tokenize(text: str) -> List[str]:
    """The JAX pattern's ``findall`` on lower-cased text: at each position
    the first alternative that matches; whitespace, and what no
    alternative matches, skipped."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        for lit in SPECIALS + CONTRACTIONS:
            if _starts(text, lit, i):
                out.append(text[i:i + len(lit)])
                i += len(lit)
                break
        else:
            kind = _kind(text[i])
            if kind in "s-":
                i += 1
                continue
            j = i + 1
            if kind != "N":  # a number is one character; the rest runs
                while j < n and _kind(text[j]) == kind:
                    j += 1
            out.append(text[i:j])
            i = j
    return out


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    out, gap = [], False
    for ch in text:
        if ch in WHITE_SPACE:
            gap = True
            continue
        if gap:
            out.append(" ")
            gap = False
        out.append(ch)
    if gap:
        out.append(" ")
    return "".join(out).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: str):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(SPECIALS)
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {s: s for s in SPECIALS}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
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
                    word[i] == first
                    and i < len(word) - 1
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
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in pre_tokenize(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def __call__(
        self, texts: Sequence[str], context_length: int = CONTEXT_LENGTH
    ) -> np.ndarray:
        """Tokenize to [len(texts), context_length] int32 with sot/eot,
        truncating over-long prompts (eot kept), as open_clip does."""
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot] + self.encode(text) + [self.eot]
            if len(tokens) > context_length:
                tokens = tokens[:context_length]
                tokens[-1] = self.eot
            out[i, : len(tokens)] = tokens
        return out
