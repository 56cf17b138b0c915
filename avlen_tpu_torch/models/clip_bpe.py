"""CLIP's byte-pair-encoding tokenizer, implemented from the published
algorithm (openai/CLIP simple_tokenizer.py; the reference consumes it via
``clip.tokenize(dialog)`` in ss_baselines/savi/ppo/ppo_trainer.py:560-561).

Exactness contract:

* With the real merges table (``bpe_simple_vocab_16e6.txt.gz`` — pass a path,
  set ``$CLIP_BPE_PATH``, or drop it in ``avlen_tpu_torch/data/``) tokenization is
  id-for-id identical to OpenAI CLIP (modulo ftfy text *repair*, which this
  environment does not ship; for already-clean text the outputs coincide).
* Without a merges table the tokenizer degrades to byte-level BPE with an
  empty merge ranking. This is still *id-exact*: OpenAI's vocab lays out the
  256 byte symbols at ids 0..255, their ``</w>`` word-final variants at
  256..511, and SOT/EOT at 49406/49407 — all independent of the merges — so
  every emitted id means the same thing to a real CLIP embedding table. The
  only difference is sequence length (no merges are applied).

The merge loop, byte↦unicode table, and split regex follow the public
algorithm; the vocab layout is byte symbols, then ``</w>`` variants, then one
entry per merge, then the two specials.

A copy of ``avlen_tpu/models/clip_bpe.py`` with one change: the split
pattern runs on the standard library's ``re``, so the port needs no
``regex`` package. ``\\p{L}`` and ``\\p{N}`` become character classes of
the code points whose Unicode category starts with L or N
(``unicodedata``), built once at the first tokenizer.
"""

from __future__ import annotations

import gzip
import html
import os
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77
SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
# merges the real table holds: 49152 - 256 (bytes) - 2 (specials) = 48894
FULL_TABLE_MERGES = 49152 - 256 - 2


def _category_class(prefix: str) -> str:
    """The body of a ``re`` character class holding every code point whose
    Unicode general category starts with ``prefix`` (``\\p{L}``, ``\\p{N}``)."""
    ranges, start, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)).startswith(prefix):
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            ranges.append((start, prev))
            start = None
    if start is not None:
        ranges.append((start, prev))
    esc = lambda cp: f"\\U{cp:08x}"  # noqa: E731
    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}" for a, b in ranges)


@lru_cache()
def split_pattern() -> "re.Pattern":
    """CLIP's pre-tokenization split (the published pattern)."""
    letters, numbers = _category_class("L"), _category_class("N")
    return re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        f"[{letters}]+|[{numbers}]|[^\\s{letters}{numbers}]+",
        re.IGNORECASE,
    )


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte → printable-unicode map (the GPT-2/CLIP table)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def get_pairs(word: Tuple[str, ...]) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    # OpenAI additionally runs ftfy.fix_text (mojibake repair); unavailable
    # here and a no-op on well-formed text.
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def load_merges(path: str) -> List[Tuple[str, str]]:
    """Read an OpenAI-format merges table (.txt.gz or plain .txt): first line
    is a version banner, then one space-separated pair per line; only the
    first FULL_TABLE_MERGES entries are part of the CLIP vocab."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        lines = f.read().decode("utf-8").split("\n")
    lines = lines[1 : FULL_TABLE_MERGES + 1]
    return [tuple(line.split()) for line in lines if line.strip()]


class SimpleTokenizer:
    """Byte-level BPE with CLIP's vocab layout.

    merges: ranked merge list ((left, right) tuples). Empty list → byte-level
        fallback (see module docstring).
    pad_to_vocab: pin SOT/EOT to VOCAB_SIZE-2/VOCAB_SIZE-1 regardless of how
        many merges were provided (True for the CLIP-compatible default);
        False places them right after the merges, matching a small custom
        vocab end-to-end (used by golden tests against other implementations).
    """

    def __init__(self, merges: Optional[List[Tuple[str, str]]] = None, pad_to_vocab: bool = True):
        merges = list(merges or [])
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        if pad_to_vocab:
            self.encoder[SOT] = VOCAB_SIZE - 2
            self.encoder[EOT] = VOCAB_SIZE - 1
        else:
            self.encoder[SOT] = len(vocab)
            self.encoder[EOT] = len(vocab) + 1
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.cache: Dict[str, str] = {SOT: SOT, EOT: EOT}

    @property
    def sot_token(self) -> int:
        return self.encoder[SOT]

    @property
    def eot_token(self) -> int:
        return self.encoder[EOT]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word) if len(word) > 1 else set()
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
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
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in split_pattern().findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def tokenize(
        self,
        texts: Union[str, Sequence[str]],
        context_length: int = CONTEXT_LENGTH,
        truncate: bool = True,
    ) -> np.ndarray:
        """(B, context_length) int32, SOT + ids + EOT.

        Defaults to truncation (clip.tokenize(truncate=True); EOT always
        survives). NOTE: the reference calls clip.tokenize(dialog) with the
        default truncate=False, which *raises* on >77-token dialogs — pass
        ``truncate=False`` for that strict-parity behavior; the truncating
        default is a deliberate robustness improvement for generated
        instructions of unbounded length."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = self.encode(text)
            if not truncate and len(ids) > context_length - 2:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length {context_length}"
                )
            ids = [self.sot_token] + ids[: context_length - 2] + [self.eot_token]
            out[i, : len(ids)] = ids
        return out


def _default_merges_path() -> Optional[str]:
    cands = [os.environ.get("CLIP_BPE_PATH", "")]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("bpe_simple_vocab_16e6.txt.gz", "bpe_simple_vocab_16e6.txt"):
        cands.append(os.path.join(here, "data", name))
    for c in cands:
        if c and os.path.exists(c):
            return c
    return None


@lru_cache()
def default_tokenizer() -> SimpleTokenizer:
    path = _default_merges_path()
    merges = load_merges(path) if path else []
    return SimpleTokenizer(merges, pad_to_vocab=True)
