"""Instruction vocabulary.

A copy of ``avlen_tpu/dialog/speaker/vocab.py`` (pure Python).

Counterpart of the reference's R2R vocab + GloVe tables
(ss_baselines/savi/dialog/speaker/tasks/R2R/{train_vocab.txt,train_glove.npy})
and the VQG `Vocabulary` the trainer loads (ddppo_trainer.py:51-52, 80-81).
Self-contained: a fixed navigation-instruction vocabulary plus dynamic
landmark words; encode/decode with <PAD>/<BOS>/<EOS>/<UNK>.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

PAD, BOS, EOS, UNK = "<PAD>", "<BOS>", "<EOS>", "<UNK>"

BASE_WORDS = [
    "go", "walk", "move", "head", "straight", "forward", "ahead", "turn",
    "left", "right", "around", "then", "and", "stop", "wait", "there",
    "past", "towards", "toward", "to", "the", "your", "at", "near", "by",
    "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
    "steps", "step", "meters", "meter", "until", "reach", "you", "goal",
    "sound", "source", "room", "area", "here", "destination", "keep",
    "continue", "slightly", "behind", "face", "facing",
]

CATEGORY_WORDS = [
    "chair", "table", "picture", "cabinet", "cushion", "sofa", "bed",
    "chest", "plant", "sink", "toilet", "stool", "towel", "tv", "shower",
    "bathtub", "counter", "fireplace", "gym", "seating", "clothes",
]


class Vocabulary:
    def __init__(self, extra_words: Sequence[str] = ()):
        words = [PAD, BOS, EOS, UNK] + BASE_WORDS + CATEGORY_WORDS + list(extra_words)
        self.idx2word: List[str] = list(dict.fromkeys(words))
        self.word2idx: Dict[str, int] = {w: i for i, w in enumerate(self.idx2word)}

    @classmethod
    def from_words(cls, words: Sequence[str]) -> "Vocabulary":
        """Rebuild a vocabulary from a saved idx2word list (speaker ckpts
        store the exact list so decode indices stay stable across loads)."""
        v = cls.__new__(cls)
        v.idx2word = list(words)
        v.word2idx = {w: i for i, w in enumerate(v.idx2word)}
        return v

    @classmethod
    def from_file(cls, path: str) -> "Vocabulary":
        """Load an R2R-style vocab file (one word per line — the reference's
        tasks/R2R/data/train_vocab.txt consumed by read_vocab/Tokenizer,
        speaker/tasks/R2R/utils.py). Special tokens already present in the
        file keep their positions; otherwise ours are prepended."""
        with open(path) as f:
            words = [w.strip() for w in f if w.strip()]
        v = cls.__new__(cls)
        if PAD in words:
            v.idx2word = list(dict.fromkeys(words))
        else:
            v.idx2word = list(dict.fromkeys([PAD, BOS, EOS, UNK] + words))
        v.word2idx = {w: i for i, w in enumerate(v.idx2word)}
        return v

    def __len__(self) -> int:
        return len(self.idx2word)

    @property
    def pad_id(self) -> int:
        return self.word2idx[PAD]

    @property
    def bos_id(self) -> int:
        return self.word2idx[BOS]

    @property
    def eos_id(self) -> int:
        return self.word2idx[EOS]

    def encode(self, words: Sequence[str], max_len: int = 40, add_special: bool = True) -> List[int]:
        unk = self.word2idx[UNK]
        ids = [self.word2idx.get(w.lower(), unk) for w in words]
        if add_special:
            ids = [self.bos_id] + ids[: max_len - 2] + [self.eos_id]
        ids = ids[:max_len]
        return ids + [self.pad_id] * (max_len - len(ids))

    def decode(self, ids: Sequence[int]) -> List[str]:
        out = []
        for i in ids:
            w = self.idx2word[int(i)] if 0 <= int(i) < len(self.idx2word) else UNK
            if w == EOS:
                break
            if w in (PAD, BOS):
                continue
            out.append(w)
        return out
