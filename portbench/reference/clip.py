"""Plain CLIP ViT-B/32 text tower and the tokenization of the speaker's words.

The tower as OpenAI's CLIP defines it (Radford et al. 2021,
github.com/openai/CLIP ``model.py``): token embedding plus a learned
positional embedding, pre-LN residual blocks of causal multi-head attention
and a QuickGELU MLP of four times the width, a final LayerNorm, the
features at the end-of-text token (the highest id) projected by the text
projection. Written with ``torch.nn`` alone, float32. Parameter names are
the program's, so the benchmark's weights load into both by the same names.

Where it departs from the published model, as the program does:
- LayerNorm eps is 1e-6 (Flax's default), where OpenAI's is 1e-5;
- the causal mask fills the masked logits with ``finfo(float32).min``
  (Flax's ``MultiHeadDotProductAttention``), where OpenAI adds ``-inf``;
  after the softmax both give exactly 0;
- the weights are drawn from the seed: OpenAI's are not in the repository.

``tokenize`` is CLIP's byte-level BPE without its merges table, which the
repository does not hold: each pre-token's bytes are symbols 0..255 in the
GPT-2 byte order, the last one a word-final symbol (256 + its index), then
start-of-text 49406 and end-of-text 49407. The ids mean what they mean to
CLIP's vocabulary; without merges the sequences are longer. It covers ASCII
text, the speaker's vocabulary; anything else raises.
"""

from __future__ import annotations

import re
from typing import List, Sequence

import torch
import torch.nn as nn

VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77
SOT, EOT = 49406, 49407
LN_EPS = 1e-6
# CLIP's pre-tokenizer on lowercase ASCII text: runs of letters, single
# digits, runs of anything else that is not a space
SPLIT = re.compile(r"[a-z]+|[0-9]|[^\sa-z0-9]+")


def _byte_index(b: int) -> int:
    """The GPT-2 byte table's index of a printable ASCII byte."""
    if not 33 <= b <= 126:
        raise ValueError(f"portbench: the reference tokenizes printable ASCII only, not byte {b}")
    return b - 33


def encode(text: str) -> List[int]:
    """The BPE ids (without merges) of ``text``, lowercased, whitespace
    collapsed."""
    ids: List[int] = []
    for token in SPLIT.findall(" ".join(text.split()).lower()):
        symbols = [_byte_index(b) for b in token.encode("ascii")]
        ids += symbols[:-1] + [256 + symbols[-1]]
    return ids


def tokenize(texts: Sequence[str], context_length: int = CONTEXT_LENGTH) -> torch.Tensor:
    """(B, context_length) int32: start-of-text, the ids cut to fit, end-of-text, zeros."""
    out = torch.zeros((len(texts), context_length), dtype=torch.int32)
    for i, text in enumerate(texts):
        ids = [SOT] + encode(text)[: context_length - 2] + [EOT]
        out[i, : len(ids)] = torch.tensor(ids, dtype=torch.int32)
    return out


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value, self.out = (nn.Linear(width, width) for _ in range(4))

    def forward(self, x):
        b, t, w = x.shape
        dh = w // self.heads
        q, k, v = (p(x).view(b, t, self.heads, dh).transpose(1, 2) for p in (self.query, self.key, self.value))
        logits = q @ k.transpose(-1, -2) / dh ** 0.5
        causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~causal, torch.finfo(logits.dtype).min)
        return self.out((torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(b, t, w))


class CLIPTextEncoder(nn.Module):
    def __init__(self, width: int = 512, layers: int = 12, heads: int = 8, embed_dim: int = 512,
                 vocab_size: int = VOCAB_SIZE, context_length: int = CONTEXT_LENGTH):
        super().__init__()
        self.layers = layers
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        for i in range(layers):
            setattr(self, f"ln1_{i}", nn.LayerNorm(width, eps=LN_EPS))
            setattr(self, f"attn_{i}", CLIPAttention(width, heads))
            setattr(self, f"ln2_{i}", nn.LayerNorm(width, eps=LN_EPS))
            setattr(self, f"mlp_fc_{i}", nn.Linear(width, 4 * width))
            setattr(self, f"mlp_proj_{i}", nn.Linear(4 * width, width))
        self.ln_final = nn.LayerNorm(width, eps=LN_EPS)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, T) ids → (B, embed_dim) text features."""
        tokens = tokens.long()
        x = self.token_embedding(tokens) + self.positional_embedding[: tokens.shape[1]]
        for i in range(self.layers):
            x = x + getattr(self, f"attn_{i}")(getattr(self, f"ln1_{i}")(x))
            y = getattr(self, f"mlp_fc_{i}")(getattr(self, f"ln2_{i}")(x))
            x = x + getattr(self, f"mlp_proj_{i}")(y * torch.sigmoid(1.702 * y))
        x = self.ln_final(x)
        pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return pooled @ self.text_projection
