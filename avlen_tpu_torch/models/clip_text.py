"""CLIP ViT-B/32 text tower and its tokenizer.

PyTorch counterpart of ``avlen_tpu/models/clip_text.py``: the reference
grounds oracle instructions with the frozen OpenAI CLIP text encoder
(ss_baselines/savi/ppo/policy.py:761-762, 847-849; ``clip.tokenize`` with
context length 77). The tower is the Flax module's, not OpenAI's code:
token embedding, learned positional embedding (normal 0.01), pre-LN blocks
``ln1_i``/``attn_i``/``ln2_i``/``mlp_fc_i``/``mlp_proj_i`` with QuickGELU,
``ln_final`` and the text projection (normal 0.02), pooled at the EOT token
(the highest id). LayerNorms use Flax's eps 1e-6, and the causal mask
fills masked logits with ``finfo(float32).min``, as Flax's
``MultiHeadDotProductAttention`` does (not -inf). Without OpenAI weights on
disk (none ship) the tower runs from its own random init, drawn from an
explicit generator with Flax's initialisers; ``load_openai_weights`` maps a
CLIP state dict onto the module when one is given.
"""

from __future__ import annotations

import math
import re
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from avlen_tpu_torch.models.clip_bpe import CONTEXT_LENGTH, VOCAB_SIZE, default_tokenizer
from avlen_tpu_torch.models.init import lecun_normal_

SOT_TOKEN = 49406
EOT_TOKEN = 49407
LN_EPS = 1e-6


def tokenize(texts: Union[str, Sequence[str]], context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """(B, context_length) int32 ids: SOT + BPE ids + EOT, truncated."""
    return default_tokenizer().tokenize(texts, context_length)


def _dense(cin: int, cout: int, generator: Optional[torch.Generator]) -> nn.Linear:
    layer = nn.Linear(cin, cout)
    lecun_normal_(layer.weight, cin, generator)
    nn.init.zeros_(layer.bias)
    return layer


class CLIPAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention``: query/key/value DenseGeneral
    (W → heads × W/heads) and out (heads × W/heads → W), as Linear layers."""

    def __init__(self, width: int, heads: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.nhead = heads
        self.query = _dense(width, width, generator)
        self.key = _dense(width, width, generator)
        self.value = _dense(width, width, generator)
        self.out = _dense(width, width, generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (B, T, W), mask (T, T) bool, True = attend."""
        b, t, w = x.shape
        h = self.nhead
        dh = w // h
        q = self.query(x).view(b, t, h, dh) / math.sqrt(dh)
        k = self.key(x).view(b, t, h, dh)
        v = self.value(x).view(b, t, h, dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        attn = torch.softmax(logits, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, w))


class CLIPTextEncoder(nn.Module):
    def __init__(
        self,
        vocab_size: int = VOCAB_SIZE,
        context_length: int = CONTEXT_LENGTH,
        width: int = 512,
        layers: int = 12,
        heads: int = 8,
        embed_dim: int = 512,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.width, self.layers, self.heads, self.embed_dim = width, layers, heads, embed_dim
        self.token_embedding = nn.Embedding(vocab_size, width)
        with torch.no_grad():
            # Flax nn.Embed: variance_scaling(1, fan_in, normal), fan_in = width
            self.token_embedding.weight.normal_(0.0, 1.0 / math.sqrt(width), generator=generator)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width).normal_(0.0, 0.01, generator=generator))
        for i in range(layers):
            setattr(self, f"ln1_{i}", nn.LayerNorm(width, eps=LN_EPS))
            setattr(self, f"attn_{i}", CLIPAttention(width, heads, generator))
            setattr(self, f"ln2_{i}", nn.LayerNorm(width, eps=LN_EPS))
            setattr(self, f"mlp_fc_{i}", _dense(width, 4 * width, generator))
            setattr(self, f"mlp_proj_{i}", _dense(4 * width, width, generator))
        self.ln_final = nn.LayerNorm(width, eps=LN_EPS)
        self.text_projection = nn.Parameter(
            torch.empty(width, embed_dim).normal_(0.0, 0.02, generator=generator))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, T) ints → (B, embed_dim) text features."""
        tokens = tokens.long()
        t = tokens.shape[1]
        x = self.token_embedding(tokens) + self.positional_embedding[None, :t]
        causal = torch.ones((t, t), dtype=torch.bool, device=tokens.device).tril()
        for i in range(self.layers):
            x = x + getattr(self, f"attn_{i}")(getattr(self, f"ln1_{i}")(x), causal)
            y = getattr(self, f"mlp_fc_{i}")(getattr(self, f"ln2_{i}")(x))
            y = y * torch.sigmoid(1.702 * y)  # QuickGELU
            x = x + getattr(self, f"mlp_proj_{i}")(y)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection


@torch.no_grad()
def load_openai_weights(module: CLIPTextEncoder, state_dict: Mapping[str, object]) -> None:
    """Copy an OpenAI CLIP state dict (tensor name → array) into ``module``,
    the mapping of ``avlen_tpu/models/clip_text.py:91-124`` in the torch
    layout (OpenAI's Linear weights are already (out, in))."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()}

    def put(param: torch.Tensor, value: torch.Tensor) -> None:
        if tuple(param.shape) != tuple(value.shape):
            raise ValueError(f"shape {tuple(value.shape)} for a parameter of {tuple(param.shape)}")
        param.copy_(value.to(param.dtype))

    put(module.token_embedding.weight, sd["token_embedding.weight"])
    put(module.positional_embedding, sd["positional_embedding"])
    put(module.text_projection, sd["text_projection"])
    put(module.ln_final.weight, sd["ln_final.weight"])
    put(module.ln_final.bias, sd["ln_final.bias"])
    n_layers = len([k for k in sd if re.match(r"transformer\.resblocks\.\d+\.ln_1\.weight", k)])
    w = module.width
    for i in range(n_layers):
        pre = f"transformer.resblocks.{i}"
        ln1, ln2 = getattr(module, f"ln1_{i}"), getattr(module, f"ln2_{i}")
        attn = getattr(module, f"attn_{i}")
        put(ln1.weight, sd[f"{pre}.ln_1.weight"])
        put(ln1.bias, sd[f"{pre}.ln_1.bias"])
        put(ln2.weight, sd[f"{pre}.ln_2.weight"])
        put(ln2.bias, sd[f"{pre}.ln_2.bias"])
        wqkv, bqkv = sd[f"{pre}.attn.in_proj_weight"], sd[f"{pre}.attn.in_proj_bias"]
        for j, proj in enumerate((attn.query, attn.key, attn.value)):
            put(proj.weight, wqkv[j * w : (j + 1) * w])
            put(proj.bias, bqkv[j * w : (j + 1) * w])
        put(attn.out.weight, sd[f"{pre}.attn.out_proj.weight"])
        put(attn.out.bias, sd[f"{pre}.attn.out_proj.bias"])
        for name, src in ((f"mlp_fc_{i}", "mlp.c_fc"), (f"mlp_proj_{i}", "mlp.c_proj")):
            put(getattr(module, name).weight, sd[f"{pre}.{src}.weight"])
            put(getattr(module, name).bias, sd[f"{pre}.{src}.bias"])
