"""Neural speaker: LSTM seq2seq with attention.

PyTorch counterpart of ``avlen_tpu/dialog/speaker/model.py`` (reference
Seq2SeqSpeaker = SpeakerEncoderLSTM + SpeakerDecoderLSTM,
ss_baselines/savi/dialog/speaker/tasks/R2R/model.py:412-526): a path
encoder LSTM over per-step (action embedding ⊕ world feature) inputs and an
attention decoder LSTM emitting instruction words (speaker.py:131-212).

Both LSTMs are Flax's ``OptimizedLSTMCell`` written as plain ops on its
parameter layout: input kernels ``ii/if/ig/io`` without bias, recurrent
kernels ``hi/hf/hg/ho`` with bias, gates i, f, g, o and the carry (c, h).
``torch.nn.LSTMCell`` has two biases and an (h, c) carry, so it does not
fit. Submodule names follow the Flax tree (``encoder.Dense_0``,
``encoder.encoder_lstm.ii``, ``decoder.cell.hf``, ...), so
``utils/flax_bridge.py`` carries the parameters both ways.

As in the JAX package: the encoder runs all MAX_PATH_LEN steps, padding
included (its final carry depends on the padded steps; only the context is
masked); attention scores are q·ctx/√H masked with −1e9; greedy decoding
runs all ``max_decode_len`` steps; beam search freezes a finished beam on
EOS and ranks by the GNMT length norm. ``jax.lax.top_k`` breaks ties by the
lower index, so the beams are chosen by a stable descending sort.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from avlen_tpu_torch.models.init import lecun_normal_, linear, orthogonal_

Carry = Tuple[torch.Tensor, torch.Tensor]  # (c, h)
GATES = ("i", "f", "g", "o")


def _embed(num: int, features: int, generator: Optional[torch.Generator]) -> nn.Embedding:
    """Flax nn.Embed: variance_scaling(1, fan_in, normal), fan_in = features."""
    e = nn.Embedding(num, features)
    with torch.no_grad():
        e.weight.normal_(0.0, 1.0 / math.sqrt(features), generator=generator)
    return e


class OptimizedLSTMCell(nn.Module):
    def __init__(self, in_features: int, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        for gate in GATES:
            wi = nn.Linear(in_features, features, bias=False)
            lecun_normal_(wi.weight, in_features, generator)
            wh = nn.Linear(features, features)
            # Flax orthogonal() on the (in, out) kernel; Linear holds its transpose
            wh.weight.data = orthogonal_(torch.empty(features, features), 1.0, generator).T.contiguous()
            nn.init.zeros_(wh.bias)
            self.add_module("i" + gate, wi)  # "if" is a keyword: no attribute syntax
            self.add_module("h" + gate, wh)

    def forward(self, carry: Carry, x: torch.Tensor) -> Tuple[Carry, torch.Tensor]:
        c, h = carry
        m = self._modules
        i = torch.sigmoid(m["hi"](h) + m["ii"](x))
        f = torch.sigmoid(m["hf"](h) + m["if"](x))
        g = torch.tanh(m["hg"](h) + m["ig"](x))
        o = torch.sigmoid(m["ho"](h) + m["io"](x))
        c = f * c + i * g
        h = o * torch.tanh(c)
        return (c, h), h


def length_mask(lengths: torch.Tensor, steps: int) -> torch.Tensor:
    """(B, steps) float32: 1 at the steps inside each path."""
    return (torch.arange(steps, device=lengths.device)[None, :] < lengths[:, None]).float()


class PathEncoderLSTM(nn.Module):
    def __init__(self, world_feat_dim: int, hidden_size: int = 256, action_emb: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.action_embedding = _embed(8, action_emb, generator)
        self.Dense_0 = linear(action_emb + world_feat_dim, hidden_size, generator)
        self.encoder_lstm = OptimizedLSTMCell(hidden_size, hidden_size, generator)

    def forward(self, actions: torch.Tensor, world_feats: torch.Tensor, lengths: torch.Tensor):
        """actions (B, L) int; world_feats (B, L, D); lengths (B,).
        Returns (ctx (B, L, H), (c, h))."""
        x = self.Dense_0(torch.cat([self.action_embedding(actions.long()), world_feats], dim=-1))
        b, steps = actions.shape
        zeros = x.new_zeros((b, self.hidden_size))
        carry: Carry = (zeros, zeros)
        outs = []
        for t in range(steps):
            carry, h = self.encoder_lstm(carry, x[:, t])
            outs.append(h)
        ctx = torch.stack(outs, dim=1) * length_mask(lengths, steps)[..., None]
        return ctx, carry


class AttnDecoderLSTM(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int = 256, word_emb: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.embedding = _embed(vocab_size, word_emb, generator)
        self.cell = OptimizedLSTMCell(word_emb, hidden_size, generator)
        self.attn_q = linear(hidden_size, hidden_size, generator)
        self.out = linear(2 * hidden_size, vocab_size, generator)

    def step(self, carry: Carry, word: torch.Tensor, ctx: torch.Tensor, ctx_mask: torch.Tensor):
        """One decode step. word (B,) int; ctx (B, L, H); ctx_mask (B, L)."""
        carry, h = self.cell(carry, self.embedding(word.long()))
        q = self.attn_q(h)
        scores = torch.einsum("bh,blh->bl", q, ctx) / math.sqrt(self.hidden_size)
        scores = torch.where(ctx_mask > 0, scores, torch.full_like(scores, -1e9))
        attended = torch.einsum("bl,blh->bh", torch.softmax(scores, dim=-1), ctx)
        return carry, self.out(torch.cat([h, attended], dim=-1))


class Seq2SeqSpeaker(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int = 256, world_feat_dim: int = 8,
                 max_decode_len: int = 40, word_emb: int = 128, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab_size, self.hidden_size, self.word_emb = vocab_size, hidden_size, word_emb
        self.world_feat_dim, self.max_decode_len = world_feat_dim, max_decode_len
        self.encoder = PathEncoderLSTM(world_feat_dim, hidden_size, generator=generator)
        self.decoder = AttnDecoderLSTM(vocab_size, hidden_size, word_emb, generator=generator)

    def encode(self, actions, world_feats, lengths):
        return self.encoder(actions, world_feats, lengths)

    def _start(self, actions, world_feats, lengths):
        ctx, carry = self.encode(actions, world_feats, lengths)
        return ctx, carry, length_mask(lengths, ctx.shape[1])

    def teacher_logits(self, actions, world_feats, lengths, target_words):
        """Teacher-forced logits: target_words (B, T) starting with BOS.
        Returns (B, T, V) logits predicting the next word."""
        ctx, c, ctx_mask = self._start(actions, world_feats, lengths)
        logits = []
        for i in range(target_words.shape[1]):
            c, lg = self.decoder.step(c, target_words[:, i], ctx, ctx_mask)
            logits.append(lg)
        return torch.stack(logits, dim=1)

    def scheduled_logits(self, actions, world_feats, lengths, target_words, sample_prob: float,
                         generator: Optional[torch.Generator] = None):
        """Scheduled-sampling logits (Bengio et al. 2015): each decode
        step's input is the gold word with probability 1 - sample_prob,
        else the model's argmax prediction. The draws come from
        ``generator``; at sample_prob 0 and 1 no draw decides anything."""
        ctx, c, ctx_mask = self._start(actions, world_feats, lengths)
        b, t = target_words.shape
        word = target_words[:, 0]
        logits = []
        for i in range(t):
            c, lg = self.decoder.step(c, word, ctx, ctx_mask)
            logits.append(lg)
            if i + 1 < t:
                u = torch.rand((b,), generator=generator, device=lg.device)
                model_word = lg.argmax(dim=-1)
                word = torch.where(u < sample_prob, model_word, target_words[:, i + 1].long())
        return torch.stack(logits, dim=1)

    @torch.no_grad()
    def rollout(self, actions, world_feats, lengths, bos_id: int, eos_id: int):
        """Argmax decode of all max_decode_len steps. Returns (B, T) ids."""
        ctx, c, ctx_mask = self._start(actions, world_feats, lengths)
        word = torch.full((actions.shape[0],), bos_id, dtype=torch.long, device=ctx.device)
        out = []
        for _ in range(self.max_decode_len):
            c, logits = self.decoder.step(c, word, ctx, ctx_mask)
            word = logits.argmax(dim=-1)
            out.append(word)
        return torch.stack(out, dim=1).int()

    @torch.no_grad()
    def beam_rollout(self, actions, world_feats, lengths, bos_id: int, eos_id: int,
                     beam_size: int = 4, alpha: float = 0.6):
        """Batched beam search with GNMT length normalisation
        (score / ((5+len)/6)^alpha); a finished beam extends with EOS only,
        at no cost. Returns (B, T) ids of each item's best hypothesis."""
        ctx, carry, ctx_mask = self._start(actions, world_feats, lengths)
        b, k, steps = ctx.shape[0], beam_size, self.max_decode_len
        dev = ctx.device
        ctx_k = ctx.repeat_interleave(k, dim=0)
        mask_k = ctx_mask.repeat_interleave(k, dim=0)
        hc = tuple(x.repeat_interleave(k, dim=0) for x in carry)
        word = torch.full((b * k,), bos_id, dtype=torch.long, device=dev)
        # only beam 0 is live at t=0, so the K first hypotheses differ
        scores = torch.full((b, k), -1e9, dtype=torch.float32, device=dev)
        scores[:, 0] = 0.0
        finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
        seqs = torch.full((b, k, steps), eos_id, dtype=torch.long, device=dev)
        batch_off = torch.arange(b, device=dev)[:, None] * k
        eos_only = None
        for t in range(steps):
            hc, logits = self.decoder.step(hc, word, ctx_k, mask_k)
            v = logits.shape[-1]
            if eos_only is None:
                eos_only = torch.full((v,), -1e9, dtype=torch.float32, device=dev)
                eos_only[eos_id] = 0.0
            logp = F.log_softmax(logits, dim=-1).view(b, k, v)
            logp = torch.where(finished[..., None], eos_only[None, None, :], logp)
            total = (scores[..., None] + logp).view(b, k * v)
            # top-k with ties to the lower index, as jax.lax.top_k
            order = torch.sort(total, dim=1, descending=True, stable=True).indices[:, :k]
            scores = torch.gather(total, 1, order)
            beam_idx, word_idx = order // v, order % v
            hc = tuple(x[(batch_off + beam_idx).reshape(-1)] for x in hc)
            seqs = torch.gather(seqs, 1, beam_idx[..., None].expand(-1, -1, steps)).clone()
            finished = torch.gather(finished, 1, beam_idx)
            seqs[:, :, t] = word_idx
            finished = finished | (word_idx == eos_id)
            word = word_idx.reshape(b * k)
        is_eos = seqs == eos_id
        first_eos = torch.argmax(is_eos.int(), dim=-1)
        hyp_len = torch.where(is_eos.any(-1), first_eos + 1, torch.full_like(first_eos, steps))
        norm = ((5.0 + hyp_len.float()) / 6.0) ** alpha
        best = torch.argmax(scores / norm, dim=1)
        return seqs[torch.arange(b, device=dev), best].int()
