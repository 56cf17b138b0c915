"""Plain R2R speaker: a path encoder LSTM and an attention decoder LSTM, teacher-forced.

The speaker of Fried et al. 2018 (Speaker-Follower Models for
Vision-and-Language Navigation): each step of the path is an action
embedding beside the step's world features, projected and run through an
LSTM; the decoder LSTM reads the previous word, attends over the encoder's
states by a dot product scaled by 1/sqrt(H), and predicts the next word
from its state beside the attended context. Written with ``torch.nn`` and
``torch.nn.functional`` alone, float32; parameter names are the program's.

``teacher_logits`` gives the decoder's logits at each step when its input
words are given (the start word, then the program's words), which is what
the program's greedy decode computed if it chose those words.

Where it departs from the published model, as the program does: each LSTM
is Flax's ``OptimizedLSTMCell`` (input kernels without bias, recurrent
kernels with one, gates i, f, g, o); the encoder runs every step of its
16, padding included, and only the attention masks the padded steps, with
-1e9; the word embedding is a learned table at the width the configuration
gives (300, GloVe's width, in the published speaker, which reads the GloVe
vectors), the world features are the synthetic world's geometry and goal
category (the panorama's ResNet-152 features in the published one), and
the vocabulary is the port's 79 words.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

GATES = ("i", "f", "g", "o")


class LSTMCell(nn.Module):
    def __init__(self, cin: int, hidden: int):
        super().__init__()
        for gate in GATES:
            self.add_module("i" + gate, nn.Linear(cin, hidden, bias=False))
            self.add_module("h" + gate, nn.Linear(hidden, hidden))

    def forward(self, c, h, x):
        m = self._modules
        i, f, g, o = (m["h" + k](h) + m["i" + k](x) for k in GATES)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


class PathEncoder(nn.Module):
    def __init__(self, world_feat_dim: int, hidden: int, action_emb: int = 32):
        super().__init__()
        self.hidden = hidden
        self.action_embedding = nn.Embedding(8, action_emb)
        self.Dense_0 = nn.Linear(action_emb + world_feat_dim, hidden)
        self.encoder_lstm = LSTMCell(hidden, hidden)

    def forward(self, actions, world_feats, lengths):
        x = self.Dense_0(torch.cat([self.action_embedding(actions.long()), world_feats], dim=-1))
        b, steps = actions.shape
        c = h = x.new_zeros((b, self.hidden))
        states = []
        for t in range(steps):
            c, h = self.encoder_lstm(c, h, x[:, t])
            states.append(h)
        inside = (torch.arange(steps, device=x.device)[None, :] < lengths[:, None]).float()
        return torch.stack(states, 1) * inside[..., None], inside, (c, h)


class AttnDecoder(nn.Module):
    def __init__(self, vocab_size: int, hidden: int, word_emb: int):
        super().__init__()
        self.hidden = hidden
        self.embedding = nn.Embedding(vocab_size, word_emb)
        self.cell = LSTMCell(word_emb, hidden)
        self.attn_q = nn.Linear(hidden, hidden)
        self.out = nn.Linear(2 * hidden, vocab_size)


class Speaker(nn.Module):
    def __init__(self, vocab_size: int, hidden: int, world_feat_dim: int, word_emb: int):
        super().__init__()
        self.encoder = PathEncoder(world_feat_dim, hidden)
        self.decoder = AttnDecoder(vocab_size, hidden, word_emb)

    def teacher_logits(self, actions, world_feats, lengths, words):
        """(B, T, V) logits of the next word at each step, ``words`` (B, T)
        the decoder's inputs."""
        ctx, inside, (c, h) = self.encoder(actions, world_feats, lengths)
        dec = self.decoder
        out = []
        for t in range(words.shape[1]):
            c, h = dec.cell(c, h, dec.embedding(words[:, t].long()))
            scores = torch.einsum("bh,blh->bl", dec.attn_q(h), ctx) / math.sqrt(dec.hidden)
            scores = scores.masked_fill(inside == 0, -1e9)
            attended = torch.einsum("bl,blh->bh", F.softmax(scores, dim=-1), ctx)
            out.append(dec.out(torch.cat([h, attended], dim=-1)))
        return torch.stack(out, 1)
