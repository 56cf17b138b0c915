"""Visual question generation (VQG) — vestigial, as in the reference.

PyTorch counterpart of ``avlen_tpu/dialog/ques_gen.py``. The reference
ships a VQG model (ss_baselines/savi/dialog/ques_gen/: ResNet-18 image
encoder + LSTM question decoder, iq_vln.py:20-203) whose instantiation is
commented out in the simulator (soundspaces/simulator.py:199-204); only its
``Vocabulary`` is loaded by the trainer (ddppo_trainer.py:51-52, 80-81).
This module keeps that surface: a question vocabulary plus a small
image→question generator usable offline.

The decoder cell is the JAX module's: one ``cell_in`` Linear over
(word embedding ⊕ h) gives the gates i, f, g, o in that order, with one
bias (``nn.LSTMCell`` has two). ``utils/flax_bridge.load_quesgen_params``
carries the JAX module's parameters across.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from avlen_tpu_torch.dialog.speaker.model import _embed
from avlen_tpu_torch.dialog.speaker.vocab import Vocabulary
from avlen_tpu_torch.models.init import lecun_normal_
from avlen_tpu_torch.models.resnet import ResNet18

QUESTION_WORDS = ["what", "where", "is", "this", "that", "which", "way", "should", "i", "do", "how", "?"]

BOS_ID = 1


def ques_vocabulary() -> Vocabulary:
    """The Vocabulary the trainer loads (ddppo_trainer.py:80-81 equivalent)."""
    return Vocabulary(extra_words=QUESTION_WORDS)


def _dense(cin: int, cout: int, generator: Optional[torch.Generator]) -> nn.Linear:
    """Flax Dense's default init: lecun normal kernel, zero bias."""
    layer = nn.Linear(cin, cout)
    lecun_normal_(layer.weight, cin, generator)
    nn.init.zeros_(layer.bias)
    return layer


class QuesGen(nn.Module):
    """Image → question tokens (iq_vln.py capability; vestigial at runtime)."""

    def __init__(self, vocab_size: int, hidden_size: int = 128, max_len: int = 12,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.max_len = max_len
        self.encoder = ResNet18(3, num_outputs=hidden_size, generator=generator)
        self.embed = _embed(vocab_size, hidden_size, generator)
        self.w_out = _dense(hidden_size, vocab_size, generator)
        self.cell_in = _dense(2 * hidden_size, 4 * hidden_size, generator)

    @torch.no_grad()
    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        """rgb (B, H, W, 3) uint8 → (B, max_len) int64 token ids (argmax
        decode from BOS)."""
        h = self.encoder(rgb.float() / 255.0)
        c = torch.zeros_like(h)
        word = torch.full((rgb.shape[0],), BOS_ID, dtype=torch.long, device=rgb.device)
        outs = []
        for _ in range(self.max_len):
            gates = self.cell_in(torch.cat([self.embed(word), h], dim=-1))
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            word = self.w_out(h).argmax(-1)
            outs.append(word)
        return torch.stack(outs, dim=1)


def ques_out(model: QuesGen, vocab: Vocabulary, rgb: torch.Tensor) -> List[str]:
    """QuesGen.ques_out equivalent (ques_gen.py:122)."""
    ids = model(rgb).cpu().numpy()
    return [" ".join(vocab.decode(row)) for row in ids]
