"""Mask-aware recurrent state encoder (GRU/LSTM).

PyTorch counterpart of ``avlen_tpu/models/rnn_state_encoder.py`` (reference
RNNStateEncoder, ss_baselines/av_nav/models/rnn_state_encoder.py:11-149): a
recurrent core whose hidden state is zeroed at episode boundaries by a
per-step mask, with a one-step forward for acting and a sequence forward
for PPO re-evaluation that equals stepping one by one.

The four cell parameters are bare ``nn.Parameter``s in the JAX layout:
``w_ih`` (D, G·H) and ``w_hh`` (H, G·H) with gate columns [r | z | n] for
GRU and [i | f | g | o] for LSTM, so ``utils/flax_bridge.py`` carries them
unchanged. ``nn.GRU`` is not used: its (G·H, D) layout and fused sequence
would skip the per-step mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from avlen_tpu_torch.models.init import orthogonal_


class RNNStateEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, rnn_type: str = "GRU",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.rnn_type = rnn_type
        g, h, d = self.num_gates, hidden_size, input_size
        # Flax orthogonal() on the (D, G·H) and (H, G·H) matrices as they stand
        self.w_ih = nn.Parameter(orthogonal_(torch.empty(d, g * h), 1.0, generator))
        self.w_hh = nn.Parameter(orthogonal_(torch.empty(h, g * h), 1.0, generator))
        self.b_ih = nn.Parameter(torch.zeros(g * h))
        self.b_hh = nn.Parameter(torch.zeros(g * h))

    @property
    def is_lstm(self) -> bool:
        return self.rnn_type.upper() == "LSTM"

    @property
    def num_gates(self) -> int:
        return 4 if self.is_lstm else 3

    def initial_state(self, batch: int, device=None) -> torch.Tensor:
        """Packed hidden: (B, H) for GRU, (B, 2H) = [h, c] for LSTM."""
        mult = 2 if self.is_lstm else 1
        return torch.zeros((batch, mult * self.hidden_size), dtype=torch.float32, device=device)

    def _cell(self, x: torch.Tensor, packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One unmasked cell step: (output, new packed hidden)."""
        hsz = self.hidden_size
        gi = x @ self.w_ih + self.b_ih
        if self.is_lstm:
            h, c = packed[:, :hsz], packed[:, hsz:]
            i, f, g, o = torch.chunk(gi + (h @ self.w_hh + self.b_hh), 4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            return h_new, torch.cat([h_new, c_new], dim=-1)
        h = packed
        gh = h @ self.w_hh + self.b_hh
        r = torch.sigmoid(gi[:, :hsz] + gh[:, :hsz])
        z = torch.sigmoid(gi[:, hsz : 2 * hsz] + gh[:, hsz : 2 * hsz])
        n = torch.tanh(gi[:, 2 * hsz :] + r * gh[:, 2 * hsz :])
        h_new = (1.0 - z) * n + z * h
        return h_new, h_new

    def forward(self, x: torch.Tensor, hidden: torch.Tensor, masks: torch.Tensor):
        """One step: x (B, D), packed hidden, masks (B,), 0 at an episode start."""
        return self._cell(x, hidden * masks[:, None])

    def forward_sequence(self, x: torch.Tensor, hidden: torch.Tensor, masks: torch.Tensor):
        """x (T, B, D), masks (T, B) → outputs (T, B, H), final packed hidden."""
        outs = []
        for t in range(x.shape[0]):
            out, hidden = self._cell(x[t], hidden * masks[t][:, None])
            outs.append(out)
        return torch.stack(outs), hidden
