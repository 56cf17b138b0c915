"""AV-WAN waypoint policy.

PyTorch counterpart of ``avlen_tpu/models/avwan_policy.py`` (reference
av_wan/ppo/policy.py, AudioNavBaselinePolicy over MapCNN ⊕ AudioCNN → GRU,
with av_wan/models/map_cnn.py): a categorical actor over the action map's
cells whose invalid waypoints are masked to −1e9 (never −inf, so that no
NaN enters the log-softmax), as CategoricalNetWithMask does
(ss_baselines/common/utils.py:75-128), and a linear critic.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from avlen_tpu_torch.models.encoders import AudioCNN, ConvEncoder
from avlen_tpu_torch.models.init import orthogonal_, zeros_
from avlen_tpu_torch.models.policy import (
    CriticHead,
    categorical_entropy,
    categorical_log_prob,
    categorical_sample,
)
from avlen_tpu_torch.models.rnn_state_encoder import RNNStateEncoder

NEG_INF = -1e9


class MapCNN(nn.Module):
    """3-conv encoder over a (size, size, channels) map (av_wan/models/map_cnn.py)."""

    def __init__(self, output_size: int, map_size: int, channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ConvEncoder_0 = ConvEncoder(channels, (map_size, map_size), output_size,
                                         kernels=[(4, 4), (3, 3), (3, 3)], strides=[(2, 2), (1, 1), (1, 1)],
                                         generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvEncoder_0(x)


class AVWanNet(nn.Module):
    """Spectrogram CNN ⊕ geometric-map CNN ⊕ acoustic-map CNN → GRU."""

    def __init__(
        self,
        hidden_size: int = 256,
        spectrogram_hw: Tuple[int, int] = (65, 26),
        gm_size: int = 20,
        am_size: int = 20,
        action_map_size: int = 9,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.hidden_size, self.action_map_size = hidden_size, action_map_size
        self.audio_encoder = AudioCNN(hidden_size, spectrogram_hw, generator=generator)
        self.gm_encoder = MapCNN(hidden_size, gm_size, 2, generator)
        self.am_encoder = MapCNN(hidden_size, am_size, 1, generator)
        self.state_encoder = RNNStateEncoder(3 * hidden_size, hidden_size, generator=generator)

    def features(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([self.audio_encoder(obs["spectrogram"]), self.gm_encoder(obs["gm"]),
                          self.am_encoder(obs["am"])], dim=-1)

    def forward(self, obs, hidden, masks):
        return self.state_encoder(self.features(obs), hidden, masks)

    def forward_sequence(self, obs, hidden, masks):
        t, b = masks.shape
        flat = {k: v.reshape((t * b,) + v.shape[2:]) for k, v in obs.items()}
        feats = self.features(flat).reshape(t, b, -1)
        return self.state_encoder.forward_sequence(feats, hidden, masks)

    def initial_state(self, batch: int, device=None) -> torch.Tensor:
        return self.state_encoder.initial_state(batch, device)


class AVWanPolicy(nn.Module):
    """Masked waypoint actor-critic."""

    def __init__(self, net: AVWanNet, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = net
        self.action_head = nn.Linear(net.hidden_size, self.num_waypoints)
        orthogonal_(self.action_head.weight, 0.01, generator)
        zeros_(self.action_head.bias)
        self.critic = CriticHead(net.hidden_size, generator)

    @property
    def num_waypoints(self) -> int:
        return self.net.action_map_size ** 2

    def initial_state(self, batch: int, device=None) -> torch.Tensor:
        return self.net.initial_state(batch, device)

    def _masked_logits(self, feats, action_mask):
        return torch.where(action_mask > 0, self.action_head(feats), NEG_INF)

    def act(self, obs, hidden, masks, action_mask, generator: Optional[torch.Generator] = None,
            deterministic: bool = False):
        """(action, log_prob, value, hidden, masked logits); argmax when
        ``deterministic``, else drawn from ``generator``."""
        feats, hidden = self.net(obs, hidden, masks)
        logits = self._masked_logits(feats, action_mask)
        value = self.critic(feats)
        action = logits.argmax(-1) if deterministic else categorical_sample(generator, logits)
        return action, categorical_log_prob(logits, action), value, hidden, logits

    def get_value(self, obs, hidden, masks, action_mask=None):
        feats, _ = self.net(obs, hidden, masks)
        return self.critic(feats)

    def evaluate_actions(self, obs, hidden, masks, actions, action_masks):
        feats, _ = self.net.forward_sequence(obs, hidden, masks)
        logits = self._masked_logits(feats, action_masks)
        values = self.critic(feats)
        return values, categorical_log_prob(logits, actions), categorical_entropy(logits), logits
