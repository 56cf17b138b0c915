"""Actor-critic policies, heads and categorical helpers.

PyTorch counterpart of ``avlen_tpu/models/policy.py`` (reference
ss_baselines/av_nav/ppo/policy.py:22-212 and the shared heads of
ss_baselines/savi/ppo/policy.py:39-376): a linear categorical actor
(CategoricalNet, ss_baselines/common/utils.py:61-72, orthogonal(0.01) init),
a linear critic (orthogonal(1.0) init), and the AV-Nav baseline: AudioCNN ⊕
VisualCNN → GRU, under an actor-critic ``Policy``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from avlen_tpu_torch.models.encoders import AudioCNN, VisualCNN
from avlen_tpu_torch.models.init import orthogonal_, zeros_
from avlen_tpu_torch.models.rnn_state_encoder import RNNStateEncoder


class CategoricalHead(nn.Module):
    def __init__(self, in_features: int, num_actions: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, num_actions)
        orthogonal_(self.Dense_0.weight, 0.01, generator)
        zeros_(self.Dense_0.bias)

    def forward(self, x):
        return self.Dense_0(x)


class CriticHead(nn.Module):
    def __init__(self, in_features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, 1)
        orthogonal_(self.Dense_0.weight, 1.0, generator)
        zeros_(self.Dense_0.bias)

    def forward(self, x):
        return self.Dense_0(x)[..., 0]


def categorical_sample(generator: Optional[torch.Generator], logits: torch.Tensor) -> torch.Tensor:
    return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[..., 0]


def categorical_log_prob(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, actions.long()[..., None])[..., 0]


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


class AudioNavBaselineNet(nn.Module):
    """Spectrogram CNN ⊕ visual CNN → GRU (av_nav/ppo/policy.py:136-212).
    ``visual_hw`` is the frames' (H, W), which fixes the visual tower's
    layer shapes; with neither ``use_rgb`` nor ``use_depth`` there is no
    visual tower (as in the JAX package) and ``visual_hw`` is not read.
    The CNNs compute at ``dtype``; the GRU and the heads are float32."""

    def __init__(
        self,
        hidden_size: int = 512,
        spectrogram_hw: Tuple[int, int] = (65, 26),
        visual_hw: Optional[Tuple[int, int]] = (64, 64),
        use_rgb: bool = False,
        use_depth: bool = True,
        generator: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.hidden_size = hidden_size
        self.use_visual = use_rgb or use_depth
        self.audio_encoder = AudioCNN(hidden_size, spectrogram_hw, generator=generator, dtype=dtype)
        if self.use_visual:
            self.visual_encoder = VisualCNN(hidden_size, visual_hw, use_rgb, use_depth, generator=generator,
                                            dtype=dtype)
        rnn_input = (2 if self.use_visual else 1) * hidden_size
        self.state_encoder = RNNStateEncoder(rnn_input, hidden_size, generator=generator)

    def features(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = [self.audio_encoder(obs["spectrogram"])]
        if self.use_visual:
            x.append(self.visual_encoder(obs.get("rgb"), obs.get("depth")))
        return torch.cat(x, dim=-1)

    def forward(self, obs, hidden, masks):
        return self.state_encoder(self.features(obs), hidden, masks)

    def forward_sequence(self, obs, hidden, masks):
        """obs: (T, B, ...) tensors; masks (T, B)."""
        t, b = masks.shape
        flat = {k: v.reshape((t * b,) + v.shape[2:]) for k, v in obs.items()}
        feats = self.features(flat).reshape(t, b, -1)
        return self.state_encoder.forward_sequence(feats, hidden, masks)

    def initial_state(self, batch: int, device=None) -> torch.Tensor:
        return self.state_encoder.initial_state(batch, device)


class Policy(nn.Module):
    """Actor-critic over a recurrent net (av_nav/ppo/policy.py:22-99)."""

    def __init__(self, net: nn.Module, num_actions: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = net
        self.action_head = CategoricalHead(net.hidden_size, num_actions, generator)
        self.critic = CriticHead(net.hidden_size, generator)

    def initial_state(self, batch: int, device=None) -> torch.Tensor:
        return self.net.initial_state(batch, device)

    def act(self, obs, hidden, masks, generator: Optional[torch.Generator] = None,
            deterministic: bool = False):
        """(action, log_prob, value, hidden, logits); argmax actions when
        ``deterministic``, else drawn from ``generator``."""
        feats, hidden = self.net(obs, hidden, masks)
        logits = self.action_head(feats)
        value = self.critic(feats)
        action = logits.argmax(-1) if deterministic else categorical_sample(generator, logits)
        return action, categorical_log_prob(logits, action), value, hidden, logits

    def get_value(self, obs, hidden, masks):
        feats, _ = self.net(obs, hidden, masks)
        return self.critic(feats)

    def evaluate_actions(self, obs, hidden, masks, actions):
        """Sequence re-evaluation for PPO: obs (T, B, ...)."""
        feats, _ = self.net.forward_sequence(obs, hidden, masks)
        logits = self.action_head(feats)
        values = self.critic(feats)
        return values, categorical_log_prob(logits, actions), categorical_entropy(logits), logits
