"""SMT-based audio-visual navigation policy (π_g of SAVi).

PyTorch counterpart of ``avlen_tpu/models/smt_policy.py`` (reference
ss_baselines/savi/ppo/policy.py:330-377, 501-674): features =
SMTCNN(rgb, depth) 128 ⊕ action embedding 16 ⊕ AudioCNN(spectrogram) 128 ⊕
pose 4 = 276-d, attended by the Scene Memory Transformer whose decoder query
is the belief vector (category belief in [:21], location belief in [21:23]
of a d_model-zero vector), with categorical actor and critic heads.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from avlen_tpu_torch.models.encoders import AudioCNN
from avlen_tpu_torch.models.init import linear
from avlen_tpu_torch.models.policy import (
    CategoricalHead,
    CriticHead,
    categorical_entropy,
    categorical_log_prob,
    categorical_sample,
)
from avlen_tpu_torch.models.smt import SMTStateEncoder
from avlen_tpu_torch.models.smt_cnn import SMTCNN


class AudioNavSMTNet(nn.Module):
    def __init__(
        self,
        spectrogram_hw: Tuple[int, int] = (65, 26),
        num_actions: int = 4,
        d_model: int = 256,
        nhead: int = 8,
        use_rgb: bool = True,
        use_depth: bool = True,
        use_belief_as_goal: bool = True,
        use_label_belief: bool = True,
        use_location_belief: bool = True,
        normalize_category_distribution: bool = False,
        use_category_input: bool = False,
        pretraining: bool = False,
        num_categories: int = 21,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_actions, self.d_model = num_actions, d_model
        self.use_rgb, self.use_depth = use_rgb, use_depth
        self.use_belief_as_goal = use_belief_as_goal
        self.use_label_belief, self.use_location_belief = use_label_belief, use_location_belief
        self.normalize_category_distribution = normalize_category_distribution
        self.use_category_input = use_category_input
        self.num_categories = num_categories
        self.goal_encoder = AudioCNN(128, spectrogram_hw, generator=generator)
        if use_rgb or use_depth:
            self.visual_encoder = SMTCNN(use_rgb=use_rgb, use_depth=use_depth, generator=generator)
        self.action_encoder = linear(num_actions, 16, generator)
        self.smt = SMTStateEncoder(
            input_size=self.feature_size,
            d_model=d_model,
            nhead=nhead,
            pose_indices=self.pose_indices,
            pretraining=pretraining,
            generator=generator,
        )

    @property
    def feature_size(self) -> int:
        visual = 64 * (int(self.use_rgb) + int(self.use_depth))
        return visual + 16 + 128 + (self.num_categories if self.use_category_input else 0) + 4

    @property
    def pose_indices(self) -> Tuple[int, int]:
        return (self.feature_size - 4, self.feature_size)

    def get_features(self, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor) -> torch.Tensor:
        """(B, feature_size); prev_actions (B,) ints, one-hot embedded."""
        parts = []
        if self.use_rgb or self.use_depth:
            parts.append(self.visual_encoder(obs.get("rgb"), obs.get("depth")))
        parts += [
            self.action_encoder(F.one_hot(prev_actions.long(), self.num_actions).float()),
            self.goal_encoder(obs["spectrogram"]),
        ]
        if self.use_category_input:
            parts.append(obs["category"])
        parts.append(obs["pose"])
        return torch.cat(parts, dim=-1)

    def belief_goal(self, obs: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
        if not self.use_belief_as_goal:
            return None
        pose = obs["pose"]
        belief = torch.zeros((pose.shape[0], self.d_model), dtype=torch.float32, device=pose.device)
        if self.use_label_belief:
            cat = obs["category_belief"]
            if self.normalize_category_distribution:
                cat = torch.softmax(cat, dim=-1)
            belief[:, : self.num_categories] = cat
        if self.use_location_belief:
            belief[:, self.num_categories : self.num_categories + 2] = obs["location_belief"]
        return belief

    def forward(self, obs, prev_actions, memory_feats, memory_valid):
        """Returns (attended state (B, d_model), raw features (B, F))."""
        x = self.get_features(obs, prev_actions)
        att = self.smt(x, memory_feats, memory_valid, goal=self.belief_goal(obs))
        return att, x

    def forward_with_features(self, obs, features, memory_feats, memory_valid):
        """Like forward, with the current step's features given."""
        return self.smt(features, memory_feats, memory_valid, goal=self.belief_goal(obs))


class SMTPolicy(nn.Module):
    """Actor-critic over AudioNavSMTNet (the goal policy π_g)."""

    def __init__(self, net: AudioNavSMTNet, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = net
        self.action_head = CategoricalHead(net.d_model, net.num_actions, generator)
        self.critic = CriticHead(net.d_model, generator)

    def act(self, obs, prev_actions, memory_feats, memory_valid,
            generator: Optional[torch.Generator] = None, deterministic: bool = False):
        att, x = self.net(obs, prev_actions, memory_feats, memory_valid)
        logits = self.action_head(att)
        value = self.critic(att)
        action = logits.argmax(-1) if deterministic else categorical_sample(generator, logits)
        return action, categorical_log_prob(logits, action), value, x, logits

    def evaluate_step(self, obs, prev_actions, memory_feats, memory_valid, actions):
        """One step of PPO re-evaluation, the towers recomputed."""
        att, x = self.net(obs, prev_actions, memory_feats, memory_valid)
        logits = self.action_head(att)
        value = self.critic(att)
        return value, categorical_log_prob(logits, actions), categorical_entropy(logits), logits, x

    def evaluate_step_frozen(self, obs, prev_actions, memory_feats, memory_valid, actions):
        """PPO re-evaluation under SCENE_MEMORY_TRANSFORMER.freeze_encoders
        (reference policy.py:646-656; savi.yaml sets it). Frozen towers make
        the step feature a function of (obs, prev_action) alone, so the
        stored rollout feature ``obs["__feature"]`` is their output: the
        towers are skipped, get no gradient, and the optimizer leaves them
        as they are, as the reference's requires_grad=False does."""
        feature = obs["__feature"]
        att = self.net.forward_with_features(obs, feature, memory_feats, memory_valid)
        logits = self.action_head(att)
        value = self.critic(att)
        return value, categorical_log_prob(logits, actions), categorical_entropy(logits), logits, feature

    def get_value(self, obs, prev_actions, memory_feats, memory_valid):
        att, _ = self.net(obs, prev_actions, memory_feats, memory_valid)
        return self.critic(att)
