"""Query/option policy π_q.

PyTorch counterpart of ``avlen_tpu/models/option_policy.py`` (reference
AudioNavOptionPolicy / AudioNavOptionNet, ss_baselines/savi/ppo/policy.py:
286-327, 919-1114): π_g's step features (visual 128 ⊕ action 16 ⊕ audio 128
⊕ pose 4 = 276) followed by the 32-d query-state embedding, 308 in all, with
the pose at (272, 276); so the SMT's entries are 320 wide once the pose is
re-encoded to 16. The memory entry stores concat(features,
last_query_info) (policy.py:1062-1065). Heads: the 2-action option
distribution, the critic and the 2-class ``uncertainty`` head
(CriticHead2, savi/ppo/policy.py:46-61). ``dtype`` goes into the audio,
visual and SMT encoders; the action encoder and the three heads are
float32, as in JAX.
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


class AudioNavOptionNet(nn.Module):
    def __init__(
        self,
        spectrogram_hw: Tuple[int, int] = (65, 26),
        num_actions: int = 4,  # low-level actions (the previous-action embedding)
        d_model: int = 256,
        nhead: int = 8,
        use_rgb: bool = True,
        use_depth: bool = True,
        use_belief_as_goal: bool = True,
        use_label_belief: bool = True,
        use_location_belief: bool = True,
        query_count_emb_size: int = 32,
        pretraining: bool = False,
        num_categories: int = 21,
        generator: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_actions, self.d_model = num_actions, d_model
        self.use_rgb, self.use_depth = use_rgb, use_depth
        self.use_belief_as_goal = use_belief_as_goal
        self.use_label_belief, self.use_location_belief = use_label_belief, use_location_belief
        self.query_count_emb_size = query_count_emb_size
        self.num_categories = num_categories
        self.goal_encoder = AudioCNN(128, spectrogram_hw, generator=generator, dtype=dtype)
        self.visual_encoder = SMTCNN(use_rgb=use_rgb, use_depth=use_depth, generator=generator, dtype=dtype)
        self.action_encoder = linear(num_actions, 16, generator)
        self.smt = SMTStateEncoder(
            input_size=self.feature_size, d_model=d_model, nhead=nhead,
            pose_indices=self.pose_indices, pretraining=pretraining, generator=generator, dtype=dtype,
        )

    @property
    def base_feature_size(self) -> int:
        return 64 * (int(self.use_rgb) + int(self.use_depth)) + 16 + 128 + 4

    @property
    def feature_size(self) -> int:
        # the query-state embedding follows the pose (policy.py:978-982)
        return self.base_feature_size + self.query_count_emb_size

    @property
    def pose_indices(self) -> Tuple[int, int]:
        return (self.base_feature_size - 4, self.base_feature_size)

    def get_base_features(self, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.visual_encoder(obs.get("rgb"), obs.get("depth")),
            self.action_encoder(F.one_hot(prev_actions.long(), self.num_actions).float()),
            self.goal_encoder(obs["spectrogram"]),
            obs["pose"],
        ], dim=-1)

    def belief_goal(self, obs) -> Optional[torch.Tensor]:
        if not self.use_belief_as_goal:
            return None
        pose = obs["pose"]
        belief = torch.zeros((pose.shape[0], self.d_model), dtype=torch.float32, device=pose.device)
        if self.use_label_belief:
            belief[:, : self.num_categories] = obs["category_belief"]
        if self.use_location_belief:
            belief[:, self.num_categories : self.num_categories + 2] = obs["location_belief"]
        return belief

    def forward(self, obs, prev_actions, memory_feats, memory_valid, query_state, last_query_info):
        """memory_feats (B, M, feature_size) entries concat(x, last_query_info);
        returns (attended state, this step's memory entry)."""
        x = self.get_base_features(obs, prev_actions)
        att = self.smt(torch.cat([x, query_state], dim=-1), memory_feats, memory_valid, goal=self.belief_goal(obs))
        return att, torch.cat([x, last_query_info], dim=-1).detach()


class OptionPolicy(nn.Module):
    """π_q heads: the 2-action option distribution, the critic and the
    uncertainty head (savi/ppo/policy.py:46-61, act_option :98-127)."""

    def __init__(self, net: AudioNavOptionNet, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = net
        self.action_head = CategoricalHead(net.d_model, 2, generator)
        self.critic = CriticHead(net.d_model, generator)
        self.uncertainty = linear(net.d_model, 2, generator)

    def act(self, obs, prev_actions, memory_feats, memory_valid, query_state, last_query_info,
            generator: Optional[torch.Generator] = None, deterministic: bool = False):
        """(option, log_prob, value, memory entry, logits, uncertainty logits)."""
        att, x_mem = self.net(obs, prev_actions, memory_feats, memory_valid, query_state, last_query_info)
        logits = self.action_head(att)
        value = self.critic(att)
        unct_logits = self.uncertainty(att)
        action = logits.argmax(-1) if deterministic else categorical_sample(generator, logits)
        return action, categorical_log_prob(logits, action), value, x_mem, logits, unct_logits

    def evaluate_step(self, obs, prev_actions, memory_feats, memory_valid, query_state, last_query_info, actions):
        """(value, log_prob, entropy, logits, uncertainty logits, memory entry)."""
        att, x_mem = self.net(obs, prev_actions, memory_feats, memory_valid, query_state, last_query_info)
        logits = self.action_head(att)
        value = self.critic(att)
        unct_logits = self.uncertainty(att)
        return value, categorical_log_prob(logits, actions), categorical_entropy(logits), logits, unct_logits, x_mem
