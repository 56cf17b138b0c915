"""Language (dialog) policy π_l.

PyTorch counterpart of ``avlen_tpu/models/dialog_policy.py`` (reference
AudioNavDialogPolicy / AudioNavDialogNet, ss_baselines/savi/ppo/policy.py:
203-283, 679-916): π_g's SMT path over the dialog window's memory, plus the
oracle instruction embedded by the frozen CLIP text tower, projected by
``dialog_layer``, and a second transformer (``DialogStateEncoder``) over
the short memory of SMT states within the window. Submodule names follow
the Flax tree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from avlen_tpu_torch.models.clip_text import CLIPTextEncoder
from avlen_tpu_torch.models.dialog_encoder import DialogStateEncoder
from avlen_tpu_torch.models.init import linear
from avlen_tpu_torch.models.policy import (
    CategoricalHead,
    CriticHead,
    categorical_entropy,
    categorical_log_prob,
    categorical_sample,
)
from avlen_tpu_torch.models.smt_policy import AudioNavSMTNet


class AudioNavDialogNet(nn.Module):
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
        pretraining: bool = False,
        clip_width: int = 512,
        clip_layers: int = 12,
        num_categories: int = 21,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_actions, self.d_model = num_actions, d_model
        self.smt_net = AudioNavSMTNet(
            spectrogram_hw=spectrogram_hw, num_actions=num_actions, d_model=d_model, nhead=nhead,
            use_rgb=use_rgb, use_depth=use_depth, use_belief_as_goal=use_belief_as_goal,
            use_label_belief=use_label_belief, use_location_belief=use_location_belief,
            pretraining=pretraining, num_categories=num_categories, generator=generator,
        )
        self.clip = CLIPTextEncoder(width=clip_width, layers=clip_layers, generator=generator)
        self.dialog_layer = linear(self.clip.embed_dim, d_model, generator)
        self.dialog_state_encoder = DialogStateEncoder(
            state_size=d_model, dialog_emb_size=d_model, d_model=d_model, nhead=nhead, generator=generator)

    @property
    def feature_size(self) -> int:
        return self.smt_net.feature_size

    @torch.no_grad()
    def clip_embed(self, dialog_tokens: torch.Tensor) -> torch.Tensor:
        """(B, 77) tokens → (B, clip embed_dim) FROZEN CLIP text features
        (no gradient reaches the tower; policy.py:847-849)."""
        return self.clip(dialog_tokens)

    def forward(self, obs, prev_actions, memory_feats, memory_valid, state_memory, state_memory_valid,
                dialog_tokens: Optional[torch.Tensor], agent_step, dialog_clip: Optional[torch.Tensor] = None):
        """Returns (x_att_dialog (B, d_model), features (B, F), x_att (B,
        d_model)). ``dialog_clip``: a precomputed frozen CLIP embedding,
        which skips the tower."""
        x = self.smt_net.get_features(obs, prev_actions)
        belief = self.smt_net.belief_goal(obs)
        x_att = self.smt_net.smt(x, memory_feats, memory_valid, goal=belief)
        if dialog_clip is not None:
            dialog_emb = self.dialog_layer(dialog_clip.detach())
        elif dialog_tokens is not None:
            dialog_emb = self.dialog_layer(self.clip_embed(dialog_tokens))
        else:
            dialog_emb = None
        goal = belief if belief is not None else torch.zeros((x.shape[0], self.d_model), device=x.device)
        att = self.dialog_state_encoder(x_att, state_memory, state_memory_valid, dialog_emb, agent_step, goal)
        return att, x, x_att


class DialogPolicy(nn.Module):
    """Actor-critic over AudioNavDialogNet (π_l; act_dialog of
    savi/ppo/policy.py:130-162)."""

    def __init__(self, net: AudioNavDialogNet, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = net
        self.action_head = CategoricalHead(net.d_model, net.num_actions, generator)
        self.critic = CriticHead(net.d_model, generator)

    def clip_embed(self, dialog_tokens):
        return self.net.clip_embed(dialog_tokens)

    def act(self, obs, prev_actions, memory_feats, memory_valid, state_memory, state_memory_valid,
            dialog_tokens, agent_step, generator: Optional[torch.Generator] = None,
            deterministic: bool = False, dialog_clip=None):
        """(action, log_prob, value, features, x_att (the SMT state), logits)."""
        att, x, x_att = self.net(obs, prev_actions, memory_feats, memory_valid, state_memory,
                                 state_memory_valid, dialog_tokens, agent_step, dialog_clip=dialog_clip)
        logits = self.action_head(att)
        value = self.critic(att)
        action = logits.argmax(-1) if deterministic else categorical_sample(generator, logits)
        return action, categorical_log_prob(logits, action), value, x, x_att, logits

    def evaluate_step(self, obs, prev_actions, memory_feats, memory_valid, state_memory, state_memory_valid,
                      dialog_tokens, agent_step, actions, dialog_clip=None):
        """(value, log_prob, entropy, logits, features, x_att) of given actions."""
        att, x, x_att = self.net(obs, prev_actions, memory_feats, memory_valid, state_memory,
                                 state_memory_valid, dialog_tokens, agent_step, dialog_clip=dialog_clip)
        logits = self.action_head(att)
        value = self.critic(att)
        return value, categorical_log_prob(logits, actions), categorical_entropy(logits), logits, x, x_att
