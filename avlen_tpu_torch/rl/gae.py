"""Generalized advantage estimation as a reverse loop over time.

PyTorch counterpart of ``avlen_tpu/rl/gae.py`` (reference
RolloutStorage.compute_returns with use_gae=True,
ss_baselines/common/rollout_storage.py:160-180): ``next_masks[t] = 1 -
done[t]`` gates the value bootstrap and the advantage propagation across an
episode boundary.
"""

from __future__ import annotations

from typing import Tuple

import torch


def compute_gae(
    rewards: torch.Tensor,  # (T, B)
    values: torch.Tensor,  # (T, B)
    bootstrap_value: torch.Tensor,  # (B,)
    next_masks: torch.Tensor,  # (T, B) 1 - done_t: whether t+1 continues the episode
    gamma: float = 0.99,
    tau: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages, returns), each (T, B)."""
    gae = torch.zeros_like(bootstrap_value)
    next_value = bootstrap_value
    adv = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        m = next_masks[t]
        delta = rewards[t] + gamma * next_value * m - values[t]
        gae = delta + gamma * tau * m * gae
        next_value = values[t]
        adv.append(gae)
    advantages = torch.stack(adv[::-1])
    return advantages, advantages + values
