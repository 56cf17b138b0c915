"""Rollout storage.

PyTorch counterpart of ``RolloutBatch`` in ``avlen_tpu/rl/rollout.py``
(reference RolloutStorage, common/rollout_storage.py:16-241): the stacked
(T, B, ...) trajectory of one rollout.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch


class RolloutBatch(NamedTuple):
    obs: Dict[str, torch.Tensor]  # (T, B, ...) observation at act time
    actions: torch.Tensor  # (T, B)
    log_probs: torch.Tensor  # (T, B)
    values: torch.Tensor  # (T, B)
    rewards: torch.Tensor  # (T, B)
    masks: torch.Tensor  # (T, B) mask applied when acting at t (1 - done_{t-1})
    dones: torch.Tensor  # (T, B)
    metrics: Dict[str, torch.Tensor]  # (T, B) per-step measures
    initial_hidden: Any  # recurrent state / memory before step 0
    bootstrap_value: torch.Tensor  # (B,)

    def to(self, device) -> "RolloutBatch":
        """The batch with every tensor on ``device``."""
        def move(x):
            if isinstance(x, dict):
                return {k: move(v) for k, v in x.items()}
            if isinstance(x, tuple):
                return type(x)(*(move(v) for v in x))
            return x.to(device)

        return move(self)
