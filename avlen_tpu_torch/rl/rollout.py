"""Rollout storage and the recurrent rollout.

PyTorch counterpart of ``avlen_tpu/rl/rollout.py`` (reference
RolloutStorage, common/rollout_storage.py:16-241, and the per-step
rollout of ss_baselines/av_nav/ppo/ppo_trainer.py:150-230): the stacked
(T, B, ...) trajectory of one rollout, and ``collect_rollout``, an eager
loop of T policy acts and env steps where the JAX package runs one
``lax.scan``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

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


class CarryState(NamedTuple):
    """What one rollout hands the next: the env state, the observation to
    act on, the recurrent hidden and the mask for the next act. The JAX
    carry's PRNG key is a ``torch.Generator`` held by the caller's act."""

    env_state: Any
    obs: Dict[str, torch.Tensor]
    hidden: torch.Tensor
    masks: torch.Tensor  # (B,) mask for the next act


def stack_steps(items):
    """Per-step tensors, or dicts of them at any depth, stacked along a new
    leading time axis."""
    if isinstance(items[0], dict):
        return {k: stack_steps([it[k] for it in items]) for k in items[0]}
    return torch.stack(items)


@torch.no_grad()
def collect_rollout(
    env_step: Callable,  # (env_state, actions) -> (env_state, StepOutput)
    policy_apply: Callable,  # (obs, hidden, masks) -> (action, logp, value, hidden, logits)
    value_apply: Callable,  # (obs, hidden, masks) -> value
    carry: CarryState,
    num_steps: int,
) -> Tuple[CarryState, RolloutBatch]:
    """T steps of act → env step, each step's mask for the next act 1 − done;
    the bootstrap value of the last carry."""
    initial_hidden = carry.hidden
    steps = []
    for _ in range(num_steps):
        action, logp, value, hidden, _ = policy_apply(carry.obs, carry.hidden, carry.masks)
        env_state, out = env_step(carry.env_state, action)
        steps.append(dict(obs=carry.obs, actions=action, log_probs=logp, values=value,
                          rewards=out.reward, masks=carry.masks, dones=out.done, metrics=out.metrics))
        carry = CarryState(env_state, out.obs, hidden, 1.0 - out.done.float())
    traj = stack_steps(steps)
    bootstrap = value_apply(carry.obs, carry.hidden, carry.masks)
    return carry, RolloutBatch(initial_hidden=initial_hidden, bootstrap_value=bootstrap, **traj)
