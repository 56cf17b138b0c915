"""Scripted baseline agents + local benchmark harness.

PyTorch counterpart of ``avlen_tpu/sim/simple_agents.py``: the agents of
ss_baselines/common/simple_agents.py (RandomAgent, ForwardOnlyAgent,
RandomForwardAgent, GoalFollower) and the episode loop of
common/benchmark.py, batched over the env on its device.

The random agents draw from a ``torch.Generator`` on the env's device,
seeded with ``seed``; its stream is not ``jax.random``'s, so their actions
differ from the JAX package's at the same seed.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional

import numpy as np
import torch

from avlen_tpu_torch.sim.env import BatchedAudioNavEnv, EnvState


class _Seeded:
    def __init__(self, seed: int = 0):
        self.seed = seed
        self._gen: Optional[torch.Generator] = None

    def generator(self, env: BatchedAudioNavEnv) -> torch.Generator:
        if self._gen is None:
            self._gen = torch.Generator(device=env.device).manual_seed(self.seed)
        return self._gen


class RandomAgent(_Seeded):
    """Uniform over {STOP, FWD, LEFT, RIGHT} (simple_agents.py)."""

    def act(self, env: BatchedAudioNavEnv, state: EnvState, obs) -> torch.Tensor:
        return torch.randint(0, 4, (env.num_envs,), generator=self.generator(env), device=env.device)


class ForwardOnlyAgent:
    def act(self, env: BatchedAudioNavEnv, state: EnvState, obs) -> torch.Tensor:
        return torch.ones((env.num_envs,), dtype=torch.long, device=env.device)


class RandomForwardAgent(_Seeded):
    """80% forward, else random turn."""

    def act(self, env: BatchedAudioNavEnv, state: EnvState, obs) -> torch.Tensor:
        gen = self.generator(env)
        fwd = torch.rand((env.num_envs,), generator=gen, device=env.device) < 0.8
        turn = torch.randint(2, 4, (env.num_envs,), generator=gen, device=env.device)
        return torch.where(fwd, torch.ones_like(turn), turn)


class GoalFollower:
    """Follows oracle actions (GoalFollower in simple_agents.py)."""

    def act(self, env: BatchedAudioNavEnv, state: EnvState, obs) -> torch.Tensor:
        return env.oracle_action(state)


def benchmark_agent(env: BatchedAudioNavEnv, agent, num_episodes: int = 50, max_steps: int = 2000) -> Dict[str, float]:
    """Local Benchmark.evaluate equivalent (common/benchmark.py:26-107):
    step every slot until ``num_episodes`` episodes ended or ``max_steps``
    batched steps ran; the mean of each step metric over the ended
    episodes, taken in slot order within a step."""
    state, obs = env.reset()
    stats = collections.defaultdict(list)
    episodes = 0
    steps = 0
    while episodes < num_episodes and steps < max_steps:
        actions = agent.act(env, state, obs)
        state, out = env.step(state, actions)
        obs = out.obs
        dones = out.done.cpu().numpy()
        metrics = {k: v.cpu().numpy() for k, v in out.metrics.items()}
        for b in np.nonzero(dones)[0]:
            if episodes >= num_episodes:
                break
            for k in metrics:
                stats[k].append(metrics[k][b])
            episodes += 1
        steps += 1
    return {k: float(np.mean(v)) for k, v in stats.items()}
