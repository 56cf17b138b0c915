"""AV-WAN waypoint trainer.

PyTorch counterpart of ``AVWanTrainer`` in ``avlen_tpu/rl/trainers/avwan.py``
(reference av_wan/ppo/ppo_trainer.py, "AVWanTrainer"): PPO over waypoint
actions in the hierarchical MapNav env (``sim/mapnav.py``), the invalid
cells of the action map masked. A rollout step is one high-level step,
itself up to PREDICTION_INTERVAL planned low-level steps; the mask of the
acting step rides in the stored obs under ``__amask`` for re-evaluation.
The loop, checkpoints, resume and exactly-once eval are AV-Nav's
(``rl/trainers/avnav.py``), with AV-WAN's own protocol where it differs:
the preemption poll before each update, frames counted as T·B·
PREDICTION_INTERVAL, and argmax actions at eval.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from avlen_tpu_torch.core.registry import registry
from avlen_tpu_torch.models.avwan_policy import AVWanNet, AVWanPolicy
from avlen_tpu_torch.rl.rollout import CarryState, collect_rollout
from avlen_tpu_torch.rl.trainers.avnav import AVNavTrainer
from avlen_tpu_torch.sim.builder import construct_batched_env
from avlen_tpu_torch.sim.env import StepOutput
from avlen_tpu_torch.sim.mapnav import BatchedMapNavEnv, MapNavConfig


@registry.register_trainer(name="AVWanTrainer")
class AVWanTrainer(AVNavTrainer):
    stack = "avwan"
    eval_deterministic = True  # av_wan's trainer evaluates with argmax actions
    videos_from_first_rollout_only = False  # until 2 videos, as the JAX trainer (avwan.py:310)
    preemption_poll = "before"  # each update, as the JAX AV-WAN trainer polls

    def _make_env(self, num_envs: Optional[int]) -> BatchedMapNavEnv:
        cfg = self.config
        tc = cfg.TASK_CONFIG.TASK
        map_cfg = MapNavConfig(
            internal_map_size=tc.GEOMETRIC_MAP.INTERNAL_MAP_SIZE // 10,
            action_map_size=tc.ACTION_MAP.MAP_SIZE,
            gm_size=tc.GEOMETRIC_MAP.MAP_SIZE // 10,
            am_size=tc.ACOUSTIC_MAP.MAP_SIZE,
            prediction_interval=cfg.PREDICTION_INTERVAL,
        )
        return BatchedMapNavEnv(construct_batched_env(cfg, num_envs=num_envs, with_depth=True, device=self.device,
                                                      slots=self.env_slots(num_envs or cfg.NUM_PROCESSES)),
                                map_cfg)

    def _make_policy(self, gen: torch.Generator, dtype: torch.dtype = torch.float32) -> AVWanPolicy:
        map_cfg = self.env.config
        return AVWanPolicy(
            AVWanNet(
                hidden_size=self.config.RL.PPO.hidden_size,
                spectrogram_hw=self.env.env.spec_config.out_shape[:2],
                gm_size=map_cfg.gm_size,
                am_size=map_cfg.am_size,
                action_map_size=map_cfg.action_map_size,
                generator=gen,
                dtype=dtype,
            ),
            generator=gen,
        )

    def reset(self, order=None, consts: Optional[Dict[str, torch.Tensor]] = None) -> CarryState:
        """AV-Nav's fresh carry, its env state the (env state, mapper) pair
        and its obs holding their action mask under ``__amask``."""
        b = self.env.num_envs
        state, obs = self.env.reset(order=order, consts=consts)
        return CarryState(env_state=state, obs=self._with_mask(obs),
                          hidden=self.policy.initial_state(b, self.device),
                          masks=torch.zeros((b,), dtype=torch.float32, device=self.device))

    def _with_mask(self, obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {**obs, "__amask": self.env.action_mask(obs)}

    def collect(self, carry: Optional[CarryState] = None, deterministic: bool = False,
                n: Optional[int] = None, consts: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        """One rollout of ``n`` (default RL.PPO.num_steps) high-level steps,
        as ``AVNavTrainer.collect``: the shared ``collect_rollout`` over
        MapNav steps whose obs carry their action mask, which the policy
        acts under and the batch keeps for re-evaluation."""
        policy, env = self.policy, self.env
        gen = self.sample_generator if generator is None else generator
        own = carry is None

        def env_step(state, waypoints):
            state, obs, reward, done, metrics = env.step(state, waypoints, consts=consts)
            return state, StepOutput(self._with_mask(obs), reward, done, metrics)

        carry, batch = collect_rollout(
            env_step,
            lambda obs, h, m: policy.act(obs, h, m, obs["__amask"], gen, deterministic),
            policy.get_value,
            self.carry if own else carry,
            self.num_steps if n is None else n,
        )
        if own:
            self.carry = carry
        return carry, batch

    def evaluate_actions(self, obs, hidden, masks, actions):
        sensor_obs = {k: v for k, v in obs.items() if not k.startswith("__")}
        return self.policy.evaluate_actions(sensor_obs, hidden, masks, actions, obs["__amask"])

    def steps_per_rollout_step(self) -> int:
        return self.config.PREDICTION_INTERVAL

    def max_episode_steps(self) -> int:
        return self.env.env.config.max_episode_steps
