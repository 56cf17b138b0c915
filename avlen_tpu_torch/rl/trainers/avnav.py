"""AV-Nav AudioGoal PPO trainer.

PyTorch counterpart of ``AVNavTrainer`` in ``avlen_tpu/rl/trainers/avnav.py``
(reference PPOTrainer "AVNavTrainer", ss_baselines/av_nav/ppo/
ppo_trainer.py:43-676): recurrent audio-visual PPO (AudioCNN ⊕ VisualCNN →
GRU) with GAE, the windowed episode stats, TensorBoard scalars,
``ckpt.{i}.pth`` checkpoints every CHECKPOINT_INTERVAL updates, resume,
preemption, and the exactly-once eval of a checkpoint with sampled actions.
The rollout is the eager ``collect_rollout`` and the update the eager
``ppo_update`` (the JAX package jits each). Checkpoints hold the policy as
the Flax tree the JAX package holds; the optimizer state is the port's own.

``TPU.PRECISION`` is the CNNs' compute dtype (``compute_dtype``), as in
JAX; the GRU and the heads stay float32. ``train`` runs data-parallel
over the ranks of a process group, as the JAX trainer's device-mesh
branch does: its ``collect`` and ``update`` go through the trainers' one
superstep (``BaseRLTrainer.superstep``, ``parallel/ddppo.py``). A torch step reads host-served RIRs directly, so the chunked host-prefetch
audio path has no counterpart.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from avlen_tpu_torch.core.registry import registry
from avlen_tpu_torch.models.policy import AudioNavBaselineNet, Policy
from avlen_tpu_torch.rl.gae import compute_gae
from avlen_tpu_torch.rl.ppo import identity_grad_reduce, make_optimizer, ppo_config_from, ppo_update
from avlen_tpu_torch.rl.rollout import CarryState, RolloutBatch, collect_rollout
from avlen_tpu_torch.rl.trainers.base import (
    BaseRLTrainer,
    EpisodeWindow,
    eval_episode_accounting,
    eval_pass,
    exact_once_deal,
)
from avlen_tpu_torch.sim.builder import construct_batched_env
from avlen_tpu_torch.utils import preemption
from avlen_tpu_torch.utils.checkpoint import save_checkpoint
from avlen_tpu_torch.utils.flax_bridge import adam_to_flax, load_adam_flax, load_flax_params, to_flax_params
from avlen_tpu_torch.utils.logging import logger
from avlen_tpu_torch.utils.profiling import Timings
from avlen_tpu_torch.utils.tb import TensorboardWriter


@registry.register_trainer(name="AVNavTrainer")
class AVNavTrainer(BaseRLTrainer):
    """PPO over the batched env with the GRU audio-visual policy."""

    stack = "avnav"
    preemption_poll = "after"  # each update's checkpoint (the JAX trainer's order)

    def _setup(self, num_envs: Optional[int] = None):
        """Env, policy, optimizer and the first carry; ``setup_seconds`` is
        its wall time and ``bank_seconds`` the env build's (the spectrogram
        bank's render among it)."""
        t0 = time.perf_counter()
        cfg = self.config
        dtype = self.compute_dtype()
        self.ppo_cfg = ppo_config_from(cfg)
        self.num_steps = cfg.RL.PPO.num_steps
        self.env = self._make_env(num_envs)
        self._sync()
        self.bank_seconds = time.perf_counter() - t0
        gen = torch.Generator(device="cpu").manual_seed(cfg.SEED)
        self.policy = self._make_policy(gen, dtype).to(self.device)
        self.optimizer = make_optimizer(self.policy.parameters(), self.ppo_cfg)
        self.sample_generator = torch.Generator(device=self.device).manual_seed(self.rank_seed(cfg.SEED))
        # the minibatch permutations (the JAX trainer's PRNGKey(SEED + 1))
        self.ppo_generator = torch.Generator(device="cpu").manual_seed(self.rank_seed(cfg.SEED + 1))
        self.carry = self.reset()
        self._setup_done = True
        self.setup_seconds = time.perf_counter() - t0

    def trained_modules(self):
        return [self.policy]

    def _make_env(self, num_envs: Optional[int]):
        cfg = self.config
        return construct_batched_env(cfg, num_envs=num_envs, with_depth=True,
                                     with_rgb="RGB_SENSOR" in cfg.SENSORS and not cfg.EXTRA_RGB, device=self.device,
                                     slots=self.env_slots(num_envs or cfg.NUM_PROCESSES))

    def _make_policy(self, gen: torch.Generator, dtype: torch.dtype = torch.float32) -> Policy:
        """The policy, initialised from ``gen``, sized to ``self.env``, its
        CNNs computing at ``dtype``."""
        cfg = self.config
        sensors = self.env.config.sensors
        use_rgb, use_depth = "rgb" in sensors, "depth" in sensors
        # a bank without frames (reference data with no cached frames)
        # leaves depth out of the sensors, and the net without a visual tower
        frames = self.env.bank.depth if use_depth else self.env.bank.rgb if use_rgb else None
        return Policy(
            AudioNavBaselineNet(
                hidden_size=cfg.RL.PPO.hidden_size,
                spectrogram_hw=self.env.spec_config.out_shape[:2],
                visual_hw=tuple(frames.shape[3:5]) if frames is not None else None,
                use_rgb=use_rgb,
                use_depth=use_depth,
                generator=gen,
                dtype=dtype,
            ),
            num_actions=len(cfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS),
            generator=gen,
        )

    def reset(self, order=None, consts: Optional[Dict[str, torch.Tensor]] = None) -> CarryState:
        """A fresh carry: every slot at the start of its first episode (of
        ``order``'s streams and ``consts``' tables, when given), zero hidden."""
        b = self.env.num_envs
        state, obs = self.env.reset(order=order, consts=consts)
        return CarryState(env_state=state, obs=obs, hidden=self.policy.initial_state(b, self.device),
                          masks=torch.zeros((b,), dtype=torch.float32, device=self.device))

    def collect(self, carry: Optional[CarryState] = None, deterministic: bool = False,
                n: Optional[int] = None, consts: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        """One rollout of ``n`` (default RL.PPO.num_steps) steps from
        ``carry`` (default: the trainer's own, which is then advanced), the
        episode tables replaced by ``consts`` and actions drawn from
        ``generator`` when given. Returns (carry, RolloutBatch)."""
        policy, env = self.policy, self.env
        gen = self.sample_generator if generator is None else generator
        own = carry is None
        carry, batch = collect_rollout(
            lambda state, actions: env.step(state, actions, consts=consts),
            lambda obs, h, m: policy.act(obs, h, m, gen, deterministic),
            policy.get_value,
            self.carry if own else carry,
            self.num_steps if n is None else n,
        )
        if own:
            self.carry = carry
        return carry, batch

    def evaluate_actions(self, obs, hidden, masks, actions):
        return self.policy.evaluate_actions(obs, hidden, masks, actions)

    def update(self, batch: RolloutBatch, perms: Optional[Sequence] = None,
               grad_reduce=identity_grad_reduce) -> Dict[str, torch.Tensor]:
        """GAE and one PPO update on ``batch``, in place on the parameters;
        ``perms`` (one permutation of the env slots per epoch) replaces the
        draws from the PPO generator, ``grad_reduce`` acts before each step.
        Returns the averaged losses as tensors."""
        cfg = self.ppo_cfg
        adv, ret = compute_gae(batch.rewards, batch.values, batch.bootstrap_value,
                               1.0 - batch.dones.float(), cfg.gamma, cfg.tau)
        return ppo_update(batch, adv, ret, self.evaluate_actions, self.optimizer, cfg,
                          generator=self.ppo_generator, perms=perms, grad_reduce=grad_reduce)

    # ------------------------------------------------------------------
    def steps_per_rollout_step(self) -> int:
        """Env steps one stored rollout step stands for."""
        return 1

    def train(self) -> None:
        """NUM_UPDATES rounds of collect + update (ppo_trainer.py:372-460):
        resume first (RESUME_CHECKPOINT: the
        interrupted state, else the newest checkpoint; the loop then starts
        again at update 0, as in the JAX trainer), the window's
        ``Metrics/*`` (every rank's envs) and the losses' ``Policy/*``
        (averaged over ranks) every LOG_INTERVAL updates, a checkpoint every
        CHECKPOINT_INTERVAL updates and at the last. Timings
        ``collect_time``, ``update_time`` (each ending in a device
        synchronise), ``host_time`` and ``checkpoint_time``;
        ``train_seconds`` is the loop's wall time."""
        if not self.begin_train():
            return
        cfg = self.config
        os.makedirs(cfg.CHECKPOINT_FOLDER, exist_ok=True)
        os.makedirs(cfg.TENSORBOARD_DIR, exist_ok=True)
        window = EpisodeWindow(cfg.NUM_PROCESSES if self.mesh else self.env.num_envs, cfg.RL.PPO.reward_window_size)
        t_start = time.time()
        ckpt_count = 0
        preemption.register_signal_handlers()
        self.timings = timings = Timings()
        resume = self.try_to_resume()
        if resume is not None:
            self.restore(resume)
            self.broadcast_parameters()
            ckpt_count = int(resume.get("_resume_index", 0))

        def collect(_, carry):
            return self.collect(carry)

        def update(_, batch, key, grad_reduce):
            return None, self.update(batch, grad_reduce=grad_reduce)

        superstep = self.superstep(collect, update, timings)
        with TensorboardWriter(self.tensorboard_dir()) as writer:
            for update in range(cfg.NUM_UPDATES):
                if self.preemption_poll == "before" and self.preempted():
                    break
                _, self.carry, batch, stats = superstep(None, self.carry)
                stats = {k: float(v) for k, v in stats.items()}
                self.carry = self._refresh_episode_stream(self.carry)
                with timings.time("host_time"):
                    self.num_steps_done += window.add(self.window_view(batch)) * self.steps_per_rollout_step()
                self.num_updates_done += 1

                if update % cfg.LOG_INTERVAL == 0:
                    fps = self.num_steps_done / max(time.time() - t_start, 1e-6)
                    logger.info(f"{self.stack} update {update} fps {fps:.1f} frames {self.num_steps_done} "
                                + timings.summary())
                    writer.add_scalar("Metrics/fps", fps, self.num_steps_done)
                    for k, v in stats.items():
                        writer.add_scalar(f"Policy/{k}", v, self.num_steps_done)
                    for k, v in window.means().items():
                        writer.add_scalar(f"Metrics/{k}", v, self.num_steps_done)

                # every CHECKPOINT_INTERVAL updates (ddppo_trainer.py:1191)
                if (update + 1) % cfg.CHECKPOINT_INTERVAL == 0 or update + 1 == cfg.NUM_UPDATES:
                    with timings.time("checkpoint_time"):
                        self.checkpoint(f"ckpt.{ckpt_count}.pth")
                    ckpt_count += 1
                if self.preemption_poll == "after" and self.preempted():
                    break
        self.train_seconds = time.time() - t_start

    def restore(self, ckpt: Dict[str, Any]) -> None:
        """Parameters, the Adam state, the LR decay's step count and
        ``num_steps_done`` from a checkpoint this trainer wrote."""
        load_flax_params(self.policy, ckpt["state_dict"])
        if "optim_state" in ckpt:
            load_adam_flax(self.policy, self.optimizer.adam, ckpt["optim_state"]["adam"])
            self.optimizer.count = int(ckpt["optim_state"]["count"])
        self.num_steps_done = int(ckpt.get("extra_state", {}).get("step", 0))

    def _checkpoint_payload(self) -> Dict[str, Any]:
        """The policy as the Flax tree (``state_dict``, which the JAX package
        reads), the optimizer's state keyed by the same Flax paths, the
        config and ``extra_state``."""
        return {
            "state_dict": to_flax_params(self.policy),
            "optim_state": {"count": self.optimizer.count, "adam": adam_to_flax(self.policy, self.optimizer.adam)},
            "config": self.config.to_dict(),
            "extra_state": {"step": self.num_steps_done},
        }

    def save_checkpoint(self, name: str) -> str:
        return save_checkpoint(self.config.CHECKPOINT_FOLDER, name, self._checkpoint_payload())

    # ------------------------------------------------------------------
    eval_deterministic = False  # av_nav's reference eval samples (ppo_trainer.py:518)
    videos_from_first_rollout_only = True  # the JAX AV-Nav trainer's rule (avnav.py:385-387)

    def _eval_checkpoint(self, checkpoint_path: str, writer, checkpoint_index: int = 0) -> Dict[str, float]:
        """The exactly-once eval of one checkpoint: the env and policy
        rebuilt under the checkpoint's config, its parameters loaded, every
        slot dealt its share of the episodes (``exact_once_deal``) under the
        SOUND_TYPE's sound remap (``eval_consts``), actions from a generator
        seeded SEED+7 (sampled for AV-Nav, argmax for AV-WAN, as each stack's
        reference evaluates), each episode id counted once until
        TEST_EPISODE_COUNT; the means go to ``val/*`` with
        ``episodes_evaluated``; with VIDEO_OPTION, the episode videos of
        ``eval_videos``: AV-Nav's from the first rollout only, AV-WAN's
        from each rollout until 2 were made (each JAX trainer's rule)."""
        ckpt = self.load_checkpoint(checkpoint_path)
        self.reconfigure_from_checkpoint(ckpt)
        load_flax_params(self.policy, ckpt["state_dict"])
        num_episodes = int(self.env.eps["scene"].shape[0])
        count = min(self.config.TEST_EPISODE_COUNT, num_episodes)
        b = self.env.num_envs
        consts = self.env.eval_consts(self.config.SOUND_TYPE)
        carry = self.reset(order=exact_once_deal(num_episodes, b), consts=consts)
        gen = torch.Generator(device=self.device).manual_seed(self.config.SEED + 7)

        def collect():
            nonlocal carry
            carry, batch = self.collect(carry, deterministic=self.eval_deterministic, consts=consts,
                                        generator=gen)
            return batch

        max_rollouts = self.eval_rollout_budget(num_episodes, b, self.max_episode_steps())
        stats, self._last_eval_episode_ids = eval_pass(
            collect, count, max_rollouts,
            self.eval_videos(writer, checkpoint_index, self.videos_from_first_rollout_only))
        means = {k: float(np.mean(v)) for k, v in stats.items()}
        means.update(eval_episode_accounting(self._last_eval_episode_ids, count, self.stack))
        logger.info(f"{self.stack} eval ckpt {checkpoint_index}: "
                    + ", ".join(f"{k}={v:.3f}" for k, v in means.items()))
        for k, v in means.items():
            writer.add_scalar(f"val/{k}", v, checkpoint_index)
        return means

    def max_episode_steps(self) -> int:
        return self.env.config.max_episode_steps
