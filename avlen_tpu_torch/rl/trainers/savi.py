"""SAVi trainer: SMT policy + belief predictor PPO.

PyTorch counterpart of ``SaviTrainer`` in ``avlen_tpu/rl/trainers/savi.py``
(reference ppo_trainer.py:93-1311, plain SAVi path) with the two-stage
recipe of the reference configs: stage 1 ``savi_pretraining.yaml`` (SMT
pretraining, memory 1), stage 2 ``savi.yaml`` (memory 150, frozen encoders,
the belief predictor filling category/location beliefs), which starts from
stage 1's checkpoint. ``_setup`` builds the batched env, the networks and
the optimizers from the config and merges pretrained weights; ``collect``
runs a rollout in which the SMT policy acts step by step, with the belief
predictor filling the beliefs before each act; ``update`` runs GAE, the PPO
update with batched ring re-evaluation, and the belief predictor's online
location regression (ppo_trainer.py:959-1032); ``train()`` loops collect +
update with resume, logging, checkpoints and preemption, data-parallel over
the ranks of a process group (``parallel/ddppo.py``: both optimizers'
gradients averaged before their steps); ``eval()`` runs the exactly-once
eval of a checkpoint or a folder of them.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from avlen_tpu_torch.core.registry import registry
from avlen_tpu_torch.models.belief_predictor import (
    BeliefPredictorNet,
    init_belief_state,
    update_beliefs,
)
from avlen_tpu_torch.models.memory import init_memory
from avlen_tpu_torch.models.smt_policy import AudioNavSMTNet, SMTPolicy
from avlen_tpu_torch.rl.gae import compute_gae
from avlen_tpu_torch.rl.ppo import identity_grad_reduce, make_optimizer, ppo_config_from, ppo_update
from avlen_tpu_torch.rl.rollout import RolloutBatch
from avlen_tpu_torch.rl.rollout_smt import (
    SMTCarry,
    collect_rollout_smt,
    evaluate_sequence_smt,
    evaluate_sequence_smt_batched,
)
from avlen_tpu_torch.rl.trainers.base import (
    BaseRLTrainer,
    EpisodeWindow,
    eval_episode_accounting,
    eval_pass,
    exact_once_deal,
)
from avlen_tpu_torch.sim.builder import construct_batched_env
from avlen_tpu_torch.utils import preemption
from avlen_tpu_torch.utils.checkpoint import merge_matching_params, save_checkpoint
from avlen_tpu_torch.utils.flax_bridge import adam_to_flax, load_adam_flax, load_flax_params, to_flax_params
from avlen_tpu_torch.utils.logging import logger
from avlen_tpu_torch.utils.profiling import Timings, span
from avlen_tpu_torch.utils.tb import TensorboardWriter


@registry.register_trainer(name="savi")
class SaviTrainer(BaseRLTrainer):
    def __init__(self, config, device: Union[str, torch.device] = "cuda"):
        super().__init__(config, device)

    def _setup(self, num_envs: Optional[int] = None):
        """Env, networks (pretrained weights merged in), optimizers and the
        first carry; ``setup_seconds`` is its wall time and
        ``pretrained_counts`` the (copied, kept fresh) tensor counts of the
        policy's pretrained merge, (0, 0) without one."""
        t0 = time.perf_counter()
        cfg = self.config
        dev = self.device
        dtype = self.compute_dtype()
        self.ppo_cfg = ppo_config_from(cfg)
        self.num_steps = cfg.RL.PPO.num_steps
        smt_cfg = cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER
        bp_cfg = cfg.RL.PPO.BELIEF_PREDICTOR
        policy_path, belief_path = pretrained_paths(cfg)
        for path in (policy_path, belief_path):
            if path and not os.path.exists(path):
                # a typo'd path must not silently start a staged recipe from scratch
                raise FileNotFoundError(f"configured pretrained weights not found: {path}")

        self.env = construct_batched_env(
            cfg, num_envs=num_envs, with_depth=True, with_rgb=True,
            extra_sensors=("category_belief", "location_belief", "category"), device=dev,
            slots=self.env_slots(num_envs or cfg.NUM_PROCESSES),
        )
        self.memory_size = smt_cfg.memory_size

        # parameters are drawn on the CPU from the config seed, then moved
        gen = torch.Generator(device="cpu").manual_seed(cfg.SEED)
        self.policy = SMTPolicy(
            AudioNavSMTNet(
                spectrogram_hw=self.env.spec_config.out_shape[:2],
                num_actions=len(cfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS),
                d_model=smt_cfg.hidden_size,
                nhead=smt_cfg.nhead,
                use_rgb="rgb" in self.env.config.sensors,
                use_depth="depth" in self.env.config.sensors,
                use_belief_as_goal=cfg.RL.PPO.use_belief_predictor or smt_cfg.pretraining,
                use_label_belief=bp_cfg.use_label_belief,
                use_location_belief=bp_cfg.use_location_belief,
                normalize_category_distribution=bp_cfg.normalize_category_distribution,
                pretraining=smt_cfg.pretraining,
                generator=gen,
                dtype=dtype,
            ),
            generator=gen,
        ).to(dev).eval()
        self.feature_size = self.policy.net.feature_size
        self.pretrained_counts = (0, 0)
        if policy_path:
            # cross-stage weight transfer (DDPPO.pretrained_weights, or the SMT
            # pretrained_path: ddppo_trainer.py:244-280 / ppo_trainer.py:301-513);
            # stage nets differ in heads, so only matching leaves are merged
            copied, skipped = self._merge_pretrained(self.policy, policy_path)
            self.pretrained_counts = (len(copied), len(skipped))
            logger.info(
                f"loaded pretrained weights from {policy_path}: "
                f"{len(copied)} tensors copied, {len(skipped)} kept fresh"
            )
        self.use_belief_predictor = cfg.RL.PPO.use_belief_predictor
        self.belief_net = None
        if self.use_belief_predictor:
            self.belief_net = BeliefPredictorNet(
                predict_label=bp_cfg.use_label_belief,
                predict_location=bp_cfg.use_location_belief,
                has_distractor_sound=self.env.config.has_distractor,
                generator=gen,
                dtype=dtype,
            ).to(dev).eval()
            if belief_path:
                # offline-pretrained belief predictor (ppo_trainer.py:150-170)
                bcopied, _ = self._merge_pretrained(self.belief_net, belief_path)
                logger.info(f"loaded belief predictor from {belief_path} ({len(bcopied)} tensors)")
        self.optimizer = make_optimizer(self.policy.parameters(), self.ppo_cfg)
        self.belief_optimizer = None
        if self.belief_net is not None and bp_cfg.online_training:
            # optax.adam(lr): no clipping, eps 1e-8
            self.belief_optimizer = torch.optim.Adam(self.belief_net.parameters(), lr=bp_cfg.lr)
        self.sample_generator = torch.Generator(device=dev).manual_seed(self.rank_seed(cfg.SEED))
        # the minibatch permutations (the JAX trainer's PRNGKey(SEED + 1))
        self.ppo_generator = torch.Generator(device="cpu").manual_seed(self.rank_seed(cfg.SEED + 1))
        self.carry = self.reset()
        self._setup_done = True
        self.setup_seconds = time.perf_counter() - t0

    def trained_modules(self):
        return [self.policy, self.belief_net]

    def _merge_pretrained(self, module: torch.nn.Module, path: str):
        """Merge the checkpoint's ``state_dict`` into ``module`` where paths
        and shapes match; returns (copied, skipped) paths."""
        ckpt = self.load_checkpoint(path)
        merged, copied, skipped = merge_matching_params(to_flax_params(module), ckpt["state_dict"])
        load_flax_params(module, merged)
        return copied, skipped

    def reset(self, order=None, consts: Optional[Dict[str, torch.Tensor]] = None) -> SMTCarry:
        """A fresh carry: every env slot at the start of its first episode
        (of ``order``'s streams and ``consts``' tables, when given), empty
        memories and beliefs."""
        b, dev = self.env.num_envs, self.device
        state, obs = self.env.reset(order=order, consts=consts)
        if "category_belief" not in obs:
            obs["category_belief"] = torch.zeros((b, 21), dtype=torch.float32, device=dev)
            obs["location_belief"] = torch.zeros((b, 2), dtype=torch.float32, device=dev)
        return SMTCarry(
            env_state=state,
            obs=obs,
            prev_action=torch.zeros((b,), dtype=torch.long, device=dev),
            masks=torch.zeros((b,), dtype=torch.float32, device=dev),
            memory=init_memory(b, self.memory_size, self.feature_size, device=dev),
            belief=init_belief_state(b, device=dev),
        )

    def collect(self, carry: Optional[SMTCarry] = None, deterministic: bool = False,
                n: Optional[int] = None, consts: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        """One rollout of ``n`` (default RL.PPO.num_steps) env steps from
        ``carry`` (default: the trainer's own, which is then advanced), the
        env's episode tables replaced by ``consts`` and actions sampled from
        ``generator`` when given. Returns (carry, RolloutBatch)."""
        policy, env, belief_net = self.policy, self.env, self.belief_net
        bp_cfg = self.config.RL.PPO.BELIEF_PREDICTOR
        gen = self.sample_generator if generator is None else generator

        def env_step(state, actions):
            return env.step(state, actions, consts=consts)

        def act(obs, pa, mf, mv):
            return policy.act(obs, pa, mf, mv, gen, deterministic)

        def val(obs, pa, mf, mv):
            return policy.get_value(obs, pa, mf, mv)

        belief_fn = None
        if belief_net is not None:
            def belief_fn(state, obs, new_ep):
                return update_beliefs(
                    belief_net, state, obs, new_ep,
                    weighting_factor=bp_cfg.weighting_factor,
                    current_pred_only=bp_cfg.current_pred_only,
                )

        own = carry is None
        carry, batch = collect_rollout_smt(
            env_step, act, val, belief_fn, self.carry if own else carry,
            self.num_steps if n is None else n,
        )
        if own:
            self.carry = carry
        return carry, batch

    def evaluate_actions(self, obs, initial_memory, masks, actions):
        """(values, log_probs, entropy, logits), each (T, Bm, ...), of a
        minibatch's stored steps under the current parameters."""
        smt_cfg = self.config.RL.PPO.SCENE_MEMORY_TRANSFORMER
        # freeze_encoders (savi.yaml): the stored features are the frozen
        # towers' outputs, so re-evaluation skips the towers
        step = self.policy.evaluate_step_frozen if smt_cfg.freeze_encoders else self.policy.evaluate_step
        if smt_cfg.batched_eval:
            return evaluate_sequence_smt_batched(step, obs, initial_memory, masks, actions,
                                                 chunk=smt_cfg.batched_eval_chunk,
                                                 compute_dtype=self.compute_dtype())
        # the sequential ring replay, one step of Bm rows at a time
        return evaluate_sequence_smt(step, obs, initial_memory, masks, actions)

    def update(self, batch: RolloutBatch, perms: Optional[Sequence] = None,
               grad_reduce=identity_grad_reduce) -> Dict[str, torch.Tensor]:
        """GAE, one PPO update and (with online belief training) one belief
        step on ``batch``, in place on the parameters. ``perms`` (one
        permutation of the env slots per epoch) replaces the draws from the
        trainer's PPO generator; ``grad_reduce`` (DD-PPO's gradient average)
        acts before every optimizer step. Returns the averaged losses as
        tensors, with ``belief_loss`` under online belief training. Spans:
        ``update`` and ``update.belief_step`` on the stream's time too,
        ``update.gae``, and those of ``ppo_update``."""
        cfg = self.ppo_cfg
        with span("update", stream=True):
            with span("update.gae"):
                adv, ret = compute_gae(
                    batch.rewards, batch.values, batch.bootstrap_value,
                    1.0 - batch.dones.float(), cfg.gamma, cfg.tau,
                )
            stats = ppo_update(batch, adv, ret, self.evaluate_actions, self.optimizer, cfg,
                               generator=self.ppo_generator, perms=perms, grad_reduce=grad_reduce)
            if self.belief_optimizer is not None:
                with span("update.belief_step", stream=True):
                    stats["belief_loss"] = self.belief_train_step(batch, grad_reduce)
            return stats

    def belief_train_step(self, batch: RolloutBatch, grad_reduce=identity_grad_reduce) -> torch.Tensor:
        """One Adam step of the location regression: the MSE to the goal
        direction over the T·B steps whose spectrogram is not silent
        (train_belief_predictor, ppo_trainer.py:959-1032), its gradients
        through ``grad_reduce``. Returns the loss."""
        t, b = batch.actions.shape
        spec = batch.obs["spectrogram"].reshape((t * b,) + batch.obs["spectrogram"].shape[2:])
        cat = batch.obs.get("category")
        cat = cat.reshape(t * b, -1) if cat is not None else None
        target = self._location_targets(batch).reshape(t * b, 2)
        weights = (spec.abs().sum(dim=(1, 2, 3)) != 0).float()
        loc = self.belief_net.location(spec, cat)
        err = ((loc - target) ** 2).sum(-1) * weights
        loss = err.sum() / torch.clamp(weights.sum(), min=1.0)
        self.belief_optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_reduce(list(self.belief_net.parameters()))
        self.belief_optimizer.step()
        return loss.detach()

    def _location_targets(self, batch: RolloutBatch) -> torch.Tensor:
        """The goal direction in the agent's frame, the location head's
        regression target."""
        obs = batch.obs
        if "pointgoal_with_gps_compass" in obs:
            return obs["pointgoal_with_gps_compass"]
        # training the location head against zeros would silently corrupt
        # the belief predictor: require the sensor when the head trains
        raise ValueError(
            "BELIEF_PREDICTOR.use_location_belief online training requires the "
            "POINTGOAL_WITH_GPS_COMPASS_SENSOR in TASK.SENSORS (no ground-truth "
            "goal direction available for the regression target)"
        )


    # ------------------------------------------------------------------
    def train(self) -> None:
        """NUM_UPDATES rounds of collect + update (ppo_trainer.py:1088-1240):
        resume first (RESUME_CHECKPOINT: the interrupted state, else the
        newest checkpoint; the loop then starts again at update 0, as in the
        JAX trainer), the reward/metric window over finished episodes (every
        rank's), ``Policy/*`` (averaged over ranks) and ``Metrics/*`` scalars
        every LOG_INTERVAL updates, a checkpoint every CHECKPOINT_INTERVAL
        updates and at the last, and the interrupted-state save + requeue on
        a preemption signal. Timings: ``superstep_time`` (collect + update,
        of which ``collect_time`` and ``update_time``, each ending in a device
        synchronise), ``host_time`` and ``checkpoint_time``;
        ``train_seconds`` is the loop's wall time. Under a process group of
        more than one rank, the DD-PPO rules of ``BaseRLTrainer``."""
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
            for update_i in range(cfg.NUM_UPDATES):
                if self.preempted():
                    # interrupted-state save + requeue (ddp_utils.py:70-122,
                    # trainer hook ddppo_trainer.py:846-870)
                    break
                with timings.time("superstep_time"):
                    _, self.carry, batch, stats = superstep(None, self.carry)
                stats = {k: float(v) for k, v in stats.items()}
                self.carry = self._refresh_episode_stream(self.carry)

                with timings.time("host_time"):
                    self.num_steps_done += window.add(self.window_view(batch))
                self.num_updates_done += 1

                if update_i % cfg.LOG_INTERVAL == 0:
                    fps = self.num_steps_done / max(time.time() - t_start, 1e-6)
                    logger.info(f"savi update {update_i} fps {fps:.1f} frames {self.num_steps_done} "
                                + timings.summary())
                    means = window.means()
                    if means:
                        logger.info("window reward {:.3f} success {:.3f} spl {:.3f}".format(
                            means.get("reward", 0), means.get("success", 0), means.get("spl", 0)))
                        for k, v in means.items():
                            writer.add_scalar(f"Metrics/{k}", v, self.num_steps_done)
                    for k, v in stats.items():
                        writer.add_scalar(f"Policy/{k}", v, self.num_steps_done)

                # every CHECKPOINT_INTERVAL updates (ddppo_trainer.py:1191)
                if (update_i + 1) % cfg.CHECKPOINT_INTERVAL == 0 or update_i + 1 == cfg.NUM_UPDATES:
                    with timings.time("checkpoint_time"):
                        self.checkpoint(f"ckpt.{ckpt_count}.pth")
                    ckpt_count += 1
        self.train_seconds = time.time() - t_start

    def restore(self, ckpt: Dict[str, Any]) -> None:
        """Parameters, both optimizers (Adam moments and steps, the PPO
        optimizer's step count that the LR decay reads) and
        ``num_steps_done`` from a checkpoint this trainer wrote."""
        load_flax_params(self.policy, ckpt["state_dict"])
        if "belief_predictor" in ckpt and self.belief_net is not None:
            load_flax_params(self.belief_net, ckpt["belief_predictor"])
        if "optim_state" in ckpt:
            load_adam_flax(self.policy, self.optimizer.adam, ckpt["optim_state"]["adam"])
            self.optimizer.count = int(ckpt["optim_state"]["count"])
        if "belief_optim_state" in ckpt and self.belief_optimizer is not None:
            load_adam_flax(self.belief_net, self.belief_optimizer, ckpt["belief_optim_state"]["adam"])
        self.num_steps_done = int(ckpt.get("extra_state", {}).get("step", 0))

    def _checkpoint_payload(self) -> Dict[str, Any]:
        """The parameters as Flax trees (``state_dict``, ``belief_predictor``:
        the JAX package reads them), the optimizers' own states keyed by the
        same Flax paths, the config and ``extra_state``."""
        payload = {
            "state_dict": to_flax_params(self.policy),
            "optim_state": {"count": self.optimizer.count, "adam": adam_to_flax(self.policy, self.optimizer.adam)},
            "config": self.config.to_dict(),
            "extra_state": {"step": self.num_steps_done},
        }
        if self.belief_net is not None:
            payload["belief_predictor"] = to_flax_params(self.belief_net)
        if self.belief_optimizer is not None:
            payload["belief_optim_state"] = {"adam": adam_to_flax(self.belief_net, self.belief_optimizer)}
        return payload

    def save_checkpoint(self, name: str) -> str:
        return save_checkpoint(self.config.CHECKPOINT_FOLDER, name, self._checkpoint_payload())

    # ------------------------------------------------------------------
    def _eval_checkpoint(self, checkpoint_path: str, writer, checkpoint_index: int = 0) -> Dict[str, float]:
        """The exactly-once eval of one checkpoint (ppo_trainer.py:1806-2046):
        the env and networks rebuilt under the checkpoint's config, its
        parameters loaded, every slot dealt its share of the episodes
        (``exact_once_deal``) under the SOUND_TYPE's sound remap
        (``eval_consts``), sampled actions as in the reference eval
        (ppo_trainer.py:1960), each episode id counted once until
        TEST_EPISODE_COUNT; the means go to ``val/*`` with
        ``episodes_evaluated``; with VIDEO_OPTION, up to 2 (or 3) episode
        videos from the rollouts that end them (``eval_videos``)."""
        ckpt = self.load_checkpoint(checkpoint_path)
        self.reconfigure_from_checkpoint(ckpt)
        load_flax_params(self.policy, ckpt["state_dict"])
        if "belief_predictor" in ckpt and self.belief_net is not None:
            load_flax_params(self.belief_net, ckpt["belief_predictor"])

        num_episodes = int(self.env.eps["scene"].shape[0])
        count = min(self.config.TEST_EPISODE_COUNT, num_episodes)
        b = self.env.num_envs
        consts = self.env.eval_consts(self.config.SOUND_TYPE)
        carry = self.reset(order=exact_once_deal(num_episodes, b), consts=consts)
        gen = torch.Generator(device=self.device).manual_seed(self.config.SEED + 11)

        def collect():
            nonlocal carry
            carry, batch = self.collect(carry, deterministic=False, consts=consts, generator=gen)
            return batch

        max_rollouts = self.eval_rollout_budget(num_episodes, b, self.env.config.max_episode_steps)
        stats, self._last_eval_episode_ids = eval_pass(
            collect, count, max_rollouts, self.eval_videos(writer, checkpoint_index))
        means = {k: float(np.mean(v)) for k, v in stats.items()}
        means.update(eval_episode_accounting(self._last_eval_episode_ids, count, "savi"))
        logger.info(f"savi eval ckpt {checkpoint_index}: " + ", ".join(f"{k}={v:.3f}" for k, v in means.items()))
        for k, v in means.items():
            writer.add_scalar(f"val/{k}", v, checkpoint_index)
        return means


def pretrained_paths(cfg):
    """(policy path, belief path) that ``_setup`` loads, "" where none,
    chosen as the JAX trainer chooses them: ``DDPPO.pretrained_weights``
    when DDPPO.pretrained is on, else the SMT ``pretrained_path`` under
    use_pretrained; the belief predictor's ``pretrained_path`` only under
    use_belief_predictor."""
    smt_cfg = cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER
    policy = ""
    if cfg.RL.DDPPO.pretrained and cfg.RL.DDPPO.pretrained_weights:
        policy = cfg.RL.DDPPO.pretrained_weights
    elif smt_cfg.use_pretrained and smt_cfg.pretrained_path:
        policy = smt_cfg.pretrained_path
    belief = cfg.RL.PPO.BELIEF_PREDICTOR.pretrained_path if cfg.RL.PPO.use_belief_predictor else ""
    return policy, belief
