"""SAVi trainer: SMT policy + belief predictor PPO.

PyTorch counterpart of ``SaviTrainer`` in ``avlen_tpu/rl/trainers/savi.py``
(reference ppo_trainer.py:93-1311, plain SAVi path): ``_setup`` builds the
batched env, the networks and the optimizers from the config; ``collect``
runs a rollout in which the memory-150 SMT policy acts step by step, with
the belief predictor filling the category/location beliefs before each act;
``update`` runs GAE, the PPO update with batched ring re-evaluation, and the
belief predictor's online location regression (ppo_trainer.py:959-1032) on
that rollout. Checkpoints, ``train()`` and ``eval()`` are the next slice of
the port.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Union

import torch

from avlen_tpu_torch.models.belief_predictor import (
    BeliefPredictorNet,
    init_belief_state,
    update_beliefs,
)
from avlen_tpu_torch.models.memory import init_memory
from avlen_tpu_torch.models.smt_policy import AudioNavSMTNet, SMTPolicy
from avlen_tpu_torch.rl.gae import compute_gae
from avlen_tpu_torch.rl.ppo import make_optimizer, ppo_config_from, ppo_update
from avlen_tpu_torch.rl.rollout import RolloutBatch
from avlen_tpu_torch.rl.rollout_smt import SMTCarry, collect_rollout_smt, evaluate_sequence_smt_batched
from avlen_tpu_torch.sim.builder import construct_batched_env


class SaviTrainer:
    def __init__(self, config, device: Union[str, torch.device] = "cuda"):
        self.config = config
        self.device = torch.device(device)

    def _setup(self, num_envs: Optional[int] = None):
        cfg = self.config
        dev = self.device
        if cfg.TPU.PRECISION != "float32":
            raise NotImplementedError(
                f"TPU.PRECISION {cfg.TPU.PRECISION!r}: the PyTorch port computes in float32 only so far"
            )
        self.ppo_cfg = ppo_config_from(cfg)
        self.num_steps = cfg.RL.PPO.num_steps
        smt_cfg = cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER
        bp_cfg = cfg.RL.PPO.BELIEF_PREDICTOR
        if not smt_cfg.batched_eval:
            raise NotImplementedError(
                "SCENE_MEMORY_TRANSFORMER.batched_eval False: the PyTorch port re-evaluates "
                "the ring batched only (the same outputs as the sequential replay)"
            )
        for path in pretrained_paths(cfg):
            if not os.path.exists(path):
                raise FileNotFoundError(f"configured pretrained weights not found: {path}")
            raise NotImplementedError("checkpoint loading is the next slice of the PyTorch port")

        self.env = construct_batched_env(
            cfg, num_envs=num_envs, with_depth=True, with_rgb=True,
            extra_sensors=("category_belief", "location_belief", "category"), device=dev,
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
            ),
            generator=gen,
        ).to(dev).eval()
        self.feature_size = self.policy.net.feature_size
        self.use_belief_predictor = cfg.RL.PPO.use_belief_predictor
        self.belief_net = None
        if self.use_belief_predictor:
            self.belief_net = BeliefPredictorNet(
                predict_label=bp_cfg.use_label_belief,
                predict_location=bp_cfg.use_location_belief,
                has_distractor_sound=self.env.config.has_distractor,
                generator=gen,
            ).to(dev).eval()
        self.optimizer = make_optimizer(self.policy.parameters(), self.ppo_cfg)
        self.belief_optimizer = None
        if self.belief_net is not None and bp_cfg.online_training:
            # optax.adam(lr): no clipping, eps 1e-8
            self.belief_optimizer = torch.optim.Adam(self.belief_net.parameters(), lr=bp_cfg.lr)
        self.sample_generator = torch.Generator(device=dev).manual_seed(cfg.SEED)
        # the minibatch permutations (the JAX trainer's PRNGKey(SEED + 1))
        self.ppo_generator = torch.Generator(device="cpu").manual_seed(cfg.SEED + 1)
        self.carry = self.reset()

    def reset(self) -> SMTCarry:
        """A fresh carry: every env slot at the start of its first episode,
        empty memories and beliefs."""
        b, dev = self.env.num_envs, self.device
        state, obs = self.env.reset()
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
                n: Optional[int] = None):
        """One rollout of ``n`` (default RL.PPO.num_steps) env steps from
        ``carry`` (default: the trainer's own, which is then advanced).
        Returns (carry, RolloutBatch)."""
        policy, env, belief_net = self.policy, self.env, self.belief_net
        bp_cfg = self.config.RL.PPO.BELIEF_PREDICTOR
        gen = self.sample_generator

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
            env.step, act, val, belief_fn, self.carry if own else carry,
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
        return evaluate_sequence_smt_batched(step, obs, initial_memory, masks, actions,
                                             chunk=smt_cfg.batched_eval_chunk)

    def update(self, batch: RolloutBatch, perms: Optional[Sequence] = None) -> Dict[str, torch.Tensor]:
        """GAE, one PPO update and (with online belief training) one belief
        step on ``batch``, in place on the parameters. ``perms`` (one
        permutation of the env slots per epoch) replaces the draws from the
        trainer's PPO generator. Returns the averaged losses as tensors, with
        ``belief_loss`` under online belief training."""
        cfg = self.ppo_cfg
        adv, ret = compute_gae(
            batch.rewards, batch.values, batch.bootstrap_value,
            1.0 - batch.dones.float(), cfg.gamma, cfg.tau,
        )
        stats = ppo_update(batch, adv, ret, self.evaluate_actions, self.optimizer, cfg,
                           generator=self.ppo_generator, perms=perms)
        if self.belief_optimizer is not None:
            stats["belief_loss"] = self.belief_train_step(batch)
        return stats

    def belief_train_step(self, batch: RolloutBatch) -> torch.Tensor:
        """One Adam step of the location regression: the MSE to the goal
        direction over the T·B steps whose spectrogram is not silent
        (train_belief_predictor, ppo_trainer.py:959-1032). Returns the loss."""
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


def pretrained_paths(cfg) -> List[str]:
    """The pretrained weights ``_setup`` loads, chosen as the JAX trainer
    chooses them: ``DDPPO.pretrained_weights`` when DDPPO.pretrained is on,
    else the SMT ``pretrained_path`` under use_pretrained; and the belief
    predictor's ``pretrained_path`` only under use_belief_predictor."""
    smt_cfg = cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER
    paths = []
    if cfg.RL.DDPPO.pretrained and cfg.RL.DDPPO.pretrained_weights:
        paths.append(cfg.RL.DDPPO.pretrained_weights)
    elif smt_cfg.use_pretrained and smt_cfg.pretrained_path:
        paths.append(smt_cfg.pretrained_path)
    if cfg.RL.PPO.use_belief_predictor and cfg.RL.PPO.BELIEF_PREDICTOR.pretrained_path:
        paths.append(cfg.RL.PPO.BELIEF_PREDICTOR.pretrained_path)
    return paths
