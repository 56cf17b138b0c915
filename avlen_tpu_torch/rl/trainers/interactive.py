"""AVLEN interactive trainer (registered "ddppo").

PyTorch counterpart of ``InteractiveDDPPOTrainer`` in
``avlen_tpu/rl/trainers/interactive.py`` (reference DDPPOTrainer,
ss_baselines/savi/ddppo/algo/ddppo_trainer.py:62-1200):

* ``"ddppo"`` is ``ddppo_trainer``: for ``policy_type`` rnn/smt without
  DIALOG_TRAINING it returns the port's ``SaviTrainer``
  (ddppo_trainer.py:92-180), so ``run.py`` with TRAINER_NAME ddppo trains
  the SAVi configs; otherwise an ``InteractiveDDPPOTrainer``;
* ``InteractiveDDPPOTrainer`` builds full AVLEN: π_g (``SMTPolicy``, from
  GOAL_CKPT_PATH), π_l (``DialogPolicy`` with the CLIP text tower, from
  VLN_CKPT_PATH), π_q (``OptionPolicy``), the belief predictor (from its
  ``pretrained_path``) and the oracle-instruction bank or host speaker.
  ``policy_type: interactive`` trains π_q: ``collect`` (the interactive
  rollout, ``rl/rollout_interactive.py``), then ``update`` (GAE and
  ``ppo_update_interactive``, and with REPLAY_STORE π_l's replay CE,
  ``rl/ppo_interactive.py``), looped by ``train`` with resume, checkpoints
  of all three policies and both optimizers, and preemption; eval runs the
  configured query strategy over the eval split exactly once.
  ``policy_type: dialog`` (or DIALOG_TRAINING) pretrains π_l:
  ``collect_dialog`` (oracle-driven windows) and ``update_dialog`` (the
  class-weighted CE over every step), checkpoints under ``vln/``, and an
  eval of π_l's accuracy and CE against the oracle.

Both train loops run data-parallel over the ranks of a process group
(``parallel/ddppo.py``), π_q's and π_l's gradients each averaged before
their optimizer's step, as the JAX trainer's mesh branch does. Its chunked
host-prefetch collect is a workaround for backends without host callbacks: the eager rollout reads host-served RIRs
and calls the host speaker directly, which also serves SPEAKER.BANK_MODE
cached where JAX allows it. ``TPU.PRECISION`` is the towers' compute dtype
(``compute_dtype``) in all three policies and the belief predictor.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from avlen_tpu_torch.core.registry import registry
from avlen_tpu_torch.dialog.instruction_source import (
    has_host_prefetcher,
    resolve_instruction_source,
    sub_instr_token_bank,
)
from avlen_tpu_torch.models.belief_predictor import BeliefPredictorNet, init_belief_state, update_beliefs
from avlen_tpu_torch.models.dialog_policy import AudioNavDialogNet, DialogPolicy
from avlen_tpu_torch.models.memory import init_memory
from avlen_tpu_torch.models.option_policy import AudioNavOptionNet, OptionPolicy
from avlen_tpu_torch.models.smt_policy import AudioNavSMTNet, SMTPolicy
from avlen_tpu_torch.parallel import ddppo
from avlen_tpu_torch.rl.gae import compute_gae
from avlen_tpu_torch.rl.ppo import identity_grad_reduce, make_optimizer, ppo_config_from
from avlen_tpu_torch.rl.ppo_interactive import dialog_supervised_update, ppo_update_interactive
from avlen_tpu_torch.rl.rollout_interactive import (
    InteractiveCarry,
    InteractiveConfig,
    InteractiveFns,
    collect_rollout_dialog_pretrain,
    collect_rollout_interactive,
    init_query_track,
    sinusoidal_pe,
)
from avlen_tpu_torch.rl.trainers.base import (
    METRIC_BLACKLIST,
    BaseRLTrainer,
    eval_episode_accounting,
    exact_once_deal,
)
from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
from avlen_tpu_torch.sim.builder import construct_batched_env
from avlen_tpu_torch.utils import preemption, profiling
from avlen_tpu_torch.utils.checkpoint import save_checkpoint
from avlen_tpu_torch.utils.flax_bridge import (adam_to_flax, flax_path, load_adam_flax, load_flax_params,
                                                to_flax_params)
from avlen_tpu_torch.utils.logging import logger
from avlen_tpu_torch.utils.profiling import Timings
from avlen_tpu_torch.utils.tb import TensorboardWriter


@registry.register_trainer(name="ddppo")
def ddppo_trainer(config, device: Union[str, torch.device] = "cuda") -> BaseRLTrainer:
    """TRAINER_NAME ddppo: plain (non-dialog) training of the rnn/smt policy
    types is the SAVi trainer's (ddppo_trainer.py:92-180), the rest AVLEN's."""
    if config.RL.PPO.policy_type in ("rnn", "smt") and not config.DIALOG_TRAINING:
        return SaviTrainer(config, device)
    return InteractiveDDPPOTrainer(config, device)


class InteractiveDDPPOTrainer(BaseRLTrainer):
    def _setup(self, num_envs: Optional[int] = None):
        """Env, instruction source, the three policies and the belief
        predictor (pretrained weights loaded where their paths exist), the
        optimizers and the first carry. ``setup_seconds`` is its wall time,
        ``bank_seconds`` and ``bank_bytes`` the instruction bank's build
        time and size (0 with the host speaker)."""
        t0 = time.perf_counter()
        cfg = self.config
        dev = self.device
        dtype = self.compute_dtype()
        self.ppo_cfg = ppo_config_from(cfg)
        self.num_steps = cfg.RL.PPO.num_steps
        self.policy_type = cfg.RL.PPO.policy_type
        self.dialog_mode = is_dialog_mode(cfg)
        smt_cfg = cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER
        bp_cfg = cfg.RL.PPO.BELIEF_PREDICTOR

        self.env = construct_batched_env(
            cfg, num_envs=num_envs, with_depth=True, with_rgb=True,
            extra_sensors=("category_belief", "location_belief", "category"), device=dev,
            slots=self.env_slots(num_envs or cfg.NUM_PROCESSES),
        )

        # oracle instructions: the token bank (built on the host, moved to
        # the card once) or the host speaker per query
        t_bank = time.perf_counter()
        bank, self.instr_source = resolve_instruction_source(
            cfg, self.env.scene_tables,
            rgb_bank=self.env.bank.rgb if cfg.SPEAKER.USE_PANO_FEATURES else None, device=dev,
            allow_cached=has_host_prefetcher(cfg, self.env))
        self.instr_bank = torch.as_tensor(bank, device=dev) if bank is not None else None
        self.bank_seconds = time.perf_counter() - t_bank if bank is not None else 0.0
        self.bank_bytes = int(bank.nbytes) if bank is not None else 0
        self.pe_table = torch.as_tensor(sinusoidal_pe(151, cfg.QUERY_COUNT_EMB_SIZE), device=dev)
        sub_bank = sub_instr_token_bank(getattr(self.env, "episodes", []))
        self.sub_instr_bank = torch.as_tensor(sub_bank, device=dev) if sub_bank is not None else None

        common = dict(
            spectrogram_hw=self.env.spec_config.out_shape[:2],
            num_actions=len(cfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS),
            d_model=smt_cfg.hidden_size,
            nhead=smt_cfg.nhead,
            use_rgb="rgb" in self.env.config.sensors,
            use_depth="depth" in self.env.config.sensors,
            use_label_belief=bp_cfg.use_label_belief,
            use_location_belief=bp_cfg.use_location_belief,
            pretraining=smt_cfg.pretraining,
            dtype=dtype,
        )

        def gen(offset: int) -> torch.Generator:
            # parameters are drawn on the CPU, one generator a network (the
            # JAX trainer's key and fold_in(key, 1..3)), then moved
            return torch.Generator(device="cpu").manual_seed(cfg.SEED + offset)

        g = gen(0)
        self.goal_policy = SMTPolicy(AudioNavSMTNet(use_belief_as_goal=True, generator=g, **common),
                                     generator=g).to(dev).eval()
        g = gen(1)
        self.dialog_policy = DialogPolicy(
            AudioNavDialogNet(clip_width=cfg.RL.PPO.CLIP_WIDTH, clip_layers=cfg.RL.PPO.CLIP_LAYERS,
                              generator=g, **common), generator=g).to(dev).eval()
        g = gen(2)
        self.option_policy = OptionPolicy(
            AudioNavOptionNet(query_count_emb_size=cfg.QUERY_COUNT_EMB_SIZE, generator=g, **common),
            generator=g).to(dev).eval()
        self.memory_size = smt_cfg.memory_size
        self.feat_goal_size = self.goal_policy.net.feature_size
        self.feat_option_size = self.option_policy.net.feature_size

        # pretrained towers, each replaced whole where its path exists
        # (ddppo_trainer.py:244-280, 301-513)
        self.loaded = {}
        for key, path, module in (("goal", cfg.GOAL_CKPT_PATH, self.goal_policy),
                                  ("dialog", cfg.VLN_CKPT_PATH, self.dialog_policy)):
            if path and os.path.exists(path):
                load_flax_params(module, self.load_checkpoint(path)["state_dict"])
                self.loaded[key] = path
                logger.info(f"loaded {key} policy from {path}")

        self.use_belief_predictor = cfg.RL.PPO.use_belief_predictor
        self.belief_net = None
        if self.use_belief_predictor:
            self.belief_net = BeliefPredictorNet(
                predict_label=bp_cfg.use_label_belief,
                predict_location=bp_cfg.use_location_belief,
                has_distractor_sound=self.env.config.has_distractor,
                generator=gen(3),
                dtype=dtype,
            ).to(dev).eval()
            if bp_cfg.pretrained_path and os.path.exists(bp_cfg.pretrained_path):
                load_flax_params(self.belief_net, self.load_checkpoint(bp_cfg.pretrained_path)["state_dict"])
                self.loaded["belief"] = bp_cfg.pretrained_path
                logger.info(f"loaded belief predictor from {bp_cfg.pretrained_path}")

        # π_q's PPO Adam; π_l's Adam at lr 1e-5 (ppo.py:62-63)
        self.optimizer_q = make_optimizer(self.option_policy.parameters(), self.ppo_cfg)
        self.optimizer_l = torch.optim.Adam(self.dialog_policy.parameters(), lr=1e-5, eps=self.ppo_cfg.eps)

        self.interactive_cfg = InteractiveConfig(
            num_dialog_steps=cfg.NUM_DIALOG_STEPS,
            num_total_query=cfg.RL.NUM_TOTAL_QUERY,
            consecutive_reward=cfg.RL.CONSECUTIVE_REWARD,
            query_within_radius=cfg.QUERY_WITHIN_RADIUS,
            oracle_when_queried=cfg.ORACLE_WHEN_QUERIED,
            allow_stop=cfg.ALLOW_STOP,
            with_distance_constraint=cfg.RL.WITH_DISTANCE_CONSTRAINT,
            distance_distribution_type=cfg.RL.DISTANCE_DISTRIBUTION_TYPE,
            dist_mean=cfg.RL.MEAN,
            dist_sd=cfg.RL.SD,
            dist_alpha=cfg.RL.ALPHA,
            dist_beta=cfg.RL.BETA,
        )
        self.sample_generator = torch.Generator(device=dev).manual_seed(self.rank_seed(cfg.SEED))
        # π_q's minibatch permutations (the JAX trainer's key(SEED + 1))
        self.ppo_generator = torch.Generator(device="cpu").manual_seed(self.rank_seed(cfg.SEED + 1))
        self.clip_calls = 0  # frozen CLIP tower runs in collects
        self.carry = self.reset()
        self._setup_done = True
        self.setup_seconds = time.perf_counter() - t0

    def trained_modules(self):
        return [self.goal_policy, self.dialog_policy, self.option_policy, self.belief_net]

    def reset(self, order=None, consts: Optional[Dict[str, torch.Tensor]] = None) -> InteractiveCarry:
        """A fresh carry: every env slot at the start of its first episode
        (of ``order``'s streams and ``consts``' tables, when given), empty
        memories, beliefs and query track."""
        cfg, b, dev = self.config, self.env.num_envs, self.device
        state, obs = self.env.reset(order=order, consts=consts)
        if "category_belief" not in obs:
            obs["category_belief"] = torch.zeros((b, 21), dtype=torch.float32, device=dev)
            obs["location_belief"] = torch.zeros((b, 2), dtype=torch.float32, device=dev)
        d_model = cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size
        return InteractiveCarry(
            env_state=state,
            obs=obs,
            prev_action=torch.zeros((b,), dtype=torch.long, device=dev),
            masks=torch.zeros((b,), dtype=torch.float32, device=dev),
            masks_vln=torch.zeros((b,), dtype=torch.float32, device=dev),
            mem_goal=init_memory(b, self.memory_size, self.feat_goal_size, device=dev),
            mem_option=init_memory(b, self.memory_size, self.feat_option_size, device=dev),
            mem_vln=init_memory(b, cfg.NUM_DIALOG_STEPS, self.feat_goal_size, device=dev),
            mem_vln_dialog=init_memory(b, cfg.NUM_DIALOG_STEPS, d_model, device=dev),
            belief=init_belief_state(b, device=dev),
            # the width of CLIP's text projection (embed_dim 512), not RL.PPO.CLIP_WIDTH
            track=init_query_track(b, clip_width=self.dialog_policy.net.clip.embed_dim, device=dev),
        )

    # ------------------------------------------------------------------
    def make_fns(self, deterministic: bool = False, generator: Optional[torch.Generator] = None,
                 consts: Optional[Dict[str, torch.Tensor]] = None) -> InteractiveFns:
        """The rollout's callables over the current parameters, the env's
        episode tables replaced by ``consts`` when given. As in the
        reference's eval protocol, π_g and π_q always sample (from
        ``generator``, default the trainer's); ``deterministic`` takes π_l's
        argmax (ppo_trainer.py:1917, 1940, 1960)."""
        goal_p, dialog_p, option_p = self.goal_policy, self.dialog_policy, self.option_policy
        gen = self.sample_generator if generator is None else generator
        bp_cfg = self.config.RL.PPO.BELIEF_PREDICTOR
        env = self.env

        def act_option(obs, pa, mf, mv, qs, lqi):
            return option_p.act(obs, pa, mf, mv, qs, lqi, gen, False)

        def act_goal(obs, pa, mf, mv):
            return goal_p.act(obs, pa, mf, mv, gen, False)

        def act_dialog(obs, pa, mf, mv, smf, smv, dialog, step, dclip=None):
            return dialog_p.act(obs, pa, mf, mv, smf, smv, dialog, step, gen, deterministic, dialog_clip=dclip)

        def clip_embed(tokens):
            self.clip_calls += 1
            profiling.count("clip.rows", tokens.shape[0])
            return dialog_p.clip_embed(tokens)

        def value_option(obs, pa, mf, mv, qs, lqi):
            return option_p.act(obs, pa, mf, mv, qs, lqi, deterministic=True)[2]

        belief_fn = None
        if self.belief_net is not None:
            belief_net = self.belief_net

            def belief_fn(state, obs, new_ep):
                return update_beliefs(belief_net, state, obs, new_ep, weighting_factor=bp_cfg.weighting_factor,
                                      current_pred_only=bp_cfg.current_pred_only)

        return InteractiveFns(
            act_option=act_option,
            act_goal=act_goal,
            act_dialog=act_dialog,
            value_option=value_option,
            oracle_action=env.oracle_action,
            env_step=lambda state, actions, query: env.step(state, actions, query, consts=consts),
            belief_fn=belief_fn,
            clip_embed=clip_embed,
        )

    def collect(self, carry: Optional[InteractiveCarry] = None, deterministic: bool = False,
                n: Optional[int] = None, generator: Optional[torch.Generator] = None,
                consts: Optional[Dict[str, torch.Tensor]] = None):
        """One interactive rollout of ``n`` (default RL.PPO.num_steps) steps
        from ``carry`` (default: the trainer's own, which is then advanced),
        the env's episode tables replaced by ``consts`` when given.
        ``deterministic`` is eval mode: the query strategy of QS_METHOD with
        LIMIT_QUERY / HOW_MANY_QUERY / ENFORCED_GAP (ppo_trainer.py:
        1333-1356) and π_l's argmax. Returns (carry, traj)."""
        self.ensure_setup()
        cfg = self.config
        icfg = self.interactive_cfg
        if deterministic:
            icfg = dataclasses.replace(icfg, qs_method=cfg.QS_METHOD, limit_query=cfg.LIMIT_QUERY,
                                       how_many_query=cfg.HOW_MANY_QUERY, enforced_gap=cfg.ENFORCED_GAP)
        instr = self.instr_source if self.instr_source is not None else self.instr_bank
        own = carry is None
        carry, traj = collect_rollout_interactive(
            self.make_fns(deterministic, generator, consts), self.carry if own else carry, instr, self.pe_table,
            icfg, self.num_steps if n is None else n,
            generator=self.sample_generator if generator is None else generator,
        )
        if own:
            self.carry = carry
        return carry, traj

    def collect_dialog(self, carry: Optional[InteractiveCarry] = None, n: Optional[int] = None,
                       generator: Optional[torch.Generator] = None,
                       consts: Optional[Dict[str, torch.Tensor]] = None):
        """One π_l pretraining rollout of ``n`` (default RL.PPO.num_steps)
        oracle-driven steps from ``carry`` (default: the trainer's own, which
        is then advanced). Returns (carry, traj)."""
        self.ensure_setup()
        fns = self.make_fns(False, generator, consts)
        env = self.env
        instr = self.instr_source if self.instr_source is not None else self.instr_bank
        own = carry is None
        carry, traj = collect_rollout_dialog_pretrain(
            fns.act_dialog, lambda state, actions: env.step(state, actions, None, consts=consts),
            env.oracle_action, fns.belief_fn, self.carry if own else carry, instr, self.config.NUM_DIALOG_STEPS,
            self.num_steps if n is None else n, sub_instr_bank=self.sub_instr_bank, clip_embed=fns.clip_embed,
        )
        if own:
            self.carry = carry
        return carry, traj

    def _eval_chunk(self) -> int:
        """The batched re-evaluation's chunk, 0 for the sequential replay."""
        smt_cfg = self.config.RL.PPO.SCENE_MEMORY_TRANSFORMER
        return smt_cfg.batched_eval_chunk if smt_cfg.batched_eval else 0

    def update(self, traj: Dict, perms: Optional[Sequence] = None,
               grad_reduce=identity_grad_reduce) -> Dict[str, torch.Tensor]:
        """GAE and π_q's PPO update on an interactive trajectory, then with
        REPLAY_STORE one step of π_l's CE on its queried steps
        (ddppo_trainer.py:907-944), in place on the parameters. ``perms`` (one
        permutation of the env slots per epoch) replaces the draws from the
        trainer's PPO generator; ``grad_reduce`` acts before every step of
        either optimizer. Returns the averaged losses as tensors, with
        ``dialog_loss`` when π_l was updated."""
        cfg = self.ppo_cfg
        adv, ret = compute_gae(traj["rewards"], traj["values_option"], traj["bootstrap_value"],
                               1.0 - traj["dones"].float(), cfg.gamma, cfg.tau)
        stats = ppo_update_interactive(
            self.option_policy.evaluate_step, self.optimizer_q, traj, adv, ret, cfg,
            unct_coef=self.config.RL.PPO.unct_coef, generator=self.ppo_generator, perms=perms,
            batched_chunk=self._eval_chunk(), compute_dtype=self.compute_dtype(), grad_reduce=grad_reduce)
        if self.config.REPLAY_STORE:
            stats["dialog_loss"] = self.update_dialog(traj, replay_only=True, grad_reduce=grad_reduce)["dialog_loss"]
        return stats

    def update_dialog(self, traj: Dict, replay_only: bool = False,
                      grad_reduce=identity_grad_reduce) -> Dict[str, torch.Tensor]:
        """One step of π_l's class-weighted CE: over every oracle step of a
        dialog-pretraining trajectory, or (``replay_only``) over the queried
        steps of an interactive one, its gradients through ``grad_reduce``.
        Returns ``{"dialog_loss": loss}``."""
        loss = dialog_supervised_update(self.dialog_policy.evaluate_step, self.optimizer_l, traj,
                                        replay_only=replay_only, batched_chunk=self._eval_chunk(),
                                        compute_dtype=self.compute_dtype(), grad_reduce=grad_reduce)
        return {"dialog_loss": loss}

    # ------------------------------------------------------------------
    def train(self) -> None:
        """π_l pretraining under a dialog config, else π_q's training."""
        if not self.begin_train():
            return
        if self.dialog_mode:
            self._train_dialog()
        else:
            self._train_interactive()

    def _train_interactive(self) -> None:
        """NUM_UPDATES rounds of collect + update (ddppo_trainer.py:
        515-1200): resume first (RESUME_CHECKPOINT: π_q, π_g, π_l and both
        optimizers from the interrupted state, else the newest checkpoint),
        the reward/metric window over finished episodes, ``Metrics/*``,
        ``Debug/*`` (query statistics) and ``Policy/*`` scalars every
        LOG_INTERVAL updates, a checkpoint every CHECKPOINT_INTERVAL updates
        and at the last, and the interrupted-state save + requeue on a
        preemption signal. Timings as the SAVi trainer's."""
        cfg = self.config
        os.makedirs(cfg.CHECKPOINT_FOLDER, exist_ok=True)
        os.makedirs(cfg.TENSORBOARD_DIR, exist_ok=True)
        window = collections.deque(maxlen=cfg.RL.PPO.reward_window_size)
        reward_acc = np.zeros((cfg.NUM_PROCESSES if self.mesh else self.env.num_envs,), np.float64)
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

        def update(_, traj, key, grad_reduce):
            return None, self.update(traj, grad_reduce=grad_reduce)

        superstep = self.superstep(collect, update, timings)
        with TensorboardWriter(self.tensorboard_dir()) as writer:
            for update_i in range(cfg.NUM_UPDATES):
                if self.preempted():
                    break
                with timings.time("superstep_time"):
                    _, self.carry, traj, stats = superstep(None, self.carry)
                stats = {k: float(v) for k, v in stats.items()}
                self.carry = self._refresh_episode_stream(self.carry)

                with timings.time("host_time"):
                    logged = self.global_view({k: traj[k] for k in ("rewards", "dones", "query_count", "metrics")},
                                              traj["rewards"].shape[0])
                    rewards = logged["rewards"].cpu().numpy()
                    dones = logged["dones"].cpu().numpy()
                    qcount = logged["query_count"].cpu().numpy()
                    metrics = {k: v.cpu().numpy() for k, v in logged["metrics"].items() if k not in METRIC_BLACKLIST}
                    for t_i in range(rewards.shape[0]):
                        reward_acc += rewards[t_i]
                        for b_i in np.nonzero(dones[t_i])[0]:
                            window.append({"reward": reward_acc[b_i], "query_count": qcount[t_i, b_i],
                                           **{k: metrics[k][t_i, b_i] for k in metrics}})
                            reward_acc[b_i] = 0.0
                self.num_steps_done += rewards.size
                self.num_updates_done += 1

                if update_i % cfg.LOG_INTERVAL == 0:
                    fps = self.num_steps_done / max(time.time() - t_start, 1e-6)
                    logger.info(f"interactive update {update_i} fps {fps:.1f} frames {self.num_steps_done} "
                                + timings.summary())
                    if window:
                        means = {k: float(np.mean([w[k] for w in window])) for k in window[0]}
                        logger.info("window reward {:.3f} success {:.3f} spl {:.3f} queries {:.2f}".format(
                            means.get("reward", 0), means.get("success", 0), means.get("spl", 0),
                            means.get("query_count", 0)))
                        for k, v in means.items():
                            writer.add_scalar(f"{'Debug' if 'query' in k else 'Metrics'}/{k}", v,
                                              self.num_steps_done)
                    for k, v in stats.items():
                        writer.add_scalar(f"Policy/{k}", v, self.num_steps_done)

                # every CHECKPOINT_INTERVAL updates (ddppo_trainer.py:1191)
                if (update_i + 1) % cfg.CHECKPOINT_INTERVAL == 0 or update_i + 1 == cfg.NUM_UPDATES:
                    with timings.time("checkpoint_time"):
                        self.checkpoint(f"ckpt.{ckpt_count}.pth")
                    ckpt_count += 1
        self.train_seconds = time.time() - t_start

    def _train_dialog(self) -> None:
        """NUM_UPDATES_DIALOG rounds of ``collect_dialog`` + ``update_dialog``
        (the rollouts sample π_l from a generator seeded SEED + 2, the JAX
        trainer's key), ``Policy/dialog_loss`` every LOG_INTERVAL updates and
        ``CHECKPOINT_FOLDER/vln/ckpt.N.pth`` (π_l's parameters and the
        config) every CHECKPOINT_INTERVAL_DIALOG updates and at the last.
        ``dialog_losses`` holds every update's loss (averaged over ranks)."""
        cfg = self.config
        os.makedirs(cfg.CHECKPOINT_FOLDER, exist_ok=True)
        os.makedirs(cfg.TENSORBOARD_DIR, exist_ok=True)
        t_start = time.time()
        ckpt_count = 0
        gen = torch.Generator(device=self.device).manual_seed(self.rank_seed(cfg.SEED + 2))
        self.timings = timings = Timings()
        self.dialog_losses = []
        ranks = self.mesh.axis_size("data") if self.mesh else 1

        def collect(_, carry):
            return self.collect_dialog(carry, generator=gen)

        def update(_, traj, key, grad_reduce):
            return None, self.update_dialog(traj, grad_reduce=grad_reduce)

        superstep = self.superstep(collect, update, timings)
        with TensorboardWriter(self.tensorboard_dir()) as writer:
            for update_i in range(cfg.NUM_UPDATES_DIALOG):
                with timings.time("superstep_time"):
                    _, self.carry, traj, stats = superstep(None, self.carry)
                loss = float(stats["dialog_loss"])
                self.dialog_losses.append(loss)
                self.carry = self._refresh_episode_stream(self.carry)
                self.num_steps_done += traj["o_action"].numel() * ranks
                self.num_updates_done += 1
                if update_i % cfg.LOG_INTERVAL == 0:
                    fps = self.num_steps_done / max(time.time() - t_start, 1e-6)
                    logger.info(f"dialog update {update_i} loss {loss:.4f} fps {fps:.1f}")
                    writer.add_scalar("Policy/dialog_loss", loss, self.num_steps_done)
                if (update_i + 1) % max(cfg.CHECKPOINT_INTERVAL_DIALOG, 1) == 0 \
                        or update_i + 1 == cfg.NUM_UPDATES_DIALOG:
                    with timings.time("checkpoint_time"):
                        if self.is_rank0:
                            save_checkpoint(os.path.join(cfg.CHECKPOINT_FOLDER, "vln"), f"ckpt.{ckpt_count}.pth",
                                            {"state_dict": to_flax_params(self.dialog_policy),
                                             "config": cfg.to_dict()})
                        ddppo.barrier(self.mesh)
                    ckpt_count += 1
        self.train_seconds = time.time() - t_start

    def restore(self, ckpt: Dict[str, Any]) -> None:
        """π_q, π_g and π_l, both optimizers (π_q's step count, which its LR
        decay reads) and ``num_steps_done`` from a checkpoint this trainer
        wrote. The belief predictor stays as set up, as in the JAX trainer's
        resume."""
        load_flax_params(self.option_policy, ckpt["state_dict"])
        if "state_dict_goal" in ckpt:
            load_flax_params(self.goal_policy, ckpt["state_dict_goal"])
        if "state_dict_vln" in ckpt:
            load_flax_params(self.dialog_policy, ckpt["state_dict_vln"])
        if "optim_state" in ckpt:
            load_adam_flax(self.option_policy, self.optimizer_q.adam, ckpt["optim_state"]["adam"])
            self.optimizer_q.count = int(ckpt["optim_state"]["count"])
        if "optim_state_vln" in ckpt:
            load_adam_flax(self.dialog_policy, self.optimizer_l, ckpt["optim_state_vln"]["adam"])
        self.num_steps_done = int(ckpt.get("extra_state", {}).get("step", 0))

    def _checkpoint_payload(self) -> Dict[str, Any]:
        """The JAX trainer's keys: the three policies as Flax trees (the JAX
        package reads them), both optimizers' own states at the same Flax
        paths (of the parameters that took a step; π_l's also lists every
        path of π_l, its frozen CLIP tower's included), the config,
        ``extra_state`` and, with one, the belief predictor."""
        modules_l = dict(self.dialog_policy.named_modules())
        payload = {
            "state_dict": to_flax_params(self.option_policy),
            "state_dict_goal": to_flax_params(self.goal_policy),
            "state_dict_vln": to_flax_params(self.dialog_policy),
            "optim_state": {"count": self.optimizer_q.count,
                            "adam": adam_to_flax(self.option_policy, self.optimizer_q.adam)},
            "optim_state_vln": {"adam": adam_to_flax(self.dialog_policy, self.optimizer_l),
                                "paths": ["/".join(("params",) + flax_path(modules_l, n))
                                          for n, _ in self.dialog_policy.named_parameters()]},
            "config": self.config.to_dict(),
            "extra_state": {"step": self.num_steps_done},
        }
        if self.belief_net is not None:
            payload["belief_predictor"] = to_flax_params(self.belief_net)
        return payload

    def save_checkpoint(self, name: str) -> str:
        return save_checkpoint(self.config.CHECKPOINT_FOLDER, name, self._checkpoint_payload())

    # ------------------------------------------------------------------
    def _eval_setup(self, ckpt: Dict[str, Any], seed_offset: int):
        """The env and networks under the checkpoint's config, the eval
        split dealt exactly once under SOUND_TYPE's sound remap: returns
        (carry, consts, generator, episode count, rollout budget)."""
        self.reconfigure_from_checkpoint(ckpt)
        cfg = self.config
        if "belief_predictor" in ckpt and self.belief_net is not None:
            load_flax_params(self.belief_net, ckpt["belief_predictor"])
        num_episodes = int(self.env.eps["scene"].shape[0])
        b = self.env.num_envs
        consts = self.env.eval_consts(cfg.SOUND_TYPE)
        carry = self.reset(order=exact_once_deal(num_episodes, b), consts=consts)
        gen = torch.Generator(device=self.device).manual_seed(cfg.SEED + seed_offset)
        budget = self.eval_rollout_budget(num_episodes, b, self.env.config.max_episode_steps)
        return carry, consts, gen, min(cfg.TEST_EPISODE_COUNT, num_episodes), budget

    def eval_start(self, checkpoint_path: str, writer=None, checkpoint_index: int = 0) -> "InteractiveEval":
        """An interactive eval of the checkpoint, not yet run: π_q, π_g and
        π_l loaded from it, the eval split dealt exactly once, π_g and π_q
        to sample from a generator seeded SEED + 13, and the video hook of
        ``writer`` (None without VIDEO_OPTION)."""
        ckpt = self.load_checkpoint(checkpoint_path)
        carry, consts, gen, count, budget = self._eval_setup(ckpt, 13)
        load_flax_params(self.option_policy, ckpt["state_dict"])
        if "state_dict_goal" in ckpt:
            load_flax_params(self.goal_policy, ckpt["state_dict_goal"])
        if "state_dict_vln" in ckpt:
            load_flax_params(self.dialog_policy, ckpt["state_dict_vln"])
        return InteractiveEval(carry=carry, consts=consts, generator=gen, count=count, budget=budget,
                               videos=self.eval_videos(writer, checkpoint_index))

    def eval_collect(self, ev: "InteractiveEval") -> Dict:
        """One collect of an interactive eval (the configured query strategy
        with its budget and gap, π_l's argmax) and its episode accounting:
        each episode that ends in it is counted once, until TEST_EPISODE_COUNT.
        Advances ``ev``; returns the collect's trajectory."""
        ev.carry, traj = self.collect(ev.carry, deterministic=True, generator=ev.generator, consts=ev.consts)
        if ev.videos is not None:
            ev.videos(traj["dones"], traj["masks"], traj["metrics"])
        dones = traj["dones"].cpu().numpy()
        ep_ids = traj["metrics"]["episode"].cpu().numpy()
        metrics = {k: v.cpu().numpy() for k, v in traj["metrics"].items() if k not in METRIC_BLACKLIST}
        qcount = traj["query_count"].cpu().numpy()
        rlmask = traj["rl_mask"].cpu().numpy()
        for t, bi in zip(*np.nonzero(dones)):
            eid = int(ep_ids[t, bi])
            if eid in ev.seen or ev.done:
                continue
            ev.seen.add(eid)
            for k in metrics:
                ev.stats[k].append(metrics[k][t, bi])
            ev.stats["query_count"].append(qcount[t, bi])
            ev.records["episode"].append(eid)
            ev.records["query_count"].append(float(qcount[t, bi]))
            for k in ("success", "spl", "na"):
                ev.records[k].append(float(metrics[k][t, bi]))
            ev.log_lines.append(
                f"episode {eid}: success={metrics['success'][t, bi]:.0f} "
                f"spl={metrics['spl'][t, bi]:.3f} sna={metrics['sna'][t, bi]:.3f} "
                f"na={metrics['na'][t, bi]:.0f} queries={qcount[t, bi]:.0f} "
                f"vln_steps={float((1.0 - rlmask[: t + 1, bi]).sum()):.0f}")
        return traj

    def _eval_checkpoint(self, checkpoint_path: str, writer, checkpoint_index: int = 0) -> Dict[str, float]:
        """Interactive eval (ppo_trainer.py:1313-2761): ``eval_start``, then
        ``eval_collect`` until TEST_EPISODE_COUNT episodes are counted or the
        rollout budget is spent; ``test_log_ckpt{i}_{sound}.txt`` and
        ``eval_stats_ckpt{i}_{sound}.npz`` per episode in MODEL_DIR and the
        means under ``val/*``. A dialog config takes the dialog protocol
        (a ``vln/ckpt`` holds π_l only and must never load as π_q)."""
        if is_dialog_mode(self.config):
            return self._eval_checkpoint_dialog(checkpoint_path, writer, checkpoint_index)
        ev = self.eval_start(checkpoint_path, writer, checkpoint_index)
        cfg = self.config
        for _ in range(ev.budget):
            if ev.done:
                break
            self.eval_collect(ev)
        self._last_eval_episode_ids = sorted(ev.seen)
        os.makedirs(cfg.MODEL_DIR, exist_ok=True)
        with open(os.path.join(cfg.MODEL_DIR, f"test_log_ckpt{checkpoint_index}_{cfg.SOUND_TYPE}.txt"), "w") as f:
            f.write("\n".join(ev.log_lines) + "\n")
        np.savez(os.path.join(cfg.MODEL_DIR, f"eval_stats_ckpt{checkpoint_index}_{cfg.SOUND_TYPE}.npz"),
                 **{k: np.asarray(v) for k, v in ev.records.items()})
        means = {k: float(np.mean(v)) for k, v in ev.stats.items()}
        means.update(eval_episode_accounting(ev.seen, ev.count, "interactive"))
        logger.info(f"interactive eval ckpt {checkpoint_index}: "
                    + ", ".join(f"{k}={v:.3f}" for k, v in means.items()))
        for k, v in means.items():
            writer.add_scalar(f"val/{k}", v, checkpoint_index)
        return means

    def _eval_checkpoint_dialog(self, checkpoint_path: str, writer, checkpoint_index: int = 0) -> Dict[str, float]:
        """π_l's eval protocol (ss_baselines/savi/config/default.py:348-362,
        ddppo_trainer.py:181-298): a ``vln/ckpt.N.pth`` loaded as π_l, the
        eval split's oracle-driven episodes rolled exactly once (π_l sampled
        from a generator seeded SEED + 17), π_l's per-step action accuracy
        and CE against the oracle beside the split's nav metrics, under
        ``val_dialog/*``."""
        ckpt = self.load_checkpoint(checkpoint_path)
        carry, consts, gen, count, budget = self._eval_setup(ckpt, 17)
        load_flax_params(self.dialog_policy, ckpt["state_dict"])

        stats: Dict[str, list] = collections.defaultdict(list)
        seen: set = set()
        acc_num = ce_num = n_steps = 0.0
        for _ in range(budget):
            if len(seen) >= count:
                break
            carry, traj = self.collect_dialog(carry, generator=gen, consts=consts)
            logits = traj["logits_vln"].double().cpu().numpy()
            oracle = traj["o_action"].long().cpu().numpy()
            z = logits - logits.max(axis=-1, keepdims=True)
            logp = z - np.log(np.exp(z).sum(axis=-1, keepdims=True))
            picked = np.take_along_axis(logp, oracle[..., None], axis=-1)[..., 0]
            acc_num += float((logits.argmax(-1) == oracle).sum())
            ce_num += float(-picked.sum())
            n_steps += float(oracle.size)
            dones = traj["dones"].cpu().numpy()
            ep_ids = traj["metrics"]["episode"].cpu().numpy()
            metrics = {k: v.cpu().numpy() for k, v in traj["metrics"].items() if k not in METRIC_BLACKLIST}
            for t, bi in zip(*np.nonzero(dones)):
                eid = int(ep_ids[t, bi])
                if eid in seen or len(seen) >= count:
                    continue
                seen.add(eid)
                for k in metrics:
                    stats[k].append(metrics[k][t, bi])
        self._last_eval_episode_ids = sorted(seen)
        means = {k: float(np.mean(v)) for k, v in stats.items()}
        means["action_accuracy"] = acc_num / max(n_steps, 1.0)
        means["action_ce"] = ce_num / max(n_steps, 1.0)
        means.update(eval_episode_accounting(seen, count, "dialog"))
        logger.info(f"dialog eval ckpt {checkpoint_index}: " + ", ".join(f"{k}={v:.3f}" for k, v in means.items()))
        for k, v in means.items():
            writer.add_scalar(f"val_dialog/{k}", v, checkpoint_index)
        return means


@dataclasses.dataclass
class InteractiveEval:
    """An interactive eval in progress (``InteractiveDDPPOTrainer.eval_start``):
    the carry, the eval split's tables, the sampling generator, the episodes
    to count and the rollout budget, the video hook, and the episodes
    counted so far with their metrics, records and log lines."""

    carry: InteractiveCarry
    consts: Dict[str, torch.Tensor]
    generator: torch.Generator
    count: int
    budget: int
    videos: Optional[Callable] = None
    seen: set = dataclasses.field(default_factory=set)
    stats: Dict[str, list] = dataclasses.field(default_factory=lambda: collections.defaultdict(list))
    records: Dict[str, list] = dataclasses.field(default_factory=lambda: collections.defaultdict(list))
    log_lines: List[str] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.seen) >= self.count


def is_dialog_mode(config) -> bool:
    """π_l pretraining: ``policy_type: dialog`` or DIALOG_TRAINING."""
    return config.RL.PPO.policy_type == "dialog" or bool(config.DIALOG_TRAINING)
