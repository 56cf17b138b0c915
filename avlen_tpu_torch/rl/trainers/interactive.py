"""AVLEN interactive trainer (registered "ddppo"): setup and the acting path.

PyTorch counterpart of ``InteractiveDDPPOTrainer`` in
``avlen_tpu/rl/trainers/interactive.py`` (reference DDPPOTrainer,
ss_baselines/savi/ddppo/algo/ddppo_trainer.py:62-1200):

* ``"ddppo"`` is ``ddppo_trainer``: for ``policy_type`` rnn/smt without
  DIALOG_TRAINING it returns the port's ``SaviTrainer``
  (ddppo_trainer.py:92-180), so ``run.py`` with TRAINER_NAME ddppo trains
  the SAVi configs; otherwise an ``InteractiveDDPPOTrainer``;
* ``InteractiveDDPPOTrainer`` (``policy_type: interactive``) builds full AVLEN: π_g (``SMTPolicy``, from
  GOAL_CKPT_PATH), π_l (``DialogPolicy`` with the CLIP text tower, from
  VLN_CKPT_PATH), π_q (``OptionPolicy``), the belief predictor (from its
  ``pretrained_path``), the oracle-instruction bank or host speaker, and
  ``collect``, the interactive rollout (``rl/rollout_interactive.py``).

Its training (the π_q PPO and π_l replay-CE updates of
``rl/ppo_interactive.py``, ``train``, eval and dialog pretraining) is
ROADMAP item 5b: ``train``, ``eval`` and ``update`` raise. The JAX
package's device mesh belongs to DD-PPO (item 8) and to the TPU.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Union

import torch

from avlen_tpu_torch.core.registry import registry
from avlen_tpu_torch.dialog.instruction_source import resolve_instruction_source, sub_instr_token_bank
from avlen_tpu_torch.models.belief_predictor import BeliefPredictorNet, init_belief_state, update_beliefs
from avlen_tpu_torch.models.dialog_policy import AudioNavDialogNet, DialogPolicy
from avlen_tpu_torch.models.memory import init_memory
from avlen_tpu_torch.models.option_policy import AudioNavOptionNet, OptionPolicy
from avlen_tpu_torch.models.smt_policy import AudioNavSMTNet, SMTPolicy
from avlen_tpu_torch.rl.ppo import make_optimizer, ppo_config_from
from avlen_tpu_torch.rl.rollout_interactive import (
    InteractiveCarry,
    InteractiveConfig,
    InteractiveFns,
    collect_rollout_interactive,
    init_query_track,
    sinusoidal_pe,
)
from avlen_tpu_torch.rl.trainers.base import BaseRLTrainer
from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
from avlen_tpu_torch.sim.builder import construct_batched_env
from avlen_tpu_torch.utils.flax_bridge import load_flax_params
from avlen_tpu_torch.utils.logging import logger

TRAINING_LATER = (
    "AVLEN interactive training is not ported yet (ROADMAP item 5b: rl/ppo_interactive.py, "
    "the interactive train(), eval and dialog pretraining); this trainer sets up and collects"
)


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
        if cfg.TPU.PRECISION != "float32":
            raise NotImplementedError(
                f"TPU.PRECISION {cfg.TPU.PRECISION!r}: the PyTorch port computes in float32 only so far")
        if cfg.RL.PPO.policy_type == "dialog" or cfg.DIALOG_TRAINING:
            raise NotImplementedError(f"dialog pretraining: {TRAINING_LATER}")
        self.ppo_cfg = ppo_config_from(cfg)
        self.num_steps = cfg.RL.PPO.num_steps
        self.policy_type = cfg.RL.PPO.policy_type
        smt_cfg = cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER
        bp_cfg = cfg.RL.PPO.BELIEF_PREDICTOR

        self.env = construct_batched_env(
            cfg, num_envs=num_envs, with_depth=True, with_rgb=True,
            extra_sensors=("category_belief", "location_belief", "category"), device=dev,
        )
        b = self.env.num_envs

        # oracle instructions: the token bank (built on the host, moved to
        # the card once) or the host speaker per query
        t_bank = time.perf_counter()
        bank, self.instr_source = resolve_instruction_source(cfg, self.env.scene_tables)
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
        self.sample_generator = torch.Generator(device=dev).manual_seed(cfg.SEED)
        self.clip_calls = 0  # frozen CLIP tower runs in collects
        self.carry = self.reset()
        self._setup_done = True
        self.setup_seconds = time.perf_counter() - t0

    def reset(self) -> InteractiveCarry:
        """A fresh carry: every env slot at the start of its first episode,
        empty memories, beliefs and query track."""
        cfg, b, dev = self.config, self.env.num_envs, self.device
        state, obs = self.env.reset()
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
    def make_fns(self, deterministic: bool = False, generator: Optional[torch.Generator] = None) -> InteractiveFns:
        """The rollout's callables over the current parameters. As in the
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
            env_step=lambda state, actions, query: env.step(state, actions, query),
            belief_fn=belief_fn,
            clip_embed=clip_embed,
        )

    def collect(self, carry: Optional[InteractiveCarry] = None, deterministic: bool = False,
                n: Optional[int] = None, generator: Optional[torch.Generator] = None):
        """One interactive rollout of ``n`` (default RL.PPO.num_steps) steps
        from ``carry`` (default: the trainer's own, which is then advanced).
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
            self.make_fns(deterministic, generator), self.carry if own else carry, instr, self.pe_table,
            icfg, self.num_steps if n is None else n,
            generator=self.sample_generator if generator is None else generator,
        )
        if own:
            self.carry = carry
        return carry, traj

    # ------------------------------------------------------------------
    def train(self) -> None:
        raise NotImplementedError(TRAINING_LATER)

    def eval(self) -> None:
        raise NotImplementedError(TRAINING_LATER)

    def update(self, traj):
        raise NotImplementedError(TRAINING_LATER)
