"""Trainer base class.

PyTorch counterpart of ``avlen_tpu/rl/trainers/base.py`` (contract parity
with BaseTrainer/BaseRLTrainer, ss_baselines/common/base_trainer.py:
22-289): ``train()`` / ``eval()`` entry points, checkpoint folder polling
during eval, the eval-config merge priority (current EVAL opts over the
checkpoint's saved config, base_trainer.py:125-158), resume, and the
exactly-once eval bookkeeping. The JAX package's device mesh and buffer
donation belong to multi-card training (ROADMAP item 8) and to the TPU;
eval videos are ROADMAP item 11.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from avlen_tpu_torch.config.node import ConfigNode
from avlen_tpu_torch.utils.checkpoint import list_checkpoints, load_checkpoint
from avlen_tpu_torch.utils.logging import logger
from avlen_tpu_torch.utils.tb import TensorboardWriter

# step-metric keys that are bookkeeping, not scalar performance measures
# (the reference blacklists map-like info in _extract_scalars_from_info,
# savi/ppo/ppo_trainer.py:277-303)
METRIC_BLACKLIST = frozenset(
    {"episode", "agent_node", "agent_rot", "agent_scene", "goal_node"}
)


def scalar_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in metrics.items() if k not in METRIC_BLACKLIST}


def exact_once_deal(num_episodes: int, num_envs: int) -> np.ndarray:
    """Deal episode indices round-robin across env slots for an exactly-once
    eval pass (the fixed-shape analogue of the reference's per-process eval
    splits + pause-on-done, base_trainer.py:185-289). Slots whose stream is
    shorter than the longest wrap onto their own episodes; the caller dedupes
    by episode id."""
    per = max(-(-num_episodes // num_envs), 1)
    order = np.zeros((num_envs, per), np.int32)
    ids = np.arange(num_episodes, dtype=np.int32)
    for b in range(num_envs):
        slot = ids[b::num_envs]
        if slot.size == 0:
            slot = ids
        order[b] = np.resize(slot, per)
    return order


def eval_episode_accounting(seen, count: int, where: str) -> Dict[str, float]:
    """Episodes-evaluated bookkeeping for the exactly-once eval loops: an
    eval that exhausts its rollout budget with fewer than
    TEST_EPISODE_COUNT episodes says so loudly and records
    ``episodes_evaluated``, so that means over a short sample are never
    silent (the reference blocks until every process finishes its split,
    base_trainer.py:185-289)."""
    if len(seen) < count:
        logger.warning(
            "%s eval exhausted its rollout budget with %d/%d episodes "
            "completed; reported means cover only the completed episodes "
            "(more env slots or a higher max_rollouts budget would finish "
            "the split)",
            where, len(seen), count,
        )
    return {"episodes_evaluated": float(len(seen))}


def refuse_videos(config: ConfigNode) -> None:
    """Eval videos (VIDEO_OPTION) are not ported yet: raise rather than
    silently write nothing."""
    if config.VIDEO_OPTION:
        raise NotImplementedError(
            f"VIDEO_OPTION {list(config.VIDEO_OPTION)}: eval videos are not ported yet "
            "(ROADMAP item 11); run eval with VIDEO_OPTION []"
        )


class BaseRLTrainer:
    def __init__(self, config: ConfigNode, device: Union[str, torch.device] = "cuda"):
        self.config = config
        self.device = torch.device(device)
        self.num_updates_done = 0
        self.num_steps_done = 0
        self._setup_done = False

    def _setup(self, num_envs=None) -> None:  # overridden by trainers
        raise NotImplementedError

    def eval_rollout_budget(self, num_episodes: int, num_envs: int, max_episode_steps: int) -> int:
        """Rollout budget of the exactly-once eval loops: enough rollouts for
        every slot to finish its dealt stream at worst-case episode length,
        with slack. A method, so that tests can force a tiny budget."""
        return 10 + 4 * (-(-num_episodes // num_envs)) * (
            -(-max_episode_steps // max(self.num_steps, 1))
        )

    def _refresh_episode_stream(self, carry):
        """Re-deal each slot's future episode order from its ITERATOR_OPTIONS
        stream (EpisodeStreamer) between updates: shuffle per cycle and
        forced scene switches, the reference's EpisodeIterator semantics
        (habitat dataset.py:310-356) applied to ``EnvState.ep_order``."""
        streamer = getattr(self.env, "streamer", None)
        if streamer is None:
            return carry
        state = carry.env_state
        order = streamer.refresh(state.cursor.cpu().numpy())
        return carry._replace(env_state=self.env.refresh_ep_order(state, order))

    def _sync(self) -> None:
        """Wait for the card (the trainers' Timings end their parts so)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def ensure_setup(self) -> None:
        """Lazy build: eval defers env/model construction until the
        checkpoint's config is known."""
        if not self._setup_done:
            self._setup()
            self._setup_done = True

    # -- API -------------------------------------------------------------
    def train(self) -> None:
        raise NotImplementedError

    def _eval_checkpoint(self, checkpoint_path: str, writer: TensorboardWriter,
                         checkpoint_index: int = 0) -> Dict[str, float]:
        raise NotImplementedError

    def eval(self) -> None:
        """Evaluate a single checkpoint or every checkpoint of a folder, or
        its last under USE_LAST_CKPT (base_trainer.py:69-123). Refuses a
        non-empty VIDEO_OPTION before anything runs."""
        refuse_videos(self.config)
        os.makedirs(self.config.TENSORBOARD_DIR, exist_ok=True)
        with TensorboardWriter(self.config.TENSORBOARD_DIR) as writer:
            ckpt_dir = self.config.EVAL_CKPT_PATH_DIR
            if os.path.isfile(ckpt_dir):
                self._eval_checkpoint(ckpt_dir, writer, 0)
                return
            ckpts = list_checkpoints(ckpt_dir)
            if not ckpts:
                logger.warning(f"No checkpoints found in {ckpt_dir}")
                return
            if self.config.USE_LAST_CKPT:
                self._eval_checkpoint(ckpts[-1], writer, len(ckpts) - 1)
                return
            for i, path in enumerate(ckpts):
                self._eval_checkpoint(path, writer, i)

    def resolve_eval_config(self, ckpt_config: Optional[ConfigNode]) -> ConfigNode:
        """Merge priority: current eval opts > checkpoint config > current
        config (base_trainer.py:125-158)."""
        config = self.config.clone()
        if ckpt_config is not None and self.config.EVAL.USE_CKPT_CONFIG:
            config.defrost()
            merged = ckpt_config.clone() if isinstance(ckpt_config, ConfigNode) else ConfigNode(ckpt_config)
            for key in ("TASK_CONFIG", "RL"):
                if key in merged:
                    config[key] = merged[key].clone()
            if self.config.CMD_TRAILING_OPTS:
                config.merge_from_list(list(self.config.CMD_TRAILING_OPTS))
            config.freeze()
        return config

    @staticmethod
    def load_checkpoint(path: str) -> Dict[str, Any]:
        return load_checkpoint(path)

    def reconfigure_from_checkpoint(self, ckpt: Dict[str, Any]) -> None:
        """Rebuild env/policy under the checkpoint's saved config (the
        reference re-merges the eval config from the checkpoint,
        base_trainer.py:125-158), so that network shapes match the run
        that wrote it."""
        if not self.config.EVAL.USE_CKPT_CONFIG or "config" not in ckpt:
            self.ensure_setup()
            return
        saved = ConfigNode(ckpt["config"])
        current = self.config.clone()
        changed = False
        for key in ("TASK_CONFIG", "RL"):
            if key in saved and saved[key].to_dict() != current[key].to_dict():
                current[key] = saved[key].clone()
                changed = True
        if changed:
            if self.config.CMD_TRAILING_OPTS:
                try:
                    current.merge_from_list(list(self.config.CMD_TRAILING_OPTS))
                except KeyError:
                    pass
            current.freeze()
            self.config = current
            if self._setup_done:
                self._setup()
        self.ensure_setup()

    def generate_eval_videos(self, dones, masks, metrics, writer, checkpoint_index: int,
                             max_videos: int = 2) -> int:
        """Top-down-map episode videos at eval (generate_video semantics,
        common/utils.py:187-238) are not ported yet: with VIDEO_OPTION set
        this raises (``refuse_videos``), without it there is nothing to do."""
        refuse_videos(self.config)
        return 0

    def percent_done(self) -> float:
        return self.num_updates_done / max(self.config.NUM_UPDATES, 1)

    def try_to_resume(self) -> Optional[Dict[str, Any]]:
        """Resume from the interrupted state, else the newest checkpoint,
        when RESUME_CHECKPOINT is set (try_to_resume_checkpoint,
        savi/ppo/ppo_trainer.py:238-275 + interrupted-state restore,
        ddppo_trainer.py:796-799); ``_resume_index`` is the next
        checkpoint's number."""
        if not self.config.RESUME_CHECKPOINT:
            return None
        from avlen_tpu_torch.utils.preemption import load_interrupted_state

        interrupted = load_interrupted_state()
        if interrupted is not None:
            logger.info("resuming from interrupted state")
            return interrupted
        ckpts = list_checkpoints(self.config.CHECKPOINT_FOLDER)
        if not ckpts:
            return None
        logger.info(f"resuming from {ckpts[-1]}")
        ckpt = load_checkpoint(ckpts[-1])
        ckpt["_resume_index"] = len(ckpts)
        return ckpt
