"""Trainer base class.

PyTorch counterpart of ``avlen_tpu/rl/trainers/base.py`` (contract parity
with BaseTrainer/BaseRLTrainer, ss_baselines/common/base_trainer.py:
22-289): ``train()`` / ``eval()`` entry points, checkpoint folder polling
during eval, the eval-config merge priority (current EVAL opts over the
checkpoint's saved config, base_trainer.py:125-158), resume, and the
exactly-once eval bookkeeping, and the eval's top-down-map videos; and
DD-PPO's rules (``_make_train_mesh``, JAX's ``base.py:128-148``): under a
process group of more than one rank each rank trains its share of the env
slots (``parallel/ddppo.py``), rank 0 alone writes event files, logs,
checkpoints and the interrupted state, and every rank stops at the same
update on a preemption request. Buffer donation is the TPU's alone.
"""

from __future__ import annotations

import collections
import contextlib
import os
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch

from avlen_tpu_torch.config.node import ConfigNode
from avlen_tpu_torch.models.layers import precision_dtype
from avlen_tpu_torch.parallel import ddppo
from avlen_tpu_torch.parallel.mesh import Mesh, make_mesh, world
from avlen_tpu_torch.rl.rollout import RolloutBatch
from avlen_tpu_torch.utils.checkpoint import list_checkpoints, load_checkpoint
from avlen_tpu_torch.utils.logging import logger
from avlen_tpu_torch.utils.maps import _to_px, draw_top_down_map, reveal_fog_of_war
from avlen_tpu_torch.utils.tb import TensorboardWriter
from avlen_tpu_torch.utils.video import generate_video

# the step metrics an eval video reads
VIDEO_METRICS = ("agent_node", "agent_rot", "agent_scene", "goal_node", "spl", "success")

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


class EpisodeWindow:
    """The reward/metric window over finished episodes (the reference's
    window_episode_stats): each done step appends the episode's summed
    reward and its step metrics."""

    def __init__(self, num_envs: int, size: int):
        self.window = collections.deque(maxlen=size)
        self.reward_acc = np.zeros((num_envs,), np.float64)

    def add(self, batch: RolloutBatch) -> int:
        """Adds a rollout's finished episodes; returns its T·B."""
        rewards = batch.rewards.cpu().numpy()
        dones = batch.dones.cpu().numpy()
        metrics = {k: v.cpu().numpy() for k, v in batch.metrics.items() if k not in METRIC_BLACKLIST}
        for t in range(rewards.shape[0]):
            self.reward_acc += rewards[t]
            for b in np.nonzero(dones[t])[0]:
                self.window.append({"reward": self.reward_acc[b], **{k: metrics[k][t, b] for k in metrics}})
                self.reward_acc[b] = 0.0
        return rewards.size

    def means(self) -> Dict[str, float]:
        return {k: float(np.mean([w[k] for w in self.window])) for k in (self.window[0] if self.window else {})}


def eval_pass(collect, count: int, max_rollouts: int, videos=None):
    """The exactly-once eval loop: ``collect()`` rollouts until ``count``
    distinct episode ids ended (or the budget ran out), each episode's
    metrics at its done step counted once. ``videos`` (``eval_videos``'s
    hook, or None) sees each rollout's (dones, masks, metrics) first.
    Returns (per-metric lists, sorted ids)."""
    stats: Dict[str, list] = collections.defaultdict(list)
    seen: set = set()
    for _ in range(max_rollouts):
        if len(seen) >= count:
            break
        batch = collect()
        if videos is not None:
            videos(batch.dones, batch.masks, batch.metrics)
        dones = batch.dones.cpu().numpy()
        ep_ids = batch.metrics["episode"].cpu().numpy()
        metrics = {k: v.cpu().numpy() for k, v in batch.metrics.items() if k not in METRIC_BLACKLIST}
        for t, bi in zip(*np.nonzero(dones)):
            eid = int(ep_ids[t, bi])
            if eid in seen or len(seen) >= count:
                continue
            seen.add(eid)
            for k in metrics:
                stats[k].append(metrics[k][t, bi])
    return stats, sorted(seen)


class BaseRLTrainer:
    def __init__(self, config: ConfigNode, device: Union[str, torch.device] = "cuda"):
        self.config = config
        self.device = torch.device(device)
        self.num_updates_done = 0
        self.num_steps_done = 0
        self._setup_done = False
        # the data-parallel mesh of a train run (None: one process trains)
        self.mesh: Optional[Mesh] = None
        self.sits_out = False

    # -- DD-PPO ------------------------------------------------------------
    def _make_train_mesh(self, num_envs: int) -> Optional[Mesh]:
        """The data-parallel mesh from TPU.MESH_AXES/SHAPE over the ranks of
        the process group, by JAX's rules: None (single-device training) on
        one rank, or when ``num_envs`` does not divide over the mesh (with
        JAX's warning; ``self.sits_out`` is then set on ranks > 0, which
        train nothing). A mesh of fewer ranks than the group, or one that
        shards another axis, raises ``ValueError``."""
        rank, world_size = world()
        self.sits_out = False
        if world_size <= 1:
            return None
        tpu_cfg = self.config.TPU
        mesh = make_mesh(tuple(tpu_cfg.MESH_AXES), tuple(tpu_cfg.MESH_SHAPE))
        if mesh.size != world_size or any(
                size > 1 for name, size in zip(mesh.axis_names, mesh.shape) if name != "data"):
            raise ValueError(f"TPU.MESH_SHAPE {list(mesh.shape)} over {list(mesh.axis_names)}: the port "
                             f"shards the 'data' axis over all {world_size} ranks of the process group")
        n = mesh.size
        if num_envs % n != 0:
            logger.warning(
                f"num_envs={num_envs} not divisible by mesh size {n}; "
                "falling back to single-device training"
            )
            self.sits_out = rank > 0
            return None
        logger.info(f"data-parallel training over {n} ranks: {dict(zip(mesh.axis_names, mesh.shape))}")
        return mesh

    def begin_train(self) -> bool:
        """The mesh of this train run and the setup under it (again, if an
        earlier setup saw all env slots), parameters from rank 0. False on a
        rank that sits the run out."""
        mesh = self._make_train_mesh(self.config.NUM_PROCESSES)
        if self.sits_out:
            return False
        if mesh is not None and self._setup_done and mesh != self.mesh:
            self._setup_done = False
        self.mesh = mesh
        self.ensure_setup()
        self.broadcast_parameters()
        return True

    @property
    def is_rank0(self) -> bool:
        return world()[0] == 0

    def env_slots(self, num_envs: int):
        """This rank's env slots of a packing of ``num_envs``, None without
        a mesh."""
        return ddppo.env_slots(num_envs, self.mesh) if self.mesh is not None else None

    def rank_seed(self, seed: int) -> int:
        return ddppo.rank_seed(seed, self.mesh)

    def trained_modules(self):
        """The modules whose parameters the train run keeps equal on every
        rank (overridden by trainers)."""
        return []

    def broadcast_parameters(self) -> None:
        ddppo.broadcast_modules(self.trained_modules(), self.mesh)

    def global_view(self, tree, num_steps: int):
        """``tree``'s (T, B)-leading and B-leading leaves over all ranks'
        env slots (rank 0's log reads every env, as JAX's host does); the
        tree itself without a mesh."""
        if self.mesh is None:
            return tree
        specs = ddppo.infer_env_specs(tree, self.env.num_envs, num_steps)
        return ddppo.gather_pytree(tree, specs, self.mesh)

    def window_view(self, batch: RolloutBatch) -> RolloutBatch:
        """``batch`` with the rewards, dones and metrics that the episode
        window reads over every rank's env slots."""
        view = {"rewards": batch.rewards, "dones": batch.dones, "metrics": batch.metrics}
        return batch._replace(**self.global_view(view, batch.rewards.shape[0]))

    def superstep(self, collect, update, timings):
        """``parallel.ddppo``'s superstep over the trainer's mesh, its
        collect and update timed into ``timings`` (each ending in a device
        synchronise)."""
        return ddppo.make_superstep(collect, update, self.mesh, timer=self._timer(timings))

    def _timer(self, timings):
        @contextlib.contextmanager
        def timed(name: str) -> Iterator[None]:
            with timings.time(name):
                yield
                self._sync()

        return timed

    def preempted(self) -> bool:
        """On a preemption request on any rank: rank 0 saves the interrupted
        state and requeues the job, and every rank returns True at the same
        update (ddp_utils.py:70-122)."""
        from avlen_tpu_torch.utils import preemption

        if not ddppo.any_rank(preemption.should_exit(), self.mesh, self.device):
            return False
        if self.is_rank0:
            preemption.save_interrupted_state(self._checkpoint_payload())
            preemption.requeue_job()
        return True

    def checkpoint(self, name: str) -> None:
        """``save_checkpoint`` on rank 0, then every rank waits for it."""
        if self.is_rank0:
            self.save_checkpoint(name)
        ddppo.barrier(self.mesh)

    def tensorboard_dir(self) -> Optional[str]:
        """The event files' directory on rank 0, None (no writer) on others."""
        return self.config.TENSORBOARD_DIR if self.is_rank0 else None

    def _setup(self, num_envs=None) -> None:  # overridden by trainers
        raise NotImplementedError

    def compute_dtype(self) -> torch.dtype:
        """TPU.PRECISION → the compute dtype passed into every tower
        (parameters stay float32; ``models/layers.py`` casts as Flax does):
        bfloat16/bf16, float32/fp32, float16/fp16; any other name raises
        ``ValueError``, as in JAX."""
        return precision_dtype(self.config.TPU.PRECISION)

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
        order = streamer.refresh(self.env.episode_cursor(state).cpu().numpy())
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
        its last under USE_LAST_CKPT (base_trainer.py:69-123)."""
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
        common/utils.py:187-238) for episodes fully inside the rollout, as
        the JAX package writes them: host arrays (T, B) of dones, masks and
        the agent-trace metrics recorded when VIDEO_OPTION is set
        (EnvConfig.record_pose_info). Returns the number written."""
        if "agent_node" not in metrics or not self.config.VIDEO_OPTION:
            return 0
        made = 0
        for b in range(dones.shape[1]):
            if made >= max_videos:
                break
            start = 0
            for t in range(dones.shape[0]):
                if masks[t, b] == 0:
                    start = t
                if dones[t, b]:
                    tbl = self.env.scene_tables[int(metrics["agent_scene"][t, b])]
                    edges = np.array(
                        [[u, v] for u in range(tbl.num_nodes) for v in tbl.neighbors[u] if v >= 0],
                        np.int32,
                    )
                    trail = [int(x) for x in metrics["agent_node"][start : t + 1, b]]
                    # per-episode fog-of-war accumulator over the map image
                    # (habitat fog_of_war.py reveal + overlay semantics)
                    size = 256
                    fog = np.zeros((size, size), np.uint8)
                    px, _, _ = _to_px(tbl.positions, size)
                    no_obstacles = np.zeros((size, size), bool)
                    frames = []
                    for i in range(len(trail)):
                        rot = int(metrics["agent_rot"][start + i, b])
                        yx = (int(px[trail[i]][1]), int(px[trail[i]][0]))
                        fog = reveal_fog_of_war(no_obstacles, fog, yx, np.deg2rad(rot * 90), max_line_len=40)
                        frames.append(draw_top_down_map(
                            tbl.positions, edges, trail[i], rot, int(metrics["goal_node"][t, b]),
                            trail=trail[: i + 1], size=size, fog=fog,
                        ))
                    generate_video(
                        self.config.VIDEO_OPTION, self.config.VIDEO_DIR, frames,
                        episode_id=f"{b}_{t}", checkpoint_idx=checkpoint_index,
                        metrics={"spl": float(metrics["spl"][t, b]), "success": float(metrics["success"][t, b])},
                        tb_writer=writer,
                    )
                    made += 1
                    start = t + 1
                    if made >= max_videos:
                        break
        return made

    def eval_videos(self, writer, checkpoint_index: int, first_rollout_only: bool = False):
        """The eval loops' video hook: called with each rollout's device
        tensors (dones, masks, metrics), it copies what the videos need to
        the host once and calls ``generate_eval_videos`` while fewer than 2
        videos were made (a call may make 2 more, so an eval can make 3, as
        in the JAX package), or on the first rollout only (AV-Nav). None
        without VIDEO_OPTION, so such an eval copies nothing more."""
        if not self.config.VIDEO_OPTION:
            return None
        made, calls = 0, 0

        def hook(dones, masks, metrics) -> None:
            nonlocal made, calls
            calls += 1
            if made >= 2 or (first_rollout_only and calls > 1):
                return
            host = {k: metrics[k].cpu().numpy() for k in VIDEO_METRICS if k in metrics}
            made += self.generate_eval_videos(dones.cpu().numpy(), masks.cpu().numpy(), host,
                                              writer, checkpoint_index)

        return hook

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
