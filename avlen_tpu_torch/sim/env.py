"""Batched audio navigation environment on PyTorch tensors.

PyTorch counterpart of ``avlen_tpu/sim/env.py``: all ``B`` env slots advance
together; graph moves are table gathers, audio is the RIR convolution +
spectrogram of ``ops/audio.py`` (the hand-written kernels on a CUDA device),
rewards and measures are vector math, and done slots auto-reset to the next
episode of their stream. Semantics and reference citations are those of the
JAX package: actions STOP/MOVE_FORWARD/TURN_LEFT/TURN_RIGHT with collision
on a blocked forward move, the reward shaping of
ss_baselines/common/environments.py:98-135 (AVLEN query terms included),
and the eight measures DistanceToGoal (VIEW_POINTS), Success, SPL, SoftSPL,
NA, SNA, SWS and NormalizedDistanceToGoal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from avlen_tpu_torch.ops.audio import SpectrogramConfig, render_audiogoal
from avlen_tpu_torch.ops.mapping import depth_to_egomap
from avlen_tpu_torch.sim.graph import UNREACHABLE
from avlen_tpu_torch.sim.mp3d_utils import mp3d_id_to_task_id, task_id_to_mp3d_id
from avlen_tpu_torch.sim.scene import SceneBank, serves_spectra
from avlen_tpu_torch.utils.profiling import span

STOP, MOVE_FORWARD, TURN_LEFT, TURN_RIGHT = 0, 1, 2, 3


class EnvState(NamedTuple):
    node: torch.Tensor  # (B,) i64
    rot: torch.Tensor  # (B,) rotation_angle // 90
    scene: torch.Tensor
    step_count: torch.Tensor
    cursor: torch.Tensor  # position in the slot's episode order
    ep_i: torch.Tensor  # packed episode index
    goal_node: torch.Tensor
    sound: torch.Tensor
    offset: torch.Tensor  # sound start offset in seconds
    duration: torch.Tensor
    category: torch.Tensor
    view_points: torch.Tensor  # (B, V)
    distractor_node: torch.Tensor
    distractor_sound: torch.Tensor
    start_node: torch.Tensor
    start_rot: torch.Tensor
    prev_dtg: torch.Tensor  # (B,) f32 geodesic to goal (reward bookkeeping)
    start_dtg: torch.Tensor  # (B,) f32 DistanceToGoal at episode start
    ep_geodesic: torch.Tensor  # (B,) f32 episode.info geodesic
    ep_num_action: torch.Tensor  # (B,) episode.info num_action
    path_len: torch.Tensor  # (B,) f32
    num_action: torch.Tensor
    collided: torch.Tensor  # (B,) bool
    new_episode: torch.Tensor  # (B,) bool — True on the first obs of an episode
    ep_order: torch.Tensor  # (B, E_per) this slot's episode stream


class QueryInfo(NamedTuple):
    """Per-step AVLEN query inputs (trainer-provided)."""

    is_queried: torch.Tensor  # (B,) bool
    query_num: torch.Tensor  # (B,) count including this query
    cons_reward: torch.Tensor  # (B,) f32
    dist_sample: Optional[torch.Tensor] = None  # (B,) f32 pre-sampled draw


class StepOutput(NamedTuple):
    obs: Dict[str, torch.Tensor]
    reward: torch.Tensor
    done: torch.Tensor
    metrics: Dict[str, torch.Tensor]  # measures of the episode the step belonged to


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    """RL.* reward keys (savi/config/default.py:78-101)."""

    success_reward: float = 10.0
    slack_reward: float = -0.01
    with_time_penalty: bool = True
    with_distance_reward: bool = True
    distance_reward_scale: float = 1.0
    with_query_constraint: bool = False
    num_total_query: int = 5
    query_reward: float = -1.0
    soft_query_reward: bool = False
    consecutive_constraint_reward: bool = False
    with_distance_constraint: bool = False
    query_reward_distance: float = -1.0


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    max_episode_steps: int = 500
    success_distance: float = 0.2
    grid_size: float = 1.0
    sensors: Tuple[str, ...] = (
        "spectrogram",
        "depth",
        "category",
        "pose",
        "collision",
        "oracle_action",
        "category_belief",
        "location_belief",
    )
    num_categories: int = 21
    reward: RewardConfig = RewardConfig()
    has_distractor: bool = False
    record_pose_info: bool = False  # include agent trace in step metrics
    # EgoMap sensor geometry (nav.py:236-406 MAP_SIZE/MAP_RESOLUTION)
    egomap_size: int = 31
    egomap_resolution: float = 0.5


class BatchedAudioNavEnv:
    """Vectorized env over a SceneBank + packed episodes, on the bank's device."""

    def __init__(self, bank: SceneBank, packed: Dict[str, np.ndarray], config: EnvConfig):
        self.bank = bank
        self.config = config
        self.device = bank.device
        self.eps = {k: torch.tensor(np.asarray(v), device=self.device) for k, v in packed.items()}
        self.num_envs = int(packed["order"].shape[0])
        self.spec_config = SpectrogramConfig(sampling_rate=bank.sampling_rate)
        # procedural RIR providers serve analytic spectra (no per-step rFFT)
        if hasattr(bank.rir, "ensure_tables"):
            bank.rir.ensure_tables()
        # SemanticObjectSensor's mpcat40 → task id and MPCAT40Index's task
        # id → mpcat40 tables (soundspaces/tasks/nav.py:515-698)
        self._mp3d_to_task = torch.as_tensor(mp3d_id_to_task_id(), device=self.device)
        self._task_to_mp3d = torch.as_tensor(task_id_to_mp3d_id(), device=self.device)

    # ------------------------------------------------------------------
    def _episode_fields(self, ep_i: torch.Tensor, eps: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        e = self.eps if eps is None else eps
        keys = ("scene", "start_node", "start_rot", "goal_node", "sound", "offset", "duration",
                "category", "view_points", "distractor_node", "distractor_sound")
        out = {k: e[k][ep_i].long() for k in keys}
        out["geodesic"] = e["geodesic"][ep_i]
        out["num_action"] = e["num_action"][ep_i].long()
        return out

    def _dtg_goal(self, scene, node, goal) -> torch.Tensor:
        """Geodesic to the sound source (reward path, environments.py:160-166)."""
        h = self.bank.tables["hops"][scene, node, goal]
        return h.float() * self.config.grid_size

    def _dtg_view_points(self, scene, node, view_points) -> torch.Tensor:
        """DistanceToGoal with DISTANCE_TO=VIEW_POINTS (nav.py:959-1016)."""
        valid = view_points >= 0
        vp = torch.where(valid, view_points, torch.zeros_like(view_points))
        h = self.bank.tables["hops"][scene[:, None], node[:, None], vp]
        h = torch.where(valid, h, torch.full_like(h, int(UNREACHABLE)))
        return torch.min(h, dim=1).values.float() * self.config.grid_size

    # ------------------------------------------------------------------
    @torch.no_grad()
    def reset(self, order: Optional[torch.Tensor] = None,
              consts: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[EnvState, Dict[str, torch.Tensor]]:
        """``order`` overrides the per-slot episode streams, (B, P) ints,
        e.g. an exactly-once eval deal (base_trainer.py:185-289). ``consts``
        replaces the episode tables (``eval_consts``), so that the first
        episode of each slot takes the override too; pass the same tables to
        ``step`` for the episodes that follow."""
        b = self.num_envs
        dev = self.device
        cursor = torch.zeros((b,), dtype=torch.long, device=dev)
        order = self.eps["order"] if order is None else torch.as_tensor(order, device=dev)
        order = order.long().clone()
        ep_i = order[torch.arange(b, device=dev), cursor]
        f = self._episode_fields(ep_i, consts)
        zero = torch.zeros((b,), dtype=torch.long, device=dev)
        state = EnvState(
            node=f["start_node"],
            rot=f["start_rot"],
            scene=f["scene"],
            step_count=zero,
            cursor=cursor,
            ep_i=ep_i,
            goal_node=f["goal_node"],
            sound=f["sound"],
            offset=f["offset"],
            duration=f["duration"],
            category=f["category"],
            view_points=f["view_points"],
            distractor_node=f["distractor_node"],
            distractor_sound=f["distractor_sound"],
            start_node=f["start_node"],
            start_rot=f["start_rot"],
            prev_dtg=self._dtg_goal(f["scene"], f["start_node"], f["goal_node"]),
            start_dtg=self._dtg_view_points(f["scene"], f["start_node"], f["view_points"]),
            ep_geodesic=f["geodesic"],
            ep_num_action=f["num_action"],
            path_len=torch.zeros((b,), dtype=torch.float32, device=dev),
            num_action=zero,
            collided=torch.zeros((b,), dtype=torch.bool, device=dev),
            new_episode=torch.ones((b,), dtype=torch.bool, device=dev),
            ep_order=order,
        )
        return state, self._observe(state)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval_consts(self, sound_type: str = "") -> Dict[str, torch.Tensor]:
        """The episode tables with every episode's sound remapped onto the
        eval sound set: ``heard`` → the train sounds, ``unheard`` → the
        held-out sounds (the reference's eval-time SOUND_ID switch,
        soundspaces/tasks/semantic_audionav_task.py:222-224). The tables
        themselves when no DATASET.HELD_OUT_SOUNDS split is configured.

        Each episode draws its sound by a hash of its packed index (not of
        its train sound, which would fold several train sounds onto one eval
        sound), the same integers as the JAX package's ``eval_consts``."""
        split = getattr(self, "sound_split", None)
        if not split or sound_type not in ("heard", "unheard"):
            return self.eps
        train_ids, held_ids = split
        target = np.asarray(train_ids if sound_type == "heard" else held_ids, np.int64)
        eps = dict(self.eps)
        n = int(eps["sound"].shape[0])

        def draw(salt: int) -> np.ndarray:
            h = (np.arange(n, dtype=np.uint32) + np.uint32(salt)) * np.uint32(2654435761)
            h = h ^ (h >> np.uint32(16))
            return target[(h % np.uint32(target.shape[0])).astype(np.int64)]

        eps["sound"] = torch.as_tensor(draw(0), dtype=eps["sound"].dtype, device=self.device)
        dist = eps["distractor_sound"]
        remapped = torch.as_tensor(draw(0x9E37), dtype=dist.dtype, device=self.device)
        eps["distractor_sound"] = torch.where(dist >= 0, remapped, dist)
        return eps

    def episode_cursor(self, state: EnvState) -> torch.Tensor:
        """(B,) each slot's position in its episode stream."""
        return state.cursor

    def refresh_ep_order(self, state: EnvState, order) -> EnvState:
        """Swap in a refreshed per-slot episode stream (EpisodeStreamer),
        between rollouts: ``ep_order`` is read only at episode boundaries,
        so the in-flight episode is untouched."""
        return state._replace(ep_order=torch.as_tensor(np.asarray(order), device=state.ep_order.device).long())

    @torch.no_grad()
    def step(self, state: EnvState, actions: torch.Tensor, query: Optional[QueryInfo] = None,
             consts: Optional[Dict[str, torch.Tensor]] = None):
        """One step of every slot; done slots auto-reset to the next episode
        of their stream, read from ``consts`` (default: the env's tables)."""
        if query is None:
            b = state.node.shape[0]
            query = QueryInfo(
                is_queried=torch.zeros((b,), dtype=torch.bool, device=self.device),
                query_num=torch.zeros((b,), dtype=torch.long, device=self.device),
                cons_reward=torch.zeros((b,), dtype=torch.float32, device=self.device),
            )
        return self._step_impl(state, actions.long(), query, consts)

    def _step_impl(self, state: EnvState, actions: torch.Tensor, query: QueryInfo,
                   consts: Optional[Dict[str, torch.Tensor]] = None):
        with span("env.dynamics"):
            next_state, r, done, metrics = self._dynamics(state, actions, query, consts)
        obs = self._observe(next_state)
        return next_state, StepOutput(obs=obs, reward=r, done=done, metrics=metrics)

    def _dynamics(self, state: EnvState, actions: torch.Tensor, query: QueryInfo,
                  consts: Optional[Dict[str, torch.Tensor]] = None):
        """Moves, rewards, measures and auto-resets every slot: (next state,
        reward, done, metrics)."""
        cfg = self.config
        tables = self.bank.tables

        stop = actions == STOP
        fwd = actions == MOVE_FORWARD
        left = actions == TURN_LEFT
        right = actions == TURN_RIGHT

        new_rot = (state.rot + left.long() - right.long()) % 4
        orient = (3 - state.rot) % 4  # orientation = (270 - rot)%360 (simulator.py:595-597)
        fwd_target = tables["fwd_next"][state.scene, state.node, orient].long()
        blocked = fwd & (fwd_target < 0)
        new_node = torch.where(fwd & ~blocked, fwd_target, state.node)
        collided = blocked

        step_count = state.step_count + 1
        episode_over = step_count >= cfg.max_episode_steps
        done = stop | episode_over

        reaching_goal = new_node == state.goal_node
        dtg_goal = self._dtg_goal(state.scene, new_node, state.goal_node)
        dtg_measure = self._dtg_view_points(state.scene, new_node, state.view_points)

        # ---- reward (environments.py:98-135); uses pre-reset bookkeeping
        r = torch.zeros_like(dtg_goal)
        rw = cfg.reward
        if rw.with_time_penalty:
            r = r + rw.slack_reward
        if rw.with_distance_reward:
            r = r + (state.prev_dtg - dtg_goal) * rw.distance_reward_scale
        success_for_reward = stop & reaching_goal
        r = r + torch.where(success_for_reward, rw.success_reward, 0.0)
        if rw.with_query_constraint:
            q = query.query_num.float()
            soft = (q / rw.num_total_query) * (np.exp(-rw.num_total_query) + rw.query_reward)
            hard = torch.exp(-q) + rw.query_reward
            within = query.query_num <= rw.num_total_query
            qr = torch.where(within, soft if rw.soft_query_reward else torch.zeros_like(q), hard)
            if rw.consecutive_constraint_reward:
                qr = qr + query.cons_reward
            r = r + torch.where(query.is_queried, qr, torch.zeros_like(qr))
        if rw.with_distance_constraint and query.dist_sample is not None:
            hit = dtg_goal * query.dist_sample <= 3.0
            r = r + torch.where(query.is_queried & hit, rw.query_reward_distance, 0.0)

        # ---- measures of the (possibly ending) episode
        pos_old = tables["positions"][state.scene, state.node]
        pos_new = tables["positions"][state.scene, new_node]
        path_len = state.path_len + torch.sqrt(torch.sum((pos_new - pos_old) ** 2, dim=-1) + 1e-12)
        num_action = state.num_action + 1

        success = (stop & (dtg_measure < cfg.success_distance)).float()
        denom = torch.maximum(state.start_dtg, path_len)
        spl = torch.where(denom > 0, success * state.start_dtg / torch.clamp(denom, min=1e-6), 0.0)
        soft_success = torch.clamp(1.0 - dtg_measure / torch.clamp(state.start_dtg, min=1e-6), min=0.0)
        soft_success = torch.where(state.start_dtg > 0, soft_success, 0.0)
        softspl = torch.where(denom > 0, soft_success * state.start_dtg / torch.clamp(denom, min=1e-6), 0.0)
        na = num_action.float()
        sna = success * state.ep_num_action.float() / torch.clamp(
            torch.maximum(state.ep_num_action, num_action).float(), min=1.0
        )
        sws = success * (step_count > state.duration).float()
        ndtg = dtg_measure / torch.clamp(state.ep_geodesic, min=1e-6)
        metrics = {
            "distance_to_goal": dtg_measure,
            "normalized_distance_to_goal": ndtg,
            "success": success,
            "spl": spl,
            "softspl": softspl,
            "na": na,
            "sna": sna,
            "sws": sws,
            "episode": state.ep_i.float(),
        }
        if cfg.record_pose_info:
            metrics["agent_node"] = new_node.float()
            metrics["agent_rot"] = new_rot.float()
            metrics["agent_scene"] = state.scene.float()
            metrics["goal_node"] = state.goal_node.float()

        # ---- auto-reset: pull each done env's next episode from its stream
        cursor = torch.where(done, state.cursor + 1, state.cursor)
        per = state.ep_order.shape[1]
        ep_i = torch.gather(state.ep_order, 1, (cursor % per)[:, None])[:, 0]
        f = self._episode_fields(ep_i, consts)

        def sel(new_ep_val, cont_val):
            return torch.where(done.reshape((-1,) + (1,) * (cont_val.ndim - 1)), new_ep_val, cont_val)

        next_state = EnvState(
            node=sel(f["start_node"], new_node),
            rot=sel(f["start_rot"], new_rot),
            scene=sel(f["scene"], state.scene),
            step_count=sel(torch.zeros_like(step_count), step_count),
            cursor=cursor,
            ep_i=sel(ep_i, state.ep_i),
            goal_node=sel(f["goal_node"], state.goal_node),
            sound=sel(f["sound"], state.sound),
            offset=sel(f["offset"], state.offset),
            duration=sel(f["duration"], state.duration),
            category=sel(f["category"], state.category),
            view_points=sel(f["view_points"], state.view_points),
            distractor_node=sel(f["distractor_node"], state.distractor_node),
            distractor_sound=sel(f["distractor_sound"], state.distractor_sound),
            start_node=sel(f["start_node"], state.start_node),
            start_rot=sel(f["start_rot"], state.start_rot),
            prev_dtg=sel(self._dtg_goal(f["scene"], f["start_node"], f["goal_node"]), dtg_goal),
            start_dtg=sel(self._dtg_view_points(f["scene"], f["start_node"], f["view_points"]), state.start_dtg),
            ep_geodesic=sel(f["geodesic"], state.ep_geodesic),
            ep_num_action=sel(f["num_action"], state.ep_num_action),
            path_len=sel(torch.zeros_like(path_len), path_len),
            num_action=sel(torch.zeros_like(num_action), num_action),
            collided=torch.where(done, torch.zeros_like(collided), collided),
            new_episode=done,
            ep_order=state.ep_order,
        )
        return next_state, r, done, metrics

    # ------------------------------------------------------------------
    def _observe(self, state: EnvState) -> Dict[str, torch.Tensor]:
        cfg = self.config
        sensors = set(cfg.sensors)
        with span("env.audio"):
            obs = self._observe_audio(state, sensors)
        with span("env.frames"):
            obs.update(self._observe_frames(state, sensors))

        b = state.node.shape[0]
        if "category" in sensors:
            obs["category"] = F.one_hot(state.category, cfg.num_categories).float()
        if "mpcat40_index" in sensors:
            # MPCAT40Index sensor (soundspaces/tasks/nav.py:515-569): the
            # episode's category as its raw mpcat40 index, (B, 1)
            table = self._task_to_mp3d
            obs["mpcat40_index"] = table[torch.clamp(state.category, 0, table.shape[0] - 1)][:, None]
        if "category_belief" in sensors:
            obs["category_belief"] = torch.zeros((b, cfg.num_categories), dtype=torch.float32, device=self.device)
        if "location_belief" in sensors:
            obs["location_belief"] = torch.zeros((b, 2), dtype=torch.float32, device=self.device)
        if "pose" in sensors:
            obs["pose"] = self._pose(state)
        if "pointgoal_with_gps_compass" in sensors:
            # goal in the agent's base frame: X forward, Y rightward (nav.py:290-330)
            tables = self.bank.tables
            d = tables["positions"][state.scene, state.goal_node] - tables["positions"][state.scene, state.node]
            th = state.rot.float() * (math.pi / 2)
            fwd = -d[:, 0] * torch.sin(th) - d[:, 2] * torch.cos(th)
            rgt = d[:, 0] * torch.cos(th) - d[:, 2] * torch.sin(th)
            obs["pointgoal_with_gps_compass"] = torch.stack([fwd, rgt], dim=1)
        if "collision" in sensors:
            obs["collision"] = state.collided.float()[:, None]
        if "oracle_action" in sensors:
            obs["oracle_action"] = self.oracle_action(state)[:, None].float()
        return obs

    def _observe_audio(self, state: EnvState, sensors) -> Dict[str, torch.Tensor]:
        """The spectrogram and audiogoal sensors: the bank's gather, or the
        RIR gather and ``render_audiogoal``."""
        cfg = self.config
        bank = self.bank
        obs: Dict[str, torch.Tensor] = {}
        use_bank = bank.spec_bank is not None and not cfg.has_distractor and "audiogoal" not in sensors
        if "spectrogram" in sensors and use_bank:
            # precomputed spectrogram bank (simulator.py:723-734) as one gather
            az = (4 - state.rot) % 4
            spec = bank.spec_bank[state.scene, state.sound, az, state.node, state.goal_node]
            active = (state.step_count <= state.duration).float()
            obs["spectrogram"] = spec.float() * active[:, None, None, None]
        elif "spectrogram" in sensors or "audiogoal" in sensors:
            az = (4 - state.rot) % 4  # azimuth = -rotation (simulator.py:600-604)
            # analytic spectra (ProceduralRIRBank.gather_fft) skip the
            # per-step rFFT of the RIR; measured RIRs (a dense bank or the
            # host store) come in the time domain
            use_fft = serves_spectra(bank.rir)
            rir = rir_f = None
            if use_fft:
                rir_f = bank.rir.gather_fft(state.scene, az, state.node, state.goal_node)
            else:
                rir = bank.rir.gather(state.scene, az, state.node, state.goal_node)
            sound_padded = bank.sounds_padded[state.sound]
            secs = bank.sound_secs[state.sound].long()
            audio_index = (state.offset + state.step_count) % torch.clamp(secs, min=1)
            active = state.step_count <= state.duration  # silence past duration (simulator.py:646-649)
            dargs = {}
            if bank.sound_fft_bank is not None:
                s_max = bank.sound_fft_bank.shape[1]
                dargs["seg_f"] = bank.sound_fft_bank[state.sound, torch.clamp(audio_index, 0, s_max - 1)]
            if cfg.has_distractor:
                dnode = torch.clamp(state.distractor_node, min=0)
                has = (state.distractor_node >= 0)[:, None, None]
                dsound = torch.clamp(state.distractor_sound, min=0)
                if use_fft:
                    drir_f = bank.rir.gather_fft(state.scene, az, state.node, dnode)
                    dargs["distractor_rir_f"] = drir_f * has.to(drir_f.dtype)
                else:
                    drir = bank.rir.gather(state.scene, az, state.node, dnode)
                    dargs["distractor_rir"] = drir * has.to(drir.dtype)
                dargs.update(distractor_sound_padded=bank.sounds_padded[dsound], has_distractor=True)
                if bank.sound_fft_bank is not None:
                    dargs["distractor_seg_f"] = bank.sound_fft_bank[dsound, 0]
            audio, spec = render_audiogoal(
                sound_padded, audio_index, rir, active, bank.sampling_rate,
                config=self.spec_config, rir_f=rir_f,
                rir_len=bank.rir.length if use_fft else None, **dargs,
            )
            if "audiogoal" in sensors:
                obs["audiogoal"] = audio
            if "spectrogram" in sensors:
                obs["spectrogram"] = spec
        return obs

    def _observe_frames(self, state: EnvState, sensors) -> Dict[str, torch.Tensor]:
        """The rgb, depth, semantic and egomap sensors, gathered from the
        frame banks."""
        cfg = self.config
        bank = self.bank
        obs: Dict[str, torch.Tensor] = {}
        if "rgb" in sensors and bank.rgb is not None:
            obs["rgb"] = bank.rgb[state.scene, state.node, state.rot]
        if "depth" in sensors and bank.depth is not None:
            obs["depth"] = bank.depth[state.scene, state.node, state.rot]
        if "semantic_object" in sensors and bank.semantic is not None:
            # SemanticObjectSensor (nav.py:570-698): pixel instance ids →
            # mpcat40 (the scene's .house table) → 21-way task ids, unknown
            # classes as id 21; ids past the table read instance 0, negative
            # ids count from its end and below -I read mpcat40 0 (JAX's
            # take_along_axis)
            inst = bank.semantic[state.scene, state.node, state.rot].long()  # (B, H, W)
            inst_map = bank.semantic_instance_to_mp3d[state.scene]  # (B, I)
            width = inst_map.shape[1]
            inst = torch.where(inst >= width, torch.zeros_like(inst), inst)
            inst = torch.where(inst < 0, inst + width, inst)
            bsz, hh, ww = inst.shape
            flat = inst.reshape(bsz, -1)
            mp3d = torch.gather(inst_map, 1, torch.clamp(flat, min=0)).long()
            mp3d = torch.where(flat < 0, torch.zeros_like(mp3d), mp3d)
            obs["semantic_object"] = self._mp3d_to_task[torch.clamp(mp3d, 0, 199)].reshape(bsz, hh, ww)
        if "egomap" in sensors and bank.depth is not None:
            # EgoMap sensor (nav.py:236-406): depth → egocentric top-down
            # [obstacle, explored] map
            obs["egomap"] = depth_to_egomap(bank.depth[state.scene, state.node, state.rot],
                                            map_size=cfg.egomap_size, resolution=cfg.egomap_resolution)
        return obs

    def _pose(self, state: EnvState) -> torch.Tensor:
        """Episodic (x=-local_dz, y=local_dx, heading, t) (nav.py:746-775)."""
        tables = self.bank.tables
        pos = tables["positions"][state.scene, state.node]
        origin = tables["positions"][state.scene, state.start_node]
        d = pos - origin
        th_s = state.start_rot.float() * (math.pi / 2)
        lx = d[:, 0] * torch.cos(th_s) - d[:, 2] * torch.sin(th_s)
        lz = d[:, 0] * torch.sin(th_s) + d[:, 2] * torch.cos(th_s)
        heading = (state.rot - state.start_rot).float() * (math.pi / 2)
        heading = torch.remainder(heading + math.pi, 2 * math.pi) - math.pi
        t = state.step_count.float()
        return torch.stack([-lz, lx, heading, t], dim=1)

    def agent_state_host(self, state: EnvState) -> Dict[str, np.ndarray]:
        """Each slot's agent state on the host (environments.py:141-157):
        node, rot, scene, position, goal_node and the geodesic
        distance_to_goal, as numpy arrays."""
        tables = self.bank.tables
        out = {
            "node": state.node,
            "rot": state.rot,
            "scene": state.scene,
            "position": tables["positions"][state.scene, state.node],
            "goal_node": state.goal_node,
            "distance_to_goal": self._dtg_goal(state.scene, state.node, state.goal_node),
        }
        return {k: v.cpu().numpy() for k, v in out.items()}

    def oracle_action(self, state: EnvState) -> torch.Tensor:
        """Greedy next oracle action (simulator.py:758-787): delta(direction,
        orientation) 0→FWD, 270→LEFT, 90/180→RIGHT; at goal→STOP."""
        tables = self.bank.tables
        nxt = tables["oracle_next"][state.scene, state.node, state.goal_node].long()
        p1 = tables["positions"][state.scene, state.node]
        p2 = tables["positions"][state.scene, torch.clamp(nxt, min=0)]
        ang = torch.atan2(p2[:, 2] - p1[:, 2], p2[:, 0] - p1[:, 0])
        dir_idx = torch.round(ang / (math.pi / 2)).long() % 4
        orient = (3 - state.rot) % 4
        delta = (dir_idx - orient) % 4
        action = torch.where(
            delta == 0,
            torch.full_like(delta, MOVE_FORWARD),
            torch.where(delta == 3, torch.full_like(delta, TURN_LEFT), torch.full_like(delta, TURN_RIGHT)),
        )
        at_goal = state.node == state.goal_node
        return torch.where(at_goal | (nxt < 0), torch.full_like(action, STOP), action)
