"""Hierarchical waypoint navigation env (AV-WAN).

PyTorch counterpart of ``avlen_tpu/sim/mapnav.py`` (reference MapNavEnv +
Planner + Mapper, ss_baselines/av_wan/mapnav_env.py:22-166,
models/planner.py:19-209, models/mapper.py:27-345): the policy picks a cell
of an egocentric action map; the planner walks toward that waypoint for up
to PREDICTION_INTERVAL low-level steps, registering egomaps into the
allocentric geometric map, accumulating the acoustic map and marking the
cell ahead blocked on a collision.

A high-level step is an eager loop of low-level steps (plan → act → env
step → map update) where the JAX package runs one ``lax.scan``. Envs that
have arrived or whose episode ended hold their env state and mapper; their
observations track the last real step and their metrics freeze at the done
step (``mapnav.py:196-237``). Once no env steps, the remaining low-level
steps would change nothing the step returns, and the loop ends.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from avlen_tpu_torch.ops.mapping import (
    depth_to_egomap,
    distance_field,
    egocentric_crop,
    next_action_from_field,
    register_egomap,
)
from avlen_tpu_torch.sim.env import BatchedAudioNavEnv


class MapperState(NamedTuple):
    geometric: torch.Tensor  # (B, G, G, 2) obstacle / explored
    acoustic: torch.Tensor  # (B, G, G, 1) accumulated intensity
    row: torch.Tensor  # (B,) agent cell
    col: torch.Tensor  # (B,)
    orientation: torch.Tensor  # (B,) quarter turns (0 = map-up)


EGO_MAP_SIZE = 15  # cells of the egomap each depth frame is projected to
BFS_ITERS = 64  # min-plus relaxations of the planner's distance field


@dataclasses.dataclass(frozen=True)
class MapNavConfig:
    internal_map_size: int = 100  # cells (stride units)
    action_map_size: int = 9
    gm_size: int = 20  # egocentric geometric map crop fed to the policy
    am_size: int = 20
    prediction_interval: int = 10


def _select(mask: torch.Tensor, new, old):
    """``new`` where ``mask`` (B,) else ``old``, leaf by leaf over a
    NamedTuple or dict of (B, ...) tensors."""
    def one(n, o):
        return torch.where(mask.reshape((-1,) + (1,) * (n.ndim - 1)), n, o)

    if isinstance(new, dict):
        return {k: one(new[k], old[k]) for k in new}
    return type(new)(*(one(n, o) for n, o in zip(new, old)))


class BatchedMapNavEnv:
    """Wraps BatchedAudioNavEnv with mapping and waypoint planning."""

    def __init__(self, env: BatchedAudioNavEnv, config: MapNavConfig = MapNavConfig()):
        self.env = env
        self.config = config
        self.num_envs = env.num_envs
        self.device = env.device
        # low-level env steps taken (held envs' excluded), a device counter
        self.low_level_steps = torch.zeros((), dtype=torch.long, device=env.device)

    @property
    def eps(self):
        return self.env.eps

    @property
    def scene_tables(self):
        return self.env.scene_tables

    @property
    def streamer(self):
        return getattr(self.env, "streamer", None)

    def eval_consts(self, sound_type: str = ""):
        return self.env.eval_consts(sound_type)

    def episode_cursor(self, state: Tuple) -> torch.Tensor:
        return self.env.episode_cursor(state[0])

    def refresh_ep_order(self, state: Tuple, order) -> Tuple:
        """The (env state, mapper) pair with the env's stream refreshed."""
        env_state, mapper = state
        return self.env.refresh_ep_order(env_state, order), mapper

    @torch.no_grad()
    def reset(self, order=None, consts: Optional[Dict[str, torch.Tensor]] = None):
        """((env state, mapper), obs) of every slot's first episode, with
        empty maps (``order`` and ``consts`` as the env's reset takes them)."""
        state, obs = self.env.reset(order=order, consts=consts)
        mapper = self.init_mapper()
        return (state, mapper), self._augment_obs(obs, mapper)

    def init_mapper(self) -> MapperState:
        b, g, dev = self.num_envs, self.config.internal_map_size, self.device
        return MapperState(
            geometric=torch.zeros((b, g, g, 2), dtype=torch.float32, device=dev),
            acoustic=torch.zeros((b, g, g, 1), dtype=torch.float32, device=dev),
            row=torch.full((b,), g // 2, dtype=torch.long, device=dev),
            col=torch.full((b,), g // 2, dtype=torch.long, device=dev),
            orientation=torch.zeros((b,), dtype=torch.long, device=dev),
        )

    def _reset_mapper_where(self, mapper: MapperState, done: torch.Tensor) -> MapperState:
        g = self.config.internal_map_size
        keep = (~done).float()[:, None, None, None]
        return MapperState(
            geometric=mapper.geometric * keep,
            acoustic=mapper.acoustic * keep,
            row=torch.where(done, g // 2, mapper.row),
            col=torch.where(done, g // 2, mapper.col),
            orientation=torch.where(done, 0, mapper.orientation),
        )

    def _update_mapper(self, mapper: MapperState, obs: Dict, action: torch.Tensor, collided: torch.Tensor,
                       spec_intensity: torch.Tensor) -> MapperState:
        """Advance the pose by the executed action and register the new
        egomap (mapper.update, mapper.py:101-160); -1 is no action."""
        g = self.config.internal_map_size
        fwd, left, right = action == 1, action == 2, action == 3
        o = (mapper.orientation + left.long() - right.long()) % 4
        # direction deltas of the quarter turns: 0 up, 1 left, 2 down, 3 right
        drow = torch.where(o == 0, -1, torch.where(o == 2, 1, 0))
        dcol = torch.where(o == 1, -1, torch.where(o == 3, 1, 0))
        moved = fwd & ~collided
        row = torch.clamp(mapper.row + torch.where(moved, drow, 0), 1, g - 2)
        col = torch.clamp(mapper.col + torch.where(moved, dcol, 0), 1, g - 2)

        geometric = mapper.geometric
        if "depth" in obs:
            ego = depth_to_egomap(obs["depth"], map_size=EGO_MAP_SIZE)
            geometric = register_egomap(geometric, ego, row, col, o)
        # a collision marks the blocked cell ahead as an obstacle
        # (planner.update_map_and_graph, planner.py:56-71)
        brow = torch.clamp(mapper.row + drow, 0, g - 1)
        bcol = torch.clamp(mapper.col + dcol, 0, g - 1)
        hit = (fwd & collided).float()
        bi = torch.arange(action.shape[0], device=action.device)
        zero = torch.zeros_like(bi)
        geometric = geometric.index_put((bi, brow, bcol, zero),
                                        torch.maximum(geometric[bi, brow, bcol, 0], hit))
        acoustic = mapper.acoustic.index_put((bi, row, col, zero), spec_intensity, accumulate=True)
        return MapperState(geometric=geometric, acoustic=acoustic, row=row, col=col, orientation=o)

    def _augment_obs(self, obs: Dict, mapper: MapperState) -> Dict:
        cfg = self.config
        obs = dict(obs)
        pose = (mapper.row, mapper.col, mapper.orientation)
        obs["gm"] = egocentric_crop(mapper.geometric, *pose, cfg.gm_size)
        obs["am"] = egocentric_crop(mapper.acoustic, *pose, cfg.am_size)
        obs["action_map"] = egocentric_crop(mapper.geometric[..., :1], *pose, cfg.action_map_size)
        return obs

    def action_mask(self, obs: Dict) -> torch.Tensor:
        """Valid waypoints: the action map's free cells (the masking of
        CategoricalNetWithMask, common/utils.py:75-128). The centre cell,
        the agent's own, means STOP and is always allowed."""
        amap = obs["action_map"][..., 0]
        mask = (amap.reshape(amap.shape[0], -1) < 0.5).float()
        mask[:, (self.config.action_map_size ** 2) // 2] = 1.0
        return mask

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self, state: Tuple, waypoint: torch.Tensor, consts: Optional[Dict[str, torch.Tensor]] = None):
        """One high-level step to ``waypoint`` (B,), a flattened action-map
        cell; the env's episode tables replaced by ``consts`` when given.
        Returns ((env state, mapper), obs, reward, done, metrics)."""
        env_state, mapper = state
        cfg = self.config
        a = cfg.action_map_size
        g = cfg.internal_map_size
        b = waypoint.shape[0]
        dev = waypoint.device
        waypoint = waypoint.long()
        stop = waypoint == (a * a) // 2

        # the waypoint's egocentric offset (agent at the centre facing up)
        # rotated into the map frame (the inverse of egocentric_crop's turn)
        wr, wc = waypoint // a - a // 2, waypoint % a - a // 2
        o = mapper.orientation
        rr = torch.where(o == 0, wr, torch.where(o == 2, -wr, torch.where(o == 1, -wc, wc)))
        cc = torch.where(o == 0, wc, torch.where(o == 2, -wc, torch.where(o == 1, wr, -wr)))
        goal_row = torch.clamp(mapper.row + rr, 0, g - 1)
        goal_col = torch.clamp(mapper.col + cc, 0, g - 1)

        arrived = torch.zeros((b,), dtype=torch.bool, device=dev)
        done_any = torch.zeros((b,), dtype=torch.bool, device=dev)
        reward = torch.zeros((b,), dtype=torch.float32, device=dev)
        last_obs = self.env._observe(env_state)
        last_metrics = None
        for _ in range(cfg.prediction_interval):
            dist = distance_field(mapper.geometric[..., 0], goal_row, goal_col, BFS_ITERS)
            low = next_action_from_field(dist, mapper.row, mapper.col, mapper.orientation)
            at_goal = (mapper.row == goal_row) & (mapper.col == goal_col)
            finished = arrived | at_goal | (low == 0) | done_any
            # envs at their waypoint hold until the window ends; a STOP
            # waypoint acts exactly once
            do_step = torch.where(stop, ~arrived, ~finished)
            if last_metrics is not None and not bool(do_step.any()):
                break
            safe_action = torch.where(stop, 0, low)
            self.low_level_steps += do_step.sum()

            env_state2, out = self.env.step(env_state, safe_action, consts=consts)
            env_state = _select(do_step, env_state2, env_state)
            step_reward = torch.where(do_step, out.reward, 0.0)
            done = do_step & out.done
            if "spectrogram" in out.obs:
                spec_intensity = out.obs["spectrogram"].abs().mean(dim=(1, 2, 3))
            else:
                spec_intensity = torch.zeros_like(step_reward)
            mapper2 = self._update_mapper(mapper, out.obs, torch.where(do_step, safe_action, -1),
                                          env_state.collided, spec_intensity)
            mapper = self._reset_mapper_where(_select(do_step, mapper2, mapper), done)

            # a held env's out.obs/out.metrics come from a step computed on
            # its held state but never applied: obs track the last real
            # step, metrics freeze at the done step (episode accounting)
            if last_metrics is None:
                last_metrics = {k: torch.zeros_like(v) for k, v in out.metrics.items()}
            last_obs = _select(do_step, out.obs, last_obs)
            last_metrics = _select(do_step & ~done_any, out.metrics, last_metrics)
            arrived = arrived | at_goal | stop
            reward = reward + step_reward
            done_any = done_any | done
        return (env_state, mapper), self._augment_obs(last_obs, mapper), reward, done_any, last_metrics
