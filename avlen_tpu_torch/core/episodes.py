"""Episode datasets, iteration, and device packing.

Mirrors the reference episode model: `SemanticAudioGoalNavEpisode`
(soundspaces/tasks/semantic_audionav_task.py:38-63, dialog variant
semantic_audiodialognav_task.py:39-60) and habitat's
`Dataset`/`EpisodeIterator` (habitat-lab-dialog/habitat/core/dataset.py:
82-529: cycling, shuffling, scene grouping, max_scene_repeat limits).

TPU-native difference: after host-side iteration order is fixed, episodes are
*packed into dense arrays* and streamed to each env slot on device; the
batched env auto-advances its per-slot cursor on episode end, so no host
round-trip happens at episode boundaries.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import random
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

MAX_VIEW_POINTS = 16


@dataclasses.dataclass
class Episode:
    """One navigation episode on a scene graph.

    ``goal_node`` is the sound source node; ``view_point_nodes`` are the
    success view points (semantic task goals; defaults to the goal node).
    ``geodesic_distance`` / ``num_action`` mirror episode.info of the
    reference datasets (used by NormalizedDTG and SNA).
    """

    episode_id: str
    scene_id: int
    start_node: int
    start_rot_idx: int  # rotation_angle // 90
    goal_node: int
    sound_id: int = 0
    offset: int = 0
    duration: int = 500  # everlasting default (simulator.py:356-359)
    category: int = 0
    view_point_nodes: Optional[List[int]] = None
    distractor_node: int = -1
    distractor_sound_id: int = -1
    geodesic_distance: Optional[float] = None
    num_action: Optional[int] = None
    # dialog fields (semantic_audiodialognav_task.py:39-60)
    sub_instr: Optional[str] = None
    dialog_node: int = -1


class EpisodeDataset:
    """Episode container with habitat-compatible iteration semantics."""

    def __init__(self, episodes: Sequence[Episode]):
        self.episodes: List[Episode] = list(episodes)

    def scene_ids(self) -> List[int]:
        return sorted({e.scene_id for e in self.episodes})

    def filter_scenes(self, scene_ids: Sequence[int]) -> "EpisodeDataset":
        keep = set(scene_ids)
        return EpisodeDataset([e for e in self.episodes if e.scene_id in keep])

    def episode_iterator(
        self,
        cycle: bool = True,
        shuffle: bool = True,
        group_by_scene: bool = True,
        max_scene_repeat_episodes: int = -1,
        seed: int = 0,
    ) -> Iterator[Episode]:
        return EpisodeIterator(
            self.episodes,
            cycle=cycle,
            shuffle=shuffle,
            group_by_scene=group_by_scene,
            max_scene_repeat_episodes=max_scene_repeat_episodes,
            seed=seed,
        )

    @staticmethod
    def from_json_gz(path: str) -> "EpisodeDataset":
        """Load a packed episode file (our json.gz schema, one dict per episode)."""
        with gzip.open(path, "rt") as f:
            data = json.load(f)
        eps = [Episode(**d) for d in data["episodes"]]
        return EpisodeDataset(eps)

    def to_json_gz(self, path: str) -> None:
        with gzip.open(path, "wt") as f:
            json.dump({"episodes": [dataclasses.asdict(e) for e in self.episodes]}, f)


class EpisodeIterator:
    """Cycling/shuffling/scene-grouped iterator (habitat dataset.py:310-356).

    Scene grouping keeps episodes of one scene adjacent to minimize scene
    switches; ``max_scene_repeat_episodes`` forces a scene switch after that
    many episodes of the same scene (round-robin across remaining scenes).
    """

    def __init__(
        self,
        episodes: Sequence[Episode],
        cycle: bool = True,
        shuffle: bool = True,
        group_by_scene: bool = True,
        max_scene_repeat_episodes: int = -1,
        seed: int = 0,
    ):
        self._rng = random.Random(seed)
        self.cycle = cycle
        self.shuffle = shuffle
        self.group_by_scene = group_by_scene
        self.max_scene_repeat_episodes = max_scene_repeat_episodes
        self.episodes = list(episodes)
        self._order: List[Episode] = []
        self._pos = 0
        self._same_scene_count = 0
        self._refill()

    def _refill(self) -> None:
        eps = list(self.episodes)
        if self.shuffle:
            self._rng.shuffle(eps)
        if self.group_by_scene:
            by_scene: Dict[int, List[Episode]] = {}
            for e in eps:
                by_scene.setdefault(e.scene_id, []).append(e)
            scene_order = list(by_scene)
            if self.shuffle:
                self._rng.shuffle(scene_order)
            if self.max_scene_repeat_episodes > 0:
                # force a scene switch after max_scene_repeat_episodes
                # (habitat dataset.py:310-356): deal one chunk per scene in
                # round-robin, so same-scene runs never exceed the limit
                # while more than one scene has episodes left
                queues: Dict[int, List[List[Episode]]] = {}
                for s in scene_order:
                    lst = by_scene[s]
                    queues[s] = [
                        lst[i : i + self.max_scene_repeat_episodes]
                        for i in range(0, len(lst), self.max_scene_repeat_episodes)
                    ]
                order: List[Episode] = []
                while any(queues.values()):
                    for s in scene_order:
                        if queues[s]:
                            order.extend(queues[s].pop(0))
                eps = order
            else:
                eps = [e for s in scene_order for e in by_scene[s]]
        self._order = eps
        self._pos = 0

    def __iter__(self) -> "EpisodeIterator":
        return self

    def __next__(self) -> Episode:
        if self._pos >= len(self._order):
            if not self.cycle:
                raise StopIteration
            self._refill()
        e = self._order[self._pos]
        self._pos += 1
        return e


def _deal_to_slots(episodes: Sequence[Episode], num_envs: int) -> List[List[int]]:
    """Scene-grouped round-robin deal of episode indices to env slots (the
    reference splits scenes across processes in construct_envs,
    ss_baselines/common/env_utils.py:66-70)."""
    by_scene: Dict[int, List[int]] = {}
    for i, ep in enumerate(episodes):
        by_scene.setdefault(ep.scene_id, []).append(i)
    env_lists: List[List[int]] = [[] for _ in range(num_envs)]
    for k, s in enumerate(sorted(by_scene)):
        env_lists[k % num_envs].extend(by_scene[s])
    for b in range(num_envs):
        if not env_lists[b]:
            env_lists[b] = list(range(len(episodes)))
    return env_lists


class EpisodeStreamer:
    """Host-side per-slot episode streams honoring ITERATOR_OPTIONS.

    The batched env consumes episodes from a fixed-shape per-slot order
    tensor (`EnvState.ep_order`); left alone, that order would cycle forever
    in its initial sequence — no reshuffle between cycles, no forced scene
    switches (the round-2 gap). The streamer keeps one `EpisodeIterator` per
    slot (shuffle-per-cycle, scene grouping, max_scene_repeat forcing —
    habitat dataset.py:310-356) over that slot's episode subset and re-deals
    the *future* of each slot's order between supersteps: `refresh(cursors)`
    drops exactly the episodes consumed since the last refresh and appends
    fresh draws, preserving the iterator's once-per-cycle guarantee. Pure
    host work between device supersteps; purity of the jitted programs is
    untouched.
    """

    def __init__(
        self,
        episodes: Sequence[Episode],
        num_envs: int,
        episodes_per_env: int,
        shuffle: bool = True,
        group_by_scene: bool = True,
        max_scene_repeat_episodes: int = -1,
        seed: int = 0,
    ):
        self.per = episodes_per_env
        self.num_envs = num_envs
        eps = list(episodes)

        class _Ref:
            __slots__ = ("scene_id", "idx")

            def __init__(self, scene_id, idx):
                self.scene_id = scene_id
                self.idx = idx

        self._iters = []
        for b, idxs in enumerate(_deal_to_slots(eps, num_envs)):
            refs = [_Ref(eps[i].scene_id, i) for i in idxs]
            self._iters.append(
                EpisodeIterator(
                    refs,
                    cycle=True,
                    shuffle=shuffle,
                    group_by_scene=group_by_scene,
                    max_scene_repeat_episodes=max_scene_repeat_episodes,
                    seed=seed + b,
                )
            )
        # pending[b][k] = k-th upcoming episode (pending[0] = current)
        self._pending: List[List[int]] = [
            [next(it).idx for _ in range(self.per)] for it in self._iters
        ]
        self._last_cursors = np.zeros((num_envs,), np.int64)

    def keep_slots(self, lo: int, hi: int) -> None:
        """Stream only slots [lo, hi), renumbered from 0 (a DD-PPO rank's
        share; each keeps its own iterator and seed)."""
        self._iters = self._iters[lo:hi]
        self._pending = self._pending[lo:hi]
        self._last_cursors = self._last_cursors[lo:hi]
        self.num_envs = hi - lo

    def initial_order(self) -> np.ndarray:
        """(B, per) order for env.reset (cursor starts at 0)."""
        return np.asarray(self._pending, np.int32)

    def refresh(self, cursors: np.ndarray) -> np.ndarray:
        """(B, per) refreshed order given the slots' current cursors."""
        cursors = np.asarray(cursors, np.int64)
        order = np.zeros((self.num_envs, self.per), np.int32)
        for b in range(self.num_envs):
            consumed = int(cursors[b] - self._last_cursors[b])
            pend = self._pending[b]
            del pend[: min(consumed, len(pend))]
            it = self._iters[b]
            while len(pend) < self.per:
                pend.append(next(it).idx)
            for k in range(self.per):
                order[b, (cursors[b] + k) % self.per] = pend[k]
        self._last_cursors = cursors.copy()
        return order


def pack_episodes(episodes: Sequence[Episode], num_envs: int, episodes_per_env: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Pack an episode stream into dense arrays + a per-env consumption order.

    Episodes are dealt round-robin to env slots grouped by scene (the
    reference splits scenes across processes in construct_envs,
    ss_baselines/common/env_utils.py:66-70); each env slot cycles through its
    own subsequence.
    """
    eps = list(episodes)
    e = len(eps)
    v = MAX_VIEW_POINTS
    out = {
        "scene": np.zeros((e,), np.int32),
        "start_node": np.zeros((e,), np.int32),
        "start_rot": np.zeros((e,), np.int32),
        "goal_node": np.zeros((e,), np.int32),
        "sound": np.zeros((e,), np.int32),
        "offset": np.zeros((e,), np.int32),
        "duration": np.zeros((e,), np.int32),
        "category": np.zeros((e,), np.int32),
        "view_points": np.full((e, v), -1, np.int32),
        "distractor_node": np.full((e,), -1, np.int32),
        "distractor_sound": np.full((e,), -1, np.int32),
        "geodesic": np.zeros((e,), np.float32),
        "num_action": np.zeros((e,), np.int32),
        "dialog_node": np.full((e,), -1, np.int32),
    }
    for i, ep in enumerate(eps):
        out["scene"][i] = ep.scene_id
        out["start_node"][i] = ep.start_node
        out["start_rot"][i] = ep.start_rot_idx
        out["goal_node"][i] = ep.goal_node
        out["sound"][i] = ep.sound_id
        out["offset"][i] = ep.offset
        out["duration"][i] = ep.duration
        out["category"][i] = ep.category
        vps = ep.view_point_nodes or [ep.goal_node]
        out["view_points"][i, : min(len(vps), v)] = vps[:v]
        out["distractor_node"][i] = ep.distractor_node
        out["distractor_sound"][i] = ep.distractor_sound_id
        out["geodesic"][i] = ep.geodesic_distance if ep.geodesic_distance is not None else 0.0
        out["num_action"][i] = ep.num_action if ep.num_action is not None else 0
        out["dialog_node"][i] = ep.dialog_node

    # scene-grouped round-robin deal to env slots
    env_lists = _deal_to_slots(eps, num_envs)
    per = episodes_per_env or max(len(lst) for lst in env_lists)
    order = np.zeros((num_envs, per), np.int32)
    for b in range(num_envs):
        lst = env_lists[b]
        order[b] = np.array([lst[i % len(lst)] for i in range(per)], np.int32)
    out["order"] = order
    return out
