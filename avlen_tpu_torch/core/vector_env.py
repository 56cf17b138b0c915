"""VectorEnv-compatible facade over the batched environment.

PyTorch counterpart of ``avlen_tpu/core/vector_env.py`` (habitat's
``VectorEnv``/``SyncVectorEnv``, habitat-lab-dialog/habitat/core/
vector_env.py:136-712; ss_baselines/common/sync_vector_env.py:75-586 with
the AVLEN extensions agent_state / is_new_episode /
compute_oracle_actions): ``reset() -> [obs]``, ``step(actions) -> [(obs,
reward, done, info)]``, ``pause_at`` / ``resume_all``, ``async_step`` /
``wait_step``, over ONE batched env on its device instead of worker
processes.

``pause_at`` masks a slot rather than shrinking the batch, as in the JAX
package: the whole batch steps (a paused slot with ``TURN_LEFT``), then
every ``EnvState`` field of a paused slot is put back as it was and its
outputs are withheld.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from avlen_tpu_torch.sim.env import TURN_LEFT, BatchedAudioNavEnv, EnvState


class VectorEnv:
    def __init__(self, env: BatchedAudioNavEnv):
        self._env = env
        self._state: Optional[EnvState] = None
        self._obs = None
        self._paused: set = set()
        self._pending = None

    @property
    def num_envs(self) -> int:
        return self._env.num_envs - len(self._paused)

    def _alive(self) -> List[int]:
        return [i for i in range(self._env.num_envs) if i not in self._paused]

    # -- lifecycle --------------------------------------------------------
    def reset(self) -> List[Dict[str, np.ndarray]]:
        self._state, obs = self._env.reset()
        self._obs = obs
        return self._split_obs(obs)

    def step(self, actions: Sequence[int]):
        self.async_step(actions)
        return self.wait_step()

    def async_step(self, actions: Sequence[int]) -> None:
        full = np.full((self._env.num_envs,), TURN_LEFT, np.int64)
        for slot, a in zip(self._alive(), actions):
            full[slot] = int(a)
        prev = self._state
        state, out = self._env.step(prev, torch.as_tensor(full, device=self._env.device))
        if self._paused:
            keep = torch.zeros((self._env.num_envs,), dtype=torch.bool, device=self._env.device)
            keep[sorted(self._paused)] = True
            # one mask per field, broadcast over its trailing dims ((B, V)
            # view points, the (B, E_per) episode stream)
            state = EnvState(*[
                torch.where(keep.reshape((-1,) + (1,) * (new.ndim - 1)), old, new)
                for new, old in zip(state, prev)
            ])
        self._state = state
        self._pending = out

    def wait_step(self):
        out = self._pending
        self._pending = None
        self._obs = out.obs
        obs_list = self._split_obs(out.obs)
        rewards = out.reward.cpu().numpy()
        dones = out.done.cpu().numpy()
        infos = self._split_obs(out.metrics)
        return [
            (obs_list[j], float(rewards[i]), bool(dones[i]), infos[j])
            for j, i in enumerate(self._alive())
        ]

    # -- pause/resume (vector_env.py:588-612) ------------------------------
    def pause_at(self, index: int) -> None:
        self._paused.add(self._alive()[index])

    def resume_all(self) -> None:
        self._paused.clear()

    # -- AVLEN RPC surface (sync_vector_env.py:54-57, 340-350) -------------
    def agent_state(self) -> List[Dict[str, np.ndarray]]:
        st = self._env.agent_state_host(self._state)
        return [{k: v[i] for k, v in st.items()} for i in self._alive()]

    def is_new_episode(self) -> List[bool]:
        flags = self._state.new_episode.cpu().numpy()
        return [bool(flags[i]) for i in self._alive()]

    def compute_oracle_actions(self) -> List[int]:
        acts = self._env.oracle_action(self._state).cpu().numpy()
        return [int(acts[i]) for i in self._alive()]

    def call(self, function_names: Sequence[str], function_args_list=None) -> List[Any]:
        """`call` RPC equivalent (vector_env.py:613-633): each name is a
        method of this facade, called without arguments (the JAX facade
        ignores ``function_args_list`` too)."""
        return [getattr(self, name)() for name in function_names]

    def close(self) -> None:
        pass

    # ----------------------------------------------------------------------
    def _split_obs(self, obs: Dict[str, torch.Tensor]) -> List[Dict[str, np.ndarray]]:
        # one host copy of each tensor a step, then a numpy view per slot
        host = {k: v.cpu().numpy() for k, v in obs.items()}
        return [{k: v[i] for k, v in host.items()} for i in self._alive()]


SyncVectorEnv = VectorEnv  # in-process variant is the same thing here
ThreadedVectorEnv = VectorEnv
