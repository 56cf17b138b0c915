"""The port's VectorEnv facade (avlen_tpu_torch/core/vector_env.py) against
the JAX package's (avlen_tpu/core/vector_env.py) on the same world: the
four cases of tests/test_vector_env_facade.py, each facade over its own
package's env with the JAX world carried across (its jax.random RIR tails
included). Observations, rewards, dones and infos per alive slot: the
spectrogram within 1e-5, everything else exact; a paused slot's EnvState is
bit-frozen; the AVLEN RPCs are equal."""

import numpy as np
import pytest
import torch

from avlen_tpu.core.episodes import pack_episodes as jax_pack
from avlen_tpu.core.vector_env import VectorEnv as JaxVectorEnv
from avlen_tpu.sim.env import BatchedAudioNavEnv as JaxEnv
from avlen_tpu.sim.env import EnvConfig as JaxEnvConfig
from avlen_tpu.sim.synthetic import make_episodes, make_scene_bank
from avlen_tpu_torch.core.vector_env import SyncVectorEnv, ThreadedVectorEnv, VectorEnv
from avlen_tpu_torch.sim.env import BatchedAudioNavEnv, EnvConfig
from avlen_tpu_torch.utils.flax_bridge import scene_bank_from_jax

torch.set_num_threads(1)

SPEC_TOL = 1e-5


@pytest.fixture(scope="module")
def envs():
    """One world for every case: each case wraps these envs in new facades
    (a facade's reset starts the envs over)."""
    bank, tables = make_scene_bank(
        np.random.RandomState(0), num_scenes=1, side=5, rir_length=300,
        sampling_rate=2000, with_frames=False,
    )
    eps = make_episodes(np.random.RandomState(1), tables, 9, min_hops=2, max_hops=6)
    packed = jax_pack(eps, num_envs=3)
    sensors = ("spectrogram", "pose")
    jenv = JaxEnv(bank, packed, JaxEnvConfig(max_episode_steps=20, sensors=sensors))
    tenv = BatchedAudioNavEnv(scene_bank_from_jax(bank, "cpu"), {k: np.asarray(v) for k, v in packed.items()},
                              EnvConfig(max_episode_steps=20, sensors=sensors))
    return jenv, tenv


def _make(envs):
    jenv, tenv = envs
    return JaxVectorEnv(jenv), VectorEnv(tenv)


def _same_dict(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, f"{what}:{k}"
        if k == "spectrogram":
            np.testing.assert_allclose(g, w, atol=SPEC_TOL, rtol=0, err_msg=f"{what}:{k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}:{k}")


def _same_results(got, want, what):
    assert len(got) == len(want), what
    for j, ((o, r, d, info), (wo, wr, wd, winfo)) in enumerate(zip(got, want)):
        assert isinstance(r, float) and isinstance(d, bool)
        _same_dict(o, wo, f"{what} obs[{j}]")
        assert r == wr and d == wd, f"{what}[{j}]: reward/done {r, d} vs {wr, wd}"
        _same_dict(info, winfo, f"{what} info[{j}]")


def test_reset_and_step_tuples(envs):
    jv, tv = _make(envs)
    obs, jobs = tv.reset(), jv.reset()
    assert len(obs) == len(jobs) == 3
    for j in range(3):
        _same_dict(obs[j], jobs[j], f"reset[{j}]")
    results = tv.step([2, 2, 2])
    _same_results(results, jv.step([2, 2, 2]), "step")
    assert "spl" in results[0][3]
    assert SyncVectorEnv is VectorEnv and ThreadedVectorEnv is VectorEnv


def test_async_step_wait_step(envs):
    jv, tv = _make(envs)
    jv.reset()
    tv.reset()
    ends = 0
    for t in range(22):  # past the 20-step cap: auto-resets included
        acts = [1, 2, 1] if t % 3 else [3, 1, 1]
        tv.async_step(acts)
        jv.async_step(acts)
        got = tv.wait_step()
        _same_results(got, jv.wait_step(), f"step{t}")
        ends += sum(d for _, _, d, _ in got)
    assert len(got) == 3 and ends > 0


@pytest.mark.parametrize("slot", [0, 1, 2])
def test_pause_resume_freezes_slot(envs, slot):
    jv, tv = _make(envs)
    jv.reset()
    tv.reset()
    before = [t.clone() for t in tv._state]
    state_before = tv.agent_state()
    tv.pause_at(slot)
    jv.pause_at(slot)
    assert tv.num_envs == jv.num_envs == 2
    for t in range(10):
        acts = [1, 3] if t % 2 else [1, 1]
        _same_results(tv.step(acts), jv.step(acts), f"paused step{t}")
        for f, old, new in zip(tv._state._fields, before, tv._state):
            assert old.dtype == new.dtype and torch.equal(old[slot], new[slot]), f
    assert int(tv._state.node[slot]) == state_before[slot]["node"]
    for f in ("node", "rot", "step_count", "cursor", "goal_node", "view_points", "ep_order", "prev_dtg"):
        np.testing.assert_array_equal(getattr(tv._state, f).numpy(), np.asarray(getattr(jv._state, f)), err_msg=f)
    assert tv.agent_state().__len__() == 2
    tv.resume_all()
    jv.resume_all()
    assert tv.num_envs == 3
    _same_results(tv.step([2, 2, 2]), jv.step([2, 2, 2]), "resumed")


def test_avlen_rpcs(envs):
    jv, tv = _make(envs)
    jv.reset()
    tv.reset()
    for t in range(6):
        assert tv.is_new_episode() == jv.is_new_episode()
        acts = tv.compute_oracle_actions()
        assert acts == jv.compute_oracle_actions()
        assert len(acts) == 3 and all(0 <= a <= 3 for a in acts)
        states, jstates = tv.agent_state(), jv.agent_state()
        for j in range(3):
            _same_dict(states[j], jstates[j], f"agent_state{t}[{j}]")
        assert "distance_to_goal" in states[0]
        assert tv.call(["is_new_episode", "compute_oracle_actions"]) == [tv.is_new_episode(), acts]
        tv.step(acts)
        jv.step(acts)
        if t == 0:
            assert tv.is_new_episode() == [False, False, False]
    tv.pause_at(0)
    jv.pause_at(0)
    assert tv.compute_oracle_actions() == jv.compute_oracle_actions()
    assert tv.is_new_episode() == jv.is_new_episode()


def test_jax_world_arrays_are_the_same_env(envs):
    """The two envs the facades wrap hold the same tables and episode
    streams (the precondition of the comparisons above)."""
    jv, tv = _make(envs)
    for k, v in jv._env.eps.items():
        np.testing.assert_array_equal(tv._env.eps[k].numpy(), np.asarray(v), err_msg=k)
    jstate, _ = jv._env.reset()
    tstate, _ = tv._env.reset()
    np.testing.assert_array_equal(tv._env.oracle_action(tstate).numpy(),
                                  np.asarray(jv._env.oracle_action(jstate)))
