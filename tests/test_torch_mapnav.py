"""The port's AV-WAN waypoint env against the JAX package's on the CPU:
``BatchedMapNavEnv`` over one world (the JAX env's, carried across with its
spectrogram bank), reset and then high-level steps to the same waypoints,
drawn from the valid cells of the JAX action mask with STOP among them and
episodes short enough to end inside a step's low-level window: the inner
env state, the mapper's geometric map and pose, the gm/am/action-map
observations and the action masks exact; rewards, dones and the frozen
metrics exact; the acoustic map within 1e-6 relative."""

import numpy as np
import pytest
import torch

from avlen_tpu.config import get_config as jax_get_config
from avlen_tpu.sim.builder import construct_batched_env as jax_construct
from avlen_tpu.sim.mapnav import BatchedMapNavEnv as JaxMapNavEnv
from avlen_tpu.sim.mapnav import MapNavConfig as JaxMapNavConfig
from avlen_tpu_torch.sim.mapnav import BatchedMapNavEnv, MapNavConfig
from tests.test_torch_env import port_env_from_jax

torch.set_num_threads(1)

AVWAN = "configs/audionav/av_wan/audiogoal_depth.yaml"
# a tiny world: 4x4 grids, 8 kHz audio with the spectrogram bank on, 16 px
# frames; episodes of at most 7 low-level steps, so that they end inside a
# high-level step
WORLD = [
    "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "16",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_SOUNDS", "3",
    "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "400",
    "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "16",
    "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "4000",
    "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "7",
    "NUM_PROCESSES", "4",
]
MAP = dict(internal_map_size=30, action_map_size=5, gm_size=9, am_size=9, prediction_interval=4)


def mapnav_pair(opts=WORLD, **overrides):
    """(JAX MapNav env, the port's over the same world and episodes)."""
    cfg = dict(MAP, **overrides)
    jbase = jax_construct(jax_get_config(AVWAN, opts=opts), with_depth=True)
    assert jbase.bank.spec_bank is not None
    return JaxMapNavEnv(jbase, JaxMapNavConfig(**cfg)), BatchedMapNavEnv(port_env_from_jax(jbase),
                                                                         MapNavConfig(**cfg))


def _same(got, want, what, rtol=0.0):
    if rtol:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


def _compare(state, obs, jstate, jobs, env, jenv, step):
    (es, mapper), (jes, jmapper) = state, jstate
    for name in es._fields:
        _same(getattr(es, name), getattr(jes, name), f"env state {name} @ {step}")
    for name in ("geometric", "row", "col", "orientation"):
        _same(getattr(mapper, name), getattr(jmapper, name), f"mapper {name} @ {step}")
    _same(mapper.acoustic, jmapper.acoustic, f"acoustic @ {step}", rtol=1e-6)
    for k in ("gm", "action_map", "depth", "spectrogram", "pose"):
        _same(obs[k], jobs[k], f"obs {k} @ {step}")
    _same(obs["am"], jobs["am"], f"obs am @ {step}", rtol=1e-6)
    _same(env.action_mask(obs), jenv.action_mask(jobs), f"action mask @ {step}")


@pytest.fixture(scope="module")
def walk():
    jenv, env = mapnav_pair()
    a = MAP["action_map_size"]
    center = a * a // 2
    rng = np.random.RandomState(0)
    jstate, jobs = jenv.reset()
    state, obs = env.reset()
    records = [(state, obs, jstate, jobs, None)]
    for step in range(8):
        mask = np.asarray(jenv.action_mask(jobs))
        wp = np.array([rng.choice(np.nonzero(m)[0]) for m in mask], np.int32)
        if step in (2, 5):
            wp[step % 4] = center  # a STOP waypoint
        jstate, jobs, jr, jd, jmet = jenv.step(jstate, wp)
        state, obs, r, d, met = env.step(state, torch.tensor(wp))
        records.append((state, obs, jstate, jobs, (wp, r, d, met, jr, jd, jmet)))
    return jenv, env, records


def test_reset_matches_jax(walk):
    jenv, env, records = walk
    state, obs, jstate, jobs, _ = records[0]
    _compare(state, obs, jstate, jobs, env, jenv, "reset")


def test_high_level_steps_match_jax(walk):
    jenv, env, records = walk
    dones = stops = 0
    for step, (state, obs, jstate, jobs, (wp, r, d, met, jr, jd, jmet)) in enumerate(records[1:]):
        _compare(state, obs, jstate, jobs, env, jenv, step)
        _same(r, jr, f"reward @ {step}")
        _same(d, jd, f"done @ {step}")
        assert set(met) == set(jmet)
        for k in jmet:
            _same(met[k], jmet[k], f"metric {k} @ {step}")
        dones += int(np.asarray(jd).sum())
        stops += int((wp == MAP["action_map_size"] ** 2 // 2).sum())
    assert dones >= 4 and stops >= 2
    # the maps filled in as the agents walked
    assert float(records[-1][0][1].geometric[..., 1].sum()) > 0
    assert float(records[-1][0][1].acoustic.sum()) > 0
