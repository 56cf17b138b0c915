"""The port's eval against the JAX package's, on a tiny savi.yaml world with
``VIDEO_OPTION []``: ``exact_once_deal``, the heard/unheard sound remap of
``eval_consts`` (the per-episode hash of tests/test_verdict_r4.py:104),
the episode-stream refresh and ``resolve_eval_config`` give JAX's values;
``reset`` and ``step`` under the remapped tables deal remapped episodes;
``_eval_checkpoint`` counts every episode once; a forced tiny rollout
budget warns and records ``episodes_evaluated`` (as
tests/test_verdict_r4.py:52); and ``refresh_ep_order`` leaves the in-flight
episode alone. Eval videos are held in tests/test_torch_video.py."""

import logging
import os

import numpy as np
import pytest
import torch

from avlen_tpu.config import get_config as jax_get_config
from avlen_tpu.rl.trainers import base as jbase
from avlen_tpu.sim.builder import construct_batched_env as jax_construct_batched_env
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.rl.trainers import base as tbase
from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
from avlen_tpu_torch.sim.builder import construct_batched_env
from avlen_tpu_torch.sim.env import MOVE_FORWARD, STOP
from avlen_tpu_torch.utils.logging import logger
from avlen_tpu_torch.utils.tb import TensorboardWriter, read_scalars
from tests.test_torch_slice import OPTS, SAVI

torch.set_num_threads(1)

HELD_OUT = OPTS + [
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "40",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_SOUNDS", "5",
    "TASK_CONFIG.DATASET.HELD_OUT_SOUNDS", "[3, 4]",
]


@pytest.mark.parametrize("num_episodes,num_envs", [(20, 3), (7, 4), (3, 5), (1, 1), (500, 10), (32, 16)])
def test_exact_once_deal_matches_jax(num_episodes, num_envs):
    got = tbase.exact_once_deal(num_episodes, num_envs)
    want = jbase.exact_once_deal(num_episodes, num_envs)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def envs():
    """The same held-out-sound world in both packages (episode tables only
    are compared, so no frames)."""
    jenv = jax_construct_batched_env(jax_get_config(SAVI, opts=HELD_OUT), with_depth=False)
    tenv = construct_batched_env(get_config(SAVI, opts=HELD_OUT), with_depth=False, device="cpu")
    return jenv, tenv


@pytest.mark.parametrize("sound_type", ["heard", "unheard", ""])
def test_eval_consts_match_jax(envs, sound_type):
    jenv, tenv = envs
    np.testing.assert_array_equal(tenv.eps["sound"].numpy(), np.asarray(jenv.consts["eps"]["sound"]))
    want = jenv.eval_consts(sound_type)["eps"]
    got = tenv.eval_consts(sound_type)
    for k in ("sound", "distractor_sound"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    sounds = set(np.unique(got["sound"].numpy()).tolist())
    if sound_type == "unheard":
        assert sounds == {3, 4}  # both held-out sounds, as a per-episode hash deals them
    elif sound_type == "heard":
        assert sounds <= {0, 1, 2}
    else:
        assert got is tenv.eps


def test_reset_and_step_deal_remapped_episodes(envs):
    _, env = envs
    consts = env.eval_consts("unheard")
    order = tbase.exact_once_deal(int(env.eps["scene"].shape[0]), env.num_envs)
    state, _ = env.reset(order=order, consts=consts)
    np.testing.assert_array_equal(state.ep_i.numpy(), order[:, 0])
    np.testing.assert_array_equal(state.sound.numpy(), consts["sound"][state.ep_i].numpy())
    stop = torch.full((env.num_envs,), STOP, dtype=torch.long)
    state, out = env.step(state, stop, consts=consts)  # every slot ends its episode
    assert out.done.all()
    np.testing.assert_array_equal(state.ep_i.numpy(), order[:, 1])
    np.testing.assert_array_equal(state.sound.numpy(), consts["sound"][state.ep_i].numpy())
    assert set(state.sound.tolist()) <= {3, 4}


def test_refresh_matches_jax_and_leaves_the_in_flight_episode(envs):
    jenv, env = envs
    state, _ = env.reset()
    fwd = torch.full((env.num_envs,), MOVE_FORWARD, dtype=torch.long)
    state, _ = env.step(state, fwd)
    cursor = np.array([0, 3, 1][: env.num_envs])
    order = env.streamer.refresh(cursor)
    np.testing.assert_array_equal(order, jenv.streamer.refresh(cursor))
    order = np.roll(np.asarray(state.ep_order), 1, axis=1)
    refreshed = env.refresh_ep_order(state, order)
    np.testing.assert_array_equal(refreshed.ep_order.numpy(), order)
    for name in state._fields:
        if name != "ep_order":
            assert torch.equal(getattr(refreshed, name), getattr(state, name)), name
    # the in-flight episode goes on as it would have; the next one is the new stream's
    a, _ = env.step(state, fwd)
    b, _ = env.step(refreshed, fwd)
    assert torch.equal(a.node, b.node) and torch.equal(a.ep_i, b.ep_i)
    stop = torch.full((env.num_envs,), STOP, dtype=torch.long)
    nxt, out = env.step(b, stop)
    assert out.done.all()
    per = order.shape[1]
    cur = b.cursor.numpy() + 1
    np.testing.assert_array_equal(nxt.ep_i.numpy(), order[np.arange(env.num_envs), cur % per])


def test_resolve_eval_config_matches_jax():
    opts = OPTS + ["VIDEO_OPTION", "[]", "RL.PPO.lr", "3e-4"]
    saved_opts = OPTS + ["RL.PPO.lr", "1e-3", "RL.PPO.entropy_coef", "0.2", "TASK_CONFIG.SIMULATOR.GRID_SIZE", "2.0"]
    saved = get_config(SAVI, opts=saved_opts).to_dict()
    assert saved == jax_get_config(SAVI, opts=saved_opts).to_dict()
    for use_ckpt in ("True", "False"):
        o = opts + ["EVAL.USE_CKPT_CONFIG", use_ckpt]
        got = tbase.BaseRLTrainer(get_config(SAVI, opts=o, run_type="eval"), device="cpu").resolve_eval_config(saved)
        want = jbase.BaseRLTrainer(jax_get_config(SAVI, opts=o, run_type="eval")).resolve_eval_config(saved)
        assert got.to_dict() == want.to_dict()
    assert got.RL.PPO.lr == 3e-4  # the command line over the checkpoint


@pytest.fixture(scope="module")
def eval_trainer(tmp_path_factory):
    """A tiny savi.yaml trainer and a checkpoint of its parameters; the
    eval counts every one of the world's 20 episodes."""
    d = tmp_path_factory.mktemp("eval")
    cfg = get_config(SAVI, opts=OPTS + ["VIDEO_OPTION", "[]", "TEST_EPISODE_COUNT", "20"], model_dir=str(d))
    tr = SaviTrainer(cfg, device="cpu")
    tr._setup()
    path = tr.save_checkpoint("ckpt.0.pth")
    yield tr, path
    os.remove(path)


def test_eval_checkpoint_counts_each_episode_once(eval_trainer):
    tr, path = eval_trainer
    dones = []
    collect = tr.collect

    def counting_collect(*args, **kwargs):
        carry, batch = collect(*args, **kwargs)
        dones.extend(batch.metrics["episode"][batch.dones].tolist())
        return carry, batch

    tr.collect = counting_collect
    try:
        with TensorboardWriter(tr.config.TENSORBOARD_DIR) as writer:
            means = tr._eval_checkpoint(path, writer, 0)
    finally:
        del tr.collect
    assert tr._last_eval_episode_ids == list(range(20))
    assert len(dones) > len(set(dones))  # slots wrapped onto their own episodes, counted once
    assert means["episodes_evaluated"] == 20.0
    assert {"success", "spl", "distance_to_goal"} <= set(means) and "episode" not in means
    scalars = read_scalars(tr.config.TENSORBOARD_DIR)
    assert scalars["val/episodes_evaluated"] == [(0, 20.0)]


def test_eval_tiny_budget_warns_and_records(eval_trainer):
    tr, path = eval_trainer
    records = []
    handler = logging.Handler(level=logging.WARNING)
    handler.emit = lambda r: records.append(r.getMessage())
    logger.addHandler(handler)
    tr.eval_rollout_budget = lambda *a, **kw: 1  # force the under-count
    try:
        with TensorboardWriter(None) as writer:
            means = tr._eval_checkpoint(path, writer, 0)
    finally:
        logger.removeHandler(handler)
        del tr.eval_rollout_budget
    assert "episodes_evaluated" in means
    assert means["episodes_evaluated"] < tr.config.TEST_EPISODE_COUNT
    assert any("episodes" in m and "completed" in m for m in records), records
