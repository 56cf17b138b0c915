"""The port's AV-WAN policy and trainer against the JAX package's on the
CPU, with the JAX weights carried into the port: ``AVWanPolicy``'s act
(masked logits, values, log-probs of fixed waypoints), get_value and
evaluate_actions (values, log-probs, entropy) under action masks, 2e-5;
a greedy rollout of high-level steps over the JAX env's world (waypoints,
dones, masks, action masks and the map observations exact; values and
log-probs 1e-5); one ``update`` on the JAX rollout with JAX's
permutations (losses 1e-5, gradients 5e-4 + 1e-3·|g|, parameters 1e-5);
and ``run.main`` training two updates, resuming exactly, and evaluating
with argmax waypoints, each episode once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlen_tpu.models.avwan_policy import AVWanNet as JaxNet
from avlen_tpu.models.avwan_policy import AVWanPolicy as JaxPolicy
from avlen_tpu.rl.gae import compute_gae as jax_gae
from avlen_tpu.rl.ppo import ppo_update as jax_ppo_update
from avlen_tpu_torch.models.avwan_policy import AVWanNet, AVWanPolicy
from avlen_tpu_torch.rl.trainers.avwan import AVWanTrainer
from avlen_tpu_torch.utils.flax_bridge import _flatten, load_flax_params, to_flax_params
from tests.test_torch_avnav import check_update_against_jax, fast_compile, jax_and_port, train_resume_eval
from tests.test_torch_rnn_policy import _init

torch.set_num_threads(1)

AVWAN = "configs/audionav/av_wan/audiogoal_depth.yaml"


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def policies():
    b, t, h, a = 3, 4, 32, 9
    rng = np.random.RandomState(11)
    obs = {"spectrogram": rng.rand(b, 65, 26, 2).astype(np.float32),
           "gm": (rng.rand(b, 20, 20, 2) > 0.7).astype(np.float32),
           "am": rng.rand(b, 20, 20, 1).astype(np.float32)}
    amask = (rng.rand(b, a * a) > 0.4).astype(np.float32)
    amask[:, a * a // 2] = 1.0
    jpol = JaxPolicy(net=JaxNet(hidden_size=h, spectrogram_hw=(65, 26), action_map_size=a))
    hidden = rng.randn(b, h).astype(np.float32)
    masks = np.array([1.0, 0.0, 1.0], np.float32)
    params = _init(jpol, rng, obs, hidden, masks, amask, jax.random.key(1), method=JaxPolicy.act)
    pol = AVWanPolicy(AVWanNet(hidden_size=h, spectrogram_hw=(65, 26), action_map_size=a))
    load_flax_params(pol, jax.tree.map(np.asarray, params))
    seq_obs = {k: rng.rand(t, *v.shape).astype(np.float32) for k, v in obs.items()}
    seq_amask = (rng.rand(t, b, a * a) > 0.4).astype(np.float32)
    seq_amask[..., a * a // 2] = 1.0
    actions = np.array([[rng.choice(np.nonzero(m)[0]) for m in step] for step in seq_amask], np.int32)
    return dict(jpol=jpol, params=params, pol=pol, obs=obs, hidden=hidden, masks=masks, amask=amask,
                seq_obs=seq_obs, seq_masks=(rng.rand(t, b) > 0.3).astype(np.float32), seq_amask=seq_amask,
                actions=actions)


def test_policy_tree_act_and_get_value_match_jax(policies):
    p = policies
    ours, theirs = _flatten(to_flax_params(p["pol"])), _flatten(jax.tree.map(np.asarray, p["params"]))
    assert sorted(ours) == sorted(theirs)
    jact = p["jpol"].apply(p["params"], p["obs"], p["hidden"], p["masks"], p["amask"], jax.random.key(2), True,
                           method=JaxPolicy.act)
    jval = p["jpol"].apply(p["params"], p["obs"], p["hidden"], p["masks"], p["amask"],
                           method=JaxPolicy.get_value)
    obs = {k: _t(v) for k, v in p["obs"].items()}
    args = (obs, _t(p["hidden"]), _t(p["masks"]), _t(p["amask"]))
    with torch.no_grad():
        action, logp, value, hidden, logits = p["pol"].act(*args, deterministic=True)
        val = p["pol"].get_value(*args)
        drawn = p["pol"].act(*args, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(action.numpy(), np.asarray(jact[0]))
    for got, want in ((logp, jact[1]), (value, jact[2]), (hidden, jact[3]), (val, jval)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    valid = p["amask"] > 0
    np.testing.assert_allclose(logits.numpy()[valid], np.asarray(jact[4])[valid], atol=2e-5, rtol=0)
    assert (logits.numpy()[~valid] == -1e9).all() and (np.asarray(jact[4])[~valid] == -1e9).all()
    assert valid[np.arange(3), drawn[0].numpy()].all()  # a drawn waypoint is never masked
    jlogp = np.asarray(jax.nn.log_softmax(jact[4]))
    np.testing.assert_allclose(drawn[1].numpy(), jlogp[np.arange(3), drawn[0].numpy()], atol=2e-5)


def test_policy_evaluate_actions_match_jax(policies):
    p = policies
    want = p["jpol"].apply(p["params"], p["seq_obs"], p["hidden"], p["seq_masks"], jnp.asarray(p["actions"]),
                           p["seq_amask"], method=JaxPolicy.evaluate_actions)
    with torch.no_grad():
        got = p["pol"].evaluate_actions({k: _t(v) for k, v in p["seq_obs"].items()}, _t(p["hidden"]),
                                        _t(p["seq_masks"]), _t(p["actions"]).long(), _t(p["seq_amask"]))
    for name, g, w in zip(("values", "log_probs", "entropy"), got, want):
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0, err_msg=name)


# a tiny world (4x4 grids, 4 kHz audio with the spectrogram bank on, 16 px
# depth), the config's maps (50-cell internal map, 20-cell gm/am crops, 9x9
# action map), 3 envs, 5 high-level steps of up to 3 low-level ones,
# episodes of at most 8 low-level steps, hidden 32; one epoch of three
# one-env minibatches
WORLD = [
    "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "12",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_SOUNDS", "2",
    "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "400",
    "TASK_CONFIG.DATASET.SYNTHETIC.MAX_HOPS", "6",
    "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "16",
    "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "4000",
    "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "8",
    "NUM_PROCESSES", "3",
    "PREDICTION_INTERVAL", "3",
    "RL.PPO.num_steps", "5",
    "RL.PPO.hidden_size", "32",
    "RL.PPO.ppo_epoch", "1",
    "RL.PPO.num_mini_batch", "3",
]


@pytest.fixture(scope="module")
def rollouts():
    from avlen_tpu_torch.rl.trainers import avwan

    jtr, ttr = jax_and_port("AVWanTrainer", AVWAN, WORLD, avwan)
    _, jbatch = fast_compile(jtr._collect, jtr.env.consts, jtr.params, jtr.carry, deterministic=True)
    _, tbatch = ttr.collect(deterministic=True)
    return jtr, jbatch, ttr, tbatch


def test_greedy_rollout_matches_jax(rollouts):
    _, jbatch, _, tbatch = rollouts
    for name in ("actions", "dones", "masks", "rewards"):
        np.testing.assert_array_equal(getattr(tbatch, name).numpy(), np.asarray(getattr(jbatch, name)),
                                      err_msg=name)
    for k in ("__amask", "gm", "action_map", "depth", "spectrogram"):
        np.testing.assert_array_equal(tbatch.obs[k].numpy(), np.asarray(jbatch.obs[k]), err_msg=k)
    np.testing.assert_allclose(tbatch.obs["am"].numpy(), np.asarray(jbatch.obs["am"]), rtol=1e-6, atol=0)
    for name in ("values", "log_probs", "bootstrap_value"):
        np.testing.assert_allclose(getattr(tbatch, name).numpy(), np.asarray(getattr(jbatch, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    for k, v in jbatch.metrics.items():
        np.testing.assert_allclose(tbatch.metrics[k].numpy(), np.asarray(v), atol=1e-6, err_msg=k)
    assert tbatch.dones.sum() >= 1 and (tbatch.obs["__amask"] == 0).any()


def _jax_update(jtr):
    """The JAX AV-WAN trainer's update (GAE → ppo_update, the stored
    ``__amask`` split off the obs), jitted: the trainer runs it fused with
    its rollout and keeps no handle of its own."""
    cfg = jtr.ppo_cfg

    def update(params, opt_state, batch, key):
        adv, ret = jax_gae(batch.rewards, batch.values, batch.bootstrap_value,
                           1.0 - batch.dones.astype(jnp.float32), cfg.gamma, cfg.tau)

        def evaluate_actions(p, obs, h0, masks, actions):
            sensor_obs = {k: v for k, v in obs.items() if not k.startswith("__")}
            return jtr.policy.apply(p, sensor_obs, h0, masks, actions, obs["__amask"],
                                    method=JaxPolicy.evaluate_actions)

        return jax_ppo_update(params, opt_state, batch, adv, ret, key, evaluate_actions, jtr.optimizer, cfg)

    return jax.jit(update)


def test_update_matches_jax(rollouts):
    jtr, jbatch, ttr, _ = rollouts
    jtr._update = _jax_update(jtr)
    try:
        check_update_against_jax(jtr, ttr, jbatch)
    finally:
        load_flax_params(ttr.policy, jax.tree.map(np.asarray, jtr.params))


TRAIN = [v if WORLD[i - 1] != "RL.PPO.num_steps" else "3" for i, v in enumerate(WORLD)] + [
    "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
    "TEST_EPISODE_COUNT", "5",
    "LOG_INTERVAL", "1",
    "CHECKPOINT_INTERVAL", "1",
    "VIDEO_OPTION", "[]",
    "EVAL.SPLIT", "train",
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return train_resume_eval(AVWanTrainer, AVWAN, TRAIN, tmp_path_factory.mktemp("avwan"))


def test_train_resumes_exactly_and_counts_frames_per_low_level_step(runs):
    tr = runs["trained"]
    assert runs["ckpts"] == ["ckpt.0.pth", "ckpt.1.pth"]
    assert tr.num_updates_done == 2 and tr.num_steps_done == 2 * 3 * 3 * 3  # updates x T x B x interval
    assert runs["saved"]["optim_state"]["count"] == 2 * 1 * 3
    assert runs["resume_seen"]["diffs"] == {"state_dict": 0.0, "optim_state": 0.0}
    assert (runs["resume_seen"]["count"], runs["resume_seen"]["steps"]) == (6, 54)
    assert runs["after_resume"] == ["ckpt.0.pth", "ckpt.1.pth", "ckpt.2.pth"]
    for name in ("value_loss", "action_loss", "entropy"):
        values = [v for _, v in runs["scalars"][f"Policy/{name}"]]
        assert len(values) == 3 and np.isfinite(values).all(), name


def test_eval_takes_argmax_waypoints_and_counts_each_episode_once(runs):
    ids = runs["evaluated"]._last_eval_episode_ids
    assert len(ids) == 5 and ids == sorted(set(ids))
    assert runs["scalars"]["val/episodes_evaluated"] == [(2, 5.0)]
    assert runs["eval_collects"] and all(det for _, det in runs["eval_collects"])
