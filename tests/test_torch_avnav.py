"""The port's AV-Nav trainer against the JAX package's on the CPU, over one
tiny world (the JAX env's, carried across with its spectrogram bank) with
the JAX weights carried into the port: a greedy rollout of
``collect_rollout`` (actions, dones and masks exact, mask at t+1 = 1 −
done at t; logits, values and log-probs within 1e-5); one ``update`` on
the JAX rollout with JAX's permutations (losses 1e-5, the gradients the
Adam's first moment holds 5e-4 + 1e-3·|g|, parameters 1e-5); then
``run.main`` trains two updates, resumes with the parameters and the Adam
state exactly as saved, and evaluates on held-out sounds (SOUND_TYPE
unheard), each episode once."""

import os

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

import avlen_tpu.rl.trainers  # noqa: F401  (registers the JAX trainers)
import chip_smoke
from avlen_tpu.config import get_config as jax_get_config
from avlen_tpu.core.registry import registry as jax_registry
from avlen_tpu_torch import run
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.rl.rollout import RolloutBatch
from avlen_tpu_torch.rl.ppo import make_optimizer
from avlen_tpu_torch.rl.trainers.avnav import AVNavTrainer
from avlen_tpu_torch.utils.checkpoint import list_checkpoints, load_checkpoint
from avlen_tpu_torch.utils.flax_bridge import load_flax_params
from avlen_tpu_torch.utils.tb import read_scalars
from tests.test_torch_env import port_env_from_jax
from tests.test_torch_slice import _adam_gradients, _pairs, _traced_init

torch.set_num_threads(1)

AVNAV = "configs/audionav/av_nav/audiogoal_depth.yaml"
# a tiny world (4x4 grids, 4 kHz audio with the spectrogram bank on, 16 px
# depth), 3 envs, 10-step rollouts of episodes at most 6 steps long, hidden
# 32; one epoch of three one-env minibatches (each step of a JAX update is
# traced and compiled apart)
WORLD = [
    "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "12",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_SOUNDS", "2",
    "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "400",
    "TASK_CONFIG.DATASET.SYNTHETIC.MAX_HOPS", "6",
    "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "16",
    "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "4000",
    "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "6",
    "NUM_PROCESSES", "3",
    "RL.PPO.num_steps", "10",
    "RL.PPO.hidden_size", "32",
    "RL.PPO.ppo_epoch", "1",
    "RL.PPO.num_mini_batch", "3",
]


def jax_and_port(name, yaml, opts, module):
    """(JAX trainer set up with numpy-filled weights, the port's trainer
    holding the same weights, set up over the JAX env's world: ``module``'s
    ``construct_batched_env`` hands it the JAX env carried across)."""
    jtr = jax_registry.get_trainer(name)(jax_get_config(yaml, opts=opts))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _traced_init(nn.Module.init))
        jtr._setup()
    jenv = getattr(jtr.env, "env", jtr.env)  # AV-WAN's wraps the audio env
    ttr = run.registry.get_trainer(name)(get_config(yaml, opts=opts), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "construct_batched_env", lambda *a, **k: port_env_from_jax(jenv))
        ttr._setup()
    load_flax_params(ttr.policy, jax.tree.map(np.asarray, jtr.params))
    return jtr, ttr


def fast_compile(fn, *args, **static):
    """``fn(*args)`` of a jitted ``fn``, compiled without XLA's expensive
    LLVM passes (half the compile time, the same numbers)."""
    compiled = fn.lower(*args, **static).compile(compiler_options={"xla_llvm_disable_expensive_passes": True})
    return compiled(*args)


def to_port_batch(jbatch):
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    return RolloutBatch(
        obs={k: t(v) for k, v in jbatch.obs.items()}, actions=t(jbatch.actions).long(),
        log_probs=t(jbatch.log_probs), values=t(jbatch.values), rewards=t(jbatch.rewards), masks=t(jbatch.masks),
        dones=t(jbatch.dones), metrics={}, initial_hidden=t(jbatch.initial_hidden),
        bootstrap_value=t(jbatch.bootstrap_value))


def check_update_against_jax(jtr, ttr, jbatch, key_seed=5):
    """One update of each package on the JAX rollout from the same weights
    with JAX's permutations: losses, Adam-held gradients, parameters."""
    cfg = ttr.ppo_cfg
    key = jax.random.key(key_seed)
    perms, k = [], key
    for _ in range(cfg.ppo_epoch):  # as the JAX ppo_update draws them from its key
        k, sub = jax.random.split(k)
        perms.append(np.array(jax.random.permutation(sub, jbatch.actions.shape[1])))
    jparams, jopt, jstats = fast_compile(jtr._update, jtr.params, jtr.opt_state, jbatch, key)
    load_flax_params(ttr.policy, jax.tree.map(np.asarray, jtr.params))
    ttr.optimizer = make_optimizer(ttr.policy.parameters(), cfg)
    stats = ttr.update(to_port_batch(jbatch), perms=perms)
    assert set(stats) == set(jstats) == {"value_loss", "action_loss", "entropy"}
    for name in jstats:
        np.testing.assert_allclose(stats[name].item(), float(jstats[name]), atol=1e-5, rtol=1e-6, err_msg=name)
    assert ttr.optimizer.count == cfg.ppo_epoch * min(cfg.num_mini_batch, jbatch.actions.shape[1])
    live = 0
    for name, got, want in _pairs(chip_smoke.adam_gradients(ttr.policy, ttr.optimizer.adam),
                                  _adam_gradients(jopt)):
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3, err_msg=f"gradient {name}")
        live += int(np.abs(want).max() > 1e-3)
    assert live >= 8
    for name, got, want in _pairs(dict(ttr.policy.named_parameters()), jparams):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=f"parameter {name}")


@pytest.fixture(scope="module")
def rollouts():
    from avlen_tpu_torch.rl.trainers import avnav

    jtr, ttr = jax_and_port("AVNavTrainer", AVNAV, WORLD, avnav)
    assert jtr.env.bank.spec_bank is not None and ttr.env.bank.spec_bank is not None
    _, jbatch = fast_compile(jtr._collect, jtr.env.consts, jtr.params, jtr.carry, deterministic=True)
    _, tbatch = ttr.collect(deterministic=True)
    return jtr, jbatch, ttr, tbatch


def test_greedy_rollout_matches_jax(rollouts):
    _, jbatch, _, tbatch = rollouts
    for name in ("actions", "dones", "masks"):
        np.testing.assert_array_equal(getattr(tbatch, name).numpy(), np.asarray(getattr(jbatch, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tbatch.masks[1:].numpy(), 1.0 - tbatch.dones[:-1].float().numpy())
    assert not tbatch.masks[0].any() and tbatch.dones.sum() >= 3
    for name in ("values", "log_probs", "rewards", "bootstrap_value"):
        np.testing.assert_allclose(getattr(tbatch, name).numpy(), np.asarray(getattr(jbatch, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    assert set(tbatch.metrics) == set(jbatch.metrics)
    for k, v in jbatch.metrics.items():
        np.testing.assert_allclose(tbatch.metrics[k].numpy(), np.asarray(v), atol=1e-6, err_msg=k)


def test_act_logits_match_over_the_rollout(rollouts):
    """The stored steps replayed through both policies' act, hidden carried
    as collected: logits step by step."""
    jtr, jbatch, ttr, _ = rollouts
    from avlen_tpu.models.policy import Policy as JaxPolicy

    act = jax.jit(lambda p, o, h, m: jtr.policy.apply(p, o, h, m, jax.random.key(0), True,
                                                      method=JaxPolicy.act))
    jh = jbatch.initial_hidden
    th = torch.tensor(np.asarray(jh))
    for t in range(jbatch.actions.shape[0]):
        obs = {k: v[t] for k, v in jbatch.obs.items()}
        _, _, _, jh, want = act(jtr.params, obs, jh, jbatch.masks[t])
        with torch.no_grad():
            _, _, _, th, got = ttr.policy.act({k: torch.tensor(np.asarray(v)) for k, v in obs.items()}, th,
                                              torch.tensor(np.asarray(jbatch.masks[t])), deterministic=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0, err_msg=f"step {t}")


def test_update_matches_jax(rollouts):
    jtr, jbatch, ttr, _ = rollouts
    try:
        check_update_against_jax(jtr, ttr, jbatch)
    finally:
        load_flax_params(ttr.policy, jax.tree.map(np.asarray, jtr.params))


# the heard/unheard world of tests/test_heard_unheard_r3.py: sound 3 held out
SPLIT = [
    "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4",
    "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "200",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "12",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_SOUNDS", "4",
    "TASK_CONFIG.DATASET.SYNTHETIC.MAX_HOPS", "6",
    "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "16",
    "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "2000",
    "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
    "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "6",
    "TASK_CONFIG.DATASET.HELD_OUT_SOUNDS", "[3]",
    "NUM_PROCESSES", "2",
    "RL.PPO.num_steps", "4",
    "RL.PPO.ppo_epoch", "1",
    "RL.PPO.hidden_size", "32",
    "TEST_EPISODE_COUNT", "6",
    "LOG_INTERVAL", "1",
    "CHECKPOINT_INTERVAL", "1",
    "VIDEO_OPTION", "[]",
]


def train_resume_eval(trainer_cls, yaml, opts, model_dir, eval_opts=()):
    """``run.main`` trains two updates, resumes for one (the trainer's
    state checked against ckpt.1 before its first update), then evaluates
    the folder's last checkpoint; returns what each step saw."""
    out = {}

    def main(*args, run_type="train"):
        return run.main(["--run-type", run_type, "--exp-config", yaml, "--model-dir", str(model_dir),
                         "--device", "cpu", *opts, *args])

    out["trained"] = main("NUM_UPDATES", "2")
    data = os.path.join(str(model_dir), "data")
    out["ckpts"] = [os.path.basename(p) for p in list_checkpoints(data)]
    saved = load_checkpoint(os.path.join(data, "ckpt.1.pth"))
    out["saved"] = saved
    seen = {}
    collect = trainer_cls.collect

    def hooked(self, *args, **kwargs):
        if not seen:
            seen["diffs"] = chip_smoke.state_differences(self, saved)
            seen["count"], seen["steps"] = self.optimizer.count, self.num_steps_done
        return collect(self, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_cls, "collect", hooked)
        out["resumed"] = main("NUM_UPDATES", "1", "RESUME_CHECKPOINT", "True")
    out["resume_seen"] = seen
    out["after_resume"] = [os.path.basename(p) for p in list_checkpoints(data)]

    sounds = []

    def spy(self, carry=None, deterministic=False, n=None, consts=None, generator=None):
        sounds.append((consts["sound"].numpy().copy(), deterministic))
        return collect(self, carry, deterministic, n, consts, generator)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_cls, "collect", spy)
        out["evaluated"] = main("USE_LAST_CKPT", "True", *eval_opts, run_type="eval")
    out["eval_collects"] = sounds
    out["scalars"] = read_scalars(os.path.join(str(model_dir), "tb"))
    for p in list_checkpoints(data):
        os.remove(p)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return train_resume_eval(AVNavTrainer, AVNAV, SPLIT, tmp_path_factory.mktemp("avnav"),
                             ("SOUND_TYPE", "unheard"))


def test_train_writes_checkpoints_and_resumes_exactly(runs):
    tr = runs["trained"]
    assert runs["ckpts"] == ["ckpt.0.pth", "ckpt.1.pth"]
    assert tr.num_updates_done == 2 and tr.num_steps_done == 2 * 4 * 2
    assert runs["saved"]["optim_state"]["count"] == 2 * 1 * 1  # updates x epochs x minibatches
    assert runs["resume_seen"]["diffs"] == {"state_dict": 0.0, "optim_state": 0.0}
    assert (runs["resume_seen"]["count"], runs["resume_seen"]["steps"]) == (2, 16)
    assert runs["after_resume"] == ["ckpt.0.pth", "ckpt.1.pth", "ckpt.2.pth"]
    assert runs["resumed"].num_steps_done == 24
    for name in ("value_loss", "action_loss", "entropy"):
        values = [v for _, v in runs["scalars"][f"Policy/{name}"]]
        assert len(values) == 3 and np.isfinite(values).all(), name


def test_eval_counts_each_unheard_episode_once(runs):
    tr = runs["evaluated"]
    ids = tr._last_eval_episode_ids
    assert len(ids) == 6 and ids == sorted(set(ids))
    assert runs["scalars"]["val/episodes_evaluated"] == [(2, 6.0)]
    assert {"val/success", "val/spl"} <= set(runs["scalars"])
    train_sounds = set(tr.env.eps["sound"].numpy().tolist())
    assert train_sounds <= {0, 1, 2}
    assert runs["eval_collects"]
    for sounds, deterministic in runs["eval_collects"]:
        assert (sounds == 3).all() and not deterministic  # held-out sounds, sampled actions


@pytest.mark.parametrize("yaml,updates_done", [(AVNAV, 1), ("configs/audionav/av_wan/audiogoal_depth.yaml", 0)],
                         ids=["avnav_polls_after_the_update", "avwan_polls_before_it"])
def test_preemption_saves_the_interrupted_state(tmp_path, monkeypatch, yaml, updates_done):
    """A pending preemption signal stops training at the stack's poll (as
    each JAX trainer polls) and saves the interrupted state: the trainer's
    parameters and Adam state exactly."""
    from avlen_tpu_torch.utils import preemption

    monkeypatch.setattr(preemption, "INTERRUPTED_STATE_DIR", str(tmp_path / "interrupted"))
    monkeypatch.setattr(preemption, "EXIT", {"requested": True, "requeue": False})
    tr = run.main(["--run-type", "train", "--exp-config", yaml, "--model-dir", str(tmp_path), "--device", "cpu",
                   *SPLIT, "PREDICTION_INTERVAL", "2", "NUM_UPDATES", "3"])
    assert tr.num_updates_done == updates_done
    saved = preemption.load_interrupted_state()
    assert saved is not None and chip_smoke.state_differences(tr, saved) == {"state_dict": 0.0, "optim_state": 0.0}
    assert saved["extra_state"]["step"] == tr.num_steps_done
    os.remove(str(tmp_path / "interrupted" / "local.pth"))
