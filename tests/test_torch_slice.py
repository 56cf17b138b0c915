"""The SAVi slices of the PyTorch port as a whole, against the JAX package
on the CPU: the config tree and the yaml reader, then both SAVi trainers'
rollouts (the memory SMT policy acting in the batched env with the belief
predictor) with the JAX weights and world carried into the port and greedy
actions: the same actions, values, log-probs, act logits, beliefs and step
features over T steps; then one training update of each (GAE, PPO with
batched ring re-evaluation through the frozen encoders, the belief
predictor's online step) on the same batch with the same minibatch
permutations: the same losses (1e-5), gradients (5e-4 + 1e-3·|g|, read
from each Adam's first moment) and parameters."""

import glob

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import avlen_tpu.rl.trainers  # noqa: F401  (registers the JAX trainers)
from avlen_tpu.config import get_config as jax_get_config
from avlen_tpu.core.registry import registry
from avlen_tpu.models import memory as jmemory
from avlen_tpu.models.smt_policy import SMTPolicy as JaxSMTPolicy
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.config.node import load_yaml, parse_flow
from avlen_tpu_torch.models import memory as tmemory
from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
from avlen_tpu_torch.utils.flax_bridge import load_flax_params
from tests.test_torch_env import port_env_from_jax

torch.set_num_threads(1)

SAVI = "configs/semantic_audionav/savi/savi.yaml"


def test_yaml_reader_matches_pyyaml():
    files = sorted(glob.glob("configs/**/*.yaml", recursive=True))
    assert files
    for path in files:
        with open(path) as f:
            text = f.read()
        assert load_yaml(text) == yaml.safe_load(text), path
    for s in ("1e-3", "1.0e-4", "2.5e-4", "True", "off", "yes", "~", "null", "3", "-7", "0.5",
              "'quoted: x'", '"a # b"', "[a, 'b', 3, [1.5, False]]", "[]", "plain text", ".inf"):
        assert parse_flow(s) == yaml.safe_load(s), s


@pytest.mark.parametrize("path", [None, SAVI, "configs/semantic_audionav/savi/savi_interactive_1st_stage.yaml"])
def test_config_tree_matches_jax(path):
    opts = ["NUM_PROCESSES", "3", "RL.PPO.lr", "1e-4", "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False"]
    assert get_config(path, opts=opts).to_dict() == jax_get_config(path, opts=opts).to_dict()


OPTS = [
    "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "20",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_SOUNDS", "3",
    "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "2000",
    "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "16",
    "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "8000",
    "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
    "NUM_PROCESSES", "3",
    "RL.PPO.num_steps", "5",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "4",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", "32",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", "4",
    # one epoch of two minibatches bounds the JAX update's trace and compile
    # (~20 s); tests/test_torch_ppo.py holds two epochs' permutations
    "RL.PPO.ppo_epoch", "1",
]


def filled_params(rng, shapes):
    """A Flax parameter tree of ``shapes`` (from ``jax.eval_shape``) filled
    from the numpy generator ``rng`` at He scale (biases small and nonzero,
    norm scales one)."""
    def fill(path, s):
        name = path[-1].key
        if name == "scale":
            return jnp.ones(s.shape, s.dtype)
        if name == "bias":
            return jnp.asarray(rng.normal(0, 0.1, s.shape), s.dtype)
        # DenseGeneral q/k/v kernels are (D, H, dh): fan-in D
        fan_in = s.shape[0] if len(s.shape) == 3 and path[-2].key != "out" else int(np.prod(s.shape[:-1]))
        return jnp.asarray(rng.normal(0, np.sqrt(2.0 / fan_in), s.shape), s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _traced_init(orig, seed=0):
    """Flax ``init`` without compiling it: the parameter tree comes from
    ``jax.eval_shape`` and is ``filled_params``. The values only need to be
    the same in both packages, and they are carried into the port;
    compiling the real initialisers of four ResNet-18 towers op by op would
    dominate this file's time."""
    rng = np.random.RandomState(seed)

    def init(self, rngs, *args, method=None, **kwargs):
        shapes = jax.eval_shape(lambda r, *a: orig(self, r, *a, method=method, **kwargs), rngs, *args)
        return filled_params(rng, shapes)

    return init


@pytest.fixture(scope="module")
def rollouts():
    jtr = registry.get_trainer("savi")(jax_get_config(SAVI, opts=OPTS))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _traced_init(nn.Module.init))
        jtr._setup()
    jcarry0 = jtr.carry
    _, jbatch = jtr._collect(jtr.env.consts, jtr.params, jtr.belief_params, jtr.carry, deterministic=True)

    ttr = SaviTrainer(get_config(SAVI, opts=OPTS), device="cpu")
    ttr._setup()
    load_flax_params(ttr.policy, jax.tree.map(np.asarray, jtr.params))
    load_flax_params(ttr.belief_net, jax.tree.map(np.asarray, jtr.belief_params))
    ttr.env = port_env_from_jax(jtr.env)
    ttr.carry = ttr.reset()
    _, tbatch = ttr.collect(deterministic=True)
    return jtr, jcarry0, jbatch, ttr, tbatch


def test_rollouts_match(rollouts):
    _, _, jbatch, _, tbatch = rollouts
    np.testing.assert_array_equal(tbatch.actions.numpy(), np.asarray(jbatch.actions))
    np.testing.assert_array_equal(tbatch.dones.numpy(), np.asarray(jbatch.dones))
    for name, atol in (("values", 1e-4), ("log_probs", 1e-4), ("rewards", 1e-5), ("masks", 0)):
        np.testing.assert_allclose(getattr(tbatch, name).numpy(), np.asarray(getattr(jbatch, name)),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tbatch.bootstrap_value.numpy(), np.asarray(jbatch.bootstrap_value), atol=1e-4)
    for k in ("category_belief", "location_belief", "__feature", "spectrogram", "pose"):
        np.testing.assert_allclose(tbatch.obs[k].numpy(), np.asarray(jbatch.obs[k]), atol=2e-4, err_msg=k)


def test_act_logits_match_over_the_rollout(rollouts):
    """Replays the stored steps through both policies' act: memory ring,
    beliefs and features as collected, logits compared step by step."""
    jtr, jcarry0, jbatch, ttr, tbatch = rollouts
    t_len = jbatch.actions.shape[0]
    act = jax.jit(lambda p, o, pa, mf, mv: jtr.policy.apply(
        p, o, pa, mf, mv, jax.random.key(0), True, method=JaxSMTPolicy.act)[-1])
    jmem = jcarry0.memory
    tmem = tmemory.SMTMemory(*(torch.tensor(np.asarray(x)) for x in jmem))
    tmem = tmem._replace(idx=tmem.idx.long())
    for t in range(t_len):
        obs_t = {k: v[t] for k, v in jbatch.obs.items() if not k.startswith("__")}
        m = np.asarray(jbatch.masks[t]) == 0
        jmem = jmemory.reset_where(jmem, jnp.asarray(m))
        tmem = tmemory.reset_where(tmem, torch.as_tensor(m))
        pa = jbatch.obs["__prev_action"][t]
        want = np.asarray(act(jtr.params, obs_t, pa, jmem.features, jmem.valid))
        with torch.no_grad():
            tobs = {k: torch.tensor(np.asarray(v)) for k, v in obs_t.items()}
            *_, got = ttr.policy.act(tobs, torch.tensor(np.asarray(pa)), tmem.features, tmem.valid,
                                     deterministic=True)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, err_msg=f"logits step {t}")
        feat = jbatch.obs["__feature"][t]
        jmem = jmemory.insert(jmem, feat)
        tmem = tmemory.insert(tmem, torch.tensor(np.asarray(feat)))


def _torch_batch(jbatch, jmem):
    from avlen_tpu_torch.rl.rollout import RolloutBatch

    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    mem = tmemory.SMTMemory(*(t(x) for x in jmem))
    return RolloutBatch(
        obs={k: t(v) for k, v in jbatch.obs.items()}, actions=t(jbatch.actions), log_probs=t(jbatch.log_probs),
        values=t(jbatch.values), rewards=t(jbatch.rewards), masks=t(jbatch.masks), dones=t(jbatch.dones),
        metrics={}, initial_hidden=mem._replace(idx=mem.idx.long()), bootstrap_value=t(jbatch.bootstrap_value),
    )


def _pairs(tensors, jtree):
    """(name, port value, JAX value) for each leaf of the Flax tree
    ``jtree`` (params-shaped) and ``tensors[name]`` of the port's module."""
    from avlen_tpu_torch.utils.flax_bridge import _flatten, convert_leaf

    flat = _flatten(jax.tree.map(np.asarray, jtree["params"]))
    assert len(flat) == len(tensors)
    for path, value in flat.items():
        name, want = convert_leaf(path, value)
        yield name, tensors[name].detach().numpy(), want


def _adam_gradients(opt_state):
    """The first moment of the optax adam in ``opt_state`` over (1 - b1):
    after one step the gradient it took, after more the same mix of every
    step's (chip_smoke.adam_gradients reads the port's Adam so)."""
    import optax

    (adam,) = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
               if isinstance(s, optax.ScaleByAdamState)]
    return jax.tree.map(lambda m: np.asarray(m) / (1 - 0.9), adam.mu)


def test_update_matches_jax(rollouts):
    """One SAVi update (GAE → PPO → belief MSE step) of each package on the
    JAX rollout, from the same parameters, with JAX's permutations: the
    losses, the gradients each Adam's first moment holds (the PPO steps' and
    the belief step's), and the parameters after the update."""
    from chip_smoke import SETTLED_GRAD, adam_gradients
    from avlen_tpu_torch.rl.ppo import make_optimizer

    jtr, jcarry0, jbatch, ttr, _ = rollouts
    cfg = ttr.ppo_cfg
    bp_lr = ttr.config.RL.PPO.BELIEF_PREDICTOR.lr
    key = jax.random.key(5)
    perms, k = [], key
    for _ in range(cfg.ppo_epoch):  # as ppo_update draws them from the key
        k, sub = jax.random.split(k)
        perms.append(np.array(jax.random.permutation(sub, jbatch.actions.shape[1])))
    update = jax.jit(lambda ts, b, k_: jtr._update_ts(ts, b, k_, lambda g: g))
    lowered = update.lower(jtr._train_state(), jbatch, key)
    (jparams, jopt, jbelief, jbelief_opt), jstats = lowered.compile(
        compiler_options={"xla_llvm_disable_expensive_passes": True})(jtr._train_state(), jbatch, key)

    load_flax_params(ttr.policy, jax.tree.map(np.asarray, jtr.params))
    load_flax_params(ttr.belief_net, jax.tree.map(np.asarray, jtr.belief_params))
    ttr.optimizer = make_optimizer(ttr.policy.parameters(), cfg)
    ttr.belief_optimizer = torch.optim.Adam(ttr.belief_net.parameters(), lr=bp_lr)
    try:
        stats = ttr.update(_torch_batch(jbatch, jcarry0.memory), perms=perms)
        assert set(stats) == set(jstats) == {"value_loss", "action_loss", "entropy", "belief_loss"}
        for name in jstats:
            np.testing.assert_allclose(stats[name].item(), float(jstats[name]), atol=1e-5, rtol=1e-6, err_msg=name)
        steps = cfg.ppo_epoch * min(cfg.num_mini_batch, jbatch.actions.shape[1])
        assert ttr.optimizer.count == steps == 2
        for module, adam, jstate, what in ((ttr.policy, ttr.optimizer.adam, jopt, "policy"),
                                           (ttr.belief_net, ttr.belief_optimizer, jbelief_opt, "belief")):
            live = 0
            for name, got, want in _pairs(adam_gradients(module, adam), _adam_gradients(jstate)):
                np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3, err_msg=f"{what} gradient {name}")
                live += int(np.abs(want).max() > 1e-3)
            assert live > 20, what
        for name, got, want in _pairs(dict(ttr.policy.named_parameters()), jparams):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=f"policy {name}")
        # Adam's first step moves each entry by lr·g/(|g| + 1e-8): where the
        # gradient is far above rounding both packages step the same way
        grads = dict((n, w) for n, _, w in _pairs(adam_gradients(ttr.belief_net, ttr.belief_optimizer),
                                                   _adam_gradients(jbelief_opt)))
        settled = total = 0
        for name, got, want in _pairs(dict(ttr.belief_net.named_parameters()), jbelief):
            firm = np.abs(grads[name]) > SETTLED_GRAD
            err = np.abs(got - want)
            assert (err[firm] <= 1e-6).all() and (err <= 2 * bp_lr + 1e-5).all(), f"belief {name} {err.max()}"
            settled, total = settled + int(firm.sum()), total + firm.size
        assert settled > total // 20  # ~14 % of the entries here
    finally:  # the fixture's trainer goes back to the rollout's parameters
        load_flax_params(ttr.policy, jax.tree.map(np.asarray, jtr.params))
        load_flax_params(ttr.belief_net, jax.tree.map(np.asarray, jtr.belief_params))
