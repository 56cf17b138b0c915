"""The port's GAE and PPO (avlen_tpu_torch/rl/gae.py, rl/ppo.py) against the
JAX package on the CPU: GAE (1e-6); ``ppo_loss`` and its gradients on a
towers-free ``AudioNavSMTNet`` with batched ring re-evaluation (loss 1e-5,
gradients 5e-4); one ``ppo_update`` handed JAX's minibatch permutations
(stats 1e-5, the gradients Adam's first moment holds 5e-4 + 1e-3·|g|,
parameters 1e-5); the sequential ring replay, the reference the batched
one is held to, against JAX's (1e-5); the optimizer against
optax's clip_by_global_norm + adam below and above max_grad_norm, and its
linear learning-rate decay per optimizer step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avlen_tpu.config import get_config as jax_get_config
from avlen_tpu.models.smt_policy import AudioNavSMTNet as JaxNet
from avlen_tpu.models.smt_policy import SMTPolicy as JaxPolicy
from avlen_tpu.rl import gae as jgae
from avlen_tpu.rl import ppo as jppo
from avlen_tpu.rl.rollout import RolloutBatch as JaxBatch
from avlen_tpu.rl.rollout_smt import evaluate_sequence_smt as jax_sequential_eval
from avlen_tpu.rl.rollout_smt import evaluate_sequence_smt_batched as jax_batched_eval
from avlen_tpu.rl.trainers.avnav import ppo_config_from as jax_ppo_config_from
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.models.memory import SMTMemory
from avlen_tpu_torch.models.smt_policy import AudioNavSMTNet, SMTPolicy
from avlen_tpu_torch.rl import gae, ppo
from avlen_tpu_torch.rl.rollout import RolloutBatch
from avlen_tpu_torch.rl.rollout_smt import evaluate_sequence_smt, evaluate_sequence_smt_batched
from avlen_tpu_torch.utils.flax_bridge import _flatten, convert_leaf, load_flax_params
from tests.test_batched_smt_eval import _random_initial_memory
from chip_smoke import adam_gradients
from tests.test_torch_slice import _adam_gradients, _pairs, filled_params

torch.set_num_threads(1)

T, B, M, CHUNK = 6, 4, 4, 3
CFG = jppo.PPOConfig(ppo_epoch=2, num_mini_batch=2, lr=1e-3, entropy_coef=0.05, max_grad_norm=0.5)


def test_gae_matches_jax():
    rng = np.random.RandomState(0)
    t, b = 13, 5
    rewards = rng.randn(t, b).astype(np.float32)
    values = rng.randn(t, b).astype(np.float32)
    boot = rng.randn(b).astype(np.float32)
    next_masks = (rng.rand(t, b) > 0.2).astype(np.float32)
    want = jgae.compute_gae(*map(jnp.asarray, (rewards, values, boot, next_masks)), 0.99, 0.95)
    got = gae.compute_gae(*map(torch.as_tensor, (rewards, values, boot, next_masks)), 0.99, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_ppo_config_from_matches_jax():
    opts = ["RL.PPO.use_linear_lr_decay", "True", "NUM_UPDATES", "7"]
    path = "configs/semantic_audionav/savi/savi.yaml"
    got = dataclasses.asdict(ppo.ppo_config_from(get_config(path, opts=opts)))
    assert got == dataclasses.asdict(jax_ppo_config_from(jax_get_config(path, opts=opts)))
    assert got["lr_decay_steps"] == 7 * 4 * 2


@pytest.fixture(scope="module")
def problem():
    """A towers-free SMT policy (audio CNN, action embedding, SMT, heads),
    its Flax parameters carried into the port, and one rollout batch."""
    rng = np.random.RandomState(1)
    jpolicy = JaxPolicy(net=JaxNet(spectrogram_hw=(9, 6), d_model=32, nhead=2, use_rgb=False, use_depth=False))
    f = jpolicy.net.feature_size
    obs = {
        "spectrogram": rng.randn(T, B, 9, 6, 2).astype(np.float32),
        "pose": rng.randn(T, B, 4).astype(np.float32),
        "category_belief": rng.rand(T, B, 21).astype(np.float32),
        "location_belief": rng.randn(T, B, 2).astype(np.float32),
        "__prev_action": rng.randint(0, 4, (T, B)).astype(np.int32),
        "__feature": rng.randn(T, B, f).astype(np.float32),
    }
    masks = (rng.rand(T, B) > 0.25).astype(np.float32)
    actions = rng.randint(0, 4, (T, B)).astype(np.int32)
    jmem = _random_initial_memory(rng, B, M, f, (2, 0, 5, 1))
    obs0 = {k: v[0] for k, v in obs.items()}
    params = filled_params(rng, jax.eval_shape(lambda: jpolicy.init(
        jax.random.key(0), {k: v for k, v in obs0.items() if not k.startswith("__")}, obs0["__prev_action"],
        jmem.features, jmem.valid, actions[0], method=JaxPolicy.evaluate_step)))
    rest = dict(
        log_probs=(np.log(0.25) + 0.3 * rng.randn(T, B)).astype(np.float32),
        values=rng.randn(T, B).astype(np.float32),
        returns=rng.randn(T, B).astype(np.float32),
        advantages=rng.randn(T, B).astype(np.float32),
    )
    jbatch = JaxBatch(obs={k: jnp.asarray(v) for k, v in obs.items()}, actions=jnp.asarray(actions),
                      log_probs=jnp.asarray(rest["log_probs"]), values=jnp.asarray(rest["values"]),
                      rewards=None, masks=jnp.asarray(masks), dones=None, metrics={},
                      initial_hidden=jmem, bootstrap_value=None)

    tpolicy = SMTPolicy(AudioNavSMTNet(spectrogram_hw=(9, 6), d_model=32, nhead=2, use_rgb=False, use_depth=False))
    load_flax_params(tpolicy, jax.tree.map(np.asarray, params))
    tmem = SMTMemory(*(torch.tensor(np.asarray(x)) for x in jmem))
    tmem = tmem._replace(idx=tmem.idx.long())
    tbatch = RolloutBatch(obs={k: torch.tensor(v) for k, v in obs.items()}, actions=torch.tensor(actions),
                          log_probs=torch.tensor(rest["log_probs"]), values=torch.tensor(rest["values"]),
                          rewards=None, masks=torch.tensor(masks), dones=None, metrics={},
                          initial_hidden=tmem, bootstrap_value=None)

    def jax_eval(frozen):
        method = JaxPolicy.evaluate_step_frozen if frozen else JaxPolicy.evaluate_step

        def evaluate(p, o, h0, mk, a):
            def step(o_, pa, mf, mv, a_):
                return jpolicy.apply(p, o_, pa, mf, mv, a_, method=method)
            return jax_batched_eval(step, o, h0, mk, a, chunk=CHUNK)
        return evaluate

    def torch_eval(frozen):
        step = tpolicy.evaluate_step_frozen if frozen else tpolicy.evaluate_step
        return lambda o, h0, mk, a: evaluate_sequence_smt_batched(step, o, h0, mk, a, chunk=CHUNK)

    return params, jbatch, jax_eval, tpolicy, tbatch, torch_eval, rest


def _run_jit(fn, *args):
    """fn(*args) compiled without LLVM's expensive passes: the same numbers
    here, in about half the compile time of the two updates' gradients."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_llvm_disable_expensive_passes": True})(*args)


def _torch_state(tpolicy):
    return {n: p.detach().clone() for n, p in tpolicy.named_parameters()}


def _compare_params(jparams, tpolicy, atol):
    own = dict(tpolicy.named_parameters())
    for path, value in _flatten(jax.tree.map(np.asarray, jparams)["params"]).items():
        name, want = convert_leaf(path, value)
        np.testing.assert_allclose(own[name].detach().numpy(), want, atol=atol, rtol=0, err_msg=name)


def test_ppo_loss_and_gradients_match_jax(problem):
    params, jbatch, jax_eval, tpolicy, tbatch, torch_eval, rest = problem
    r = {k: jnp.asarray(v) for k, v in rest.items()}
    (jloss, jaux), jgrads = _run_jit(jax.value_and_grad(
        lambda p: jppo.ppo_loss(p, jax_eval(False), jbatch.obs, jbatch.actions, jbatch.log_probs, jbatch.initial_hidden,
                                jbatch.masks, r["returns"], r["advantages"], jbatch.values, CFG),
        has_aux=True), params)

    tpolicy.zero_grad(set_to_none=True)
    tr = {k: torch.tensor(v) for k, v in rest.items()}
    loss, aux = ppo.ppo_loss(torch_eval(False), tbatch.obs, tbatch.actions, tbatch.log_probs, tbatch.initial_hidden,
                             tbatch.masks, tr["returns"], tr["advantages"], tbatch.values, CFG)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=0)
    for k in jaux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), atol=1e-5, rtol=0, err_msg=k)
    own = dict(tpolicy.named_parameters())
    live = 0
    for path, value in _flatten(jax.tree.map(np.asarray, jgrads)["params"]).items():
        name, want = convert_leaf(path, value)
        p = own[name]
        got = p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape), np.float32)
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3, err_msg=name)
        live += int(np.abs(want).max() > 0)
    assert live > 20  # the audio CNN, action embedding, SMT and heads all learn here
    tpolicy.zero_grad(set_to_none=True)


def test_ppo_update_matches_jax_with_its_permutations(problem):
    """Through the frozen-encoder re-evaluation, as savi.yaml trains."""
    params, jbatch, jax_eval, tpolicy, tbatch, torch_eval, rest = problem
    key = jax.random.key(3)
    perms, k = [], key
    for _ in range(CFG.ppo_epoch):  # as ppo_update draws them
        k, sub = jax.random.split(k)
        perms.append(np.array(jax.random.permutation(sub, B)))
    optimizer = jppo.make_optimizer(CFG)
    adv, ret = jnp.asarray(rest["advantages"]), jnp.asarray(rest["returns"])
    jparams, jopt, jstats = _run_jit(lambda p: jppo.ppo_update(
        p, optimizer.init(p), jbatch, adv, ret, key, jax_eval(True), optimizer, CFG), params)

    start = _torch_state(tpolicy)
    try:
        topt = ppo.make_optimizer(tpolicy.parameters(), ppo.PPOConfig(**dataclasses.asdict(CFG)))
        stats = ppo.ppo_update(tbatch, torch.tensor(rest["advantages"]), torch.tensor(rest["returns"]),
                               torch_eval(True), topt, topt.config, perms=perms)
        for k_ in jstats:
            np.testing.assert_allclose(stats[k_].item(), float(jstats[k_]), atol=1e-5, rtol=0, err_msg=k_)
        steps = CFG.ppo_epoch * min(CFG.num_mini_batch, B)
        assert topt.count == steps
        live = 0
        for name, got, want in _pairs(adam_gradients(tpolicy, topt.adam), _adam_gradients(jopt)):
            np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3, err_msg=f"gradient {name}")
            live += int(np.abs(want).max() > 1e-3)
        assert live > 20
        _compare_params(jparams, tpolicy, 1e-5)
        moved = {n.split(".")[1] for n, p in tpolicy.named_parameters() if not torch.equal(p, start[n])}
        assert moved == {"smt", "Dense_0"}, moved  # the SMT and the heads; no tower
    finally:
        with torch.no_grad():
            for n, p in tpolicy.named_parameters():
                p.copy_(start[n])


def test_sequential_replay_matches_jax(problem):
    """The port's one-step-at-a-time ring replay against JAX's, through the
    recomputing step (the towers run on the stored observations)."""
    params, jbatch, _, tpolicy, tbatch, _, _ = problem
    jpolicy = JaxPolicy(net=JaxNet(spectrogram_hw=(9, 6), d_model=32, nhead=2, use_rgb=False, use_depth=False))

    def jstep(o, pa, mf, mv, a):
        return jpolicy.apply(params, o, pa, mf, mv, a, method=JaxPolicy.evaluate_step)

    want = _run_jit(lambda b: jax_sequential_eval(jstep, b.obs, b.initial_hidden, b.masks, b.actions), jbatch)
    with torch.no_grad():
        got = evaluate_sequence_smt(tpolicy.evaluate_step, tbatch.obs, tbatch.initial_hidden, tbatch.masks,
                                    tbatch.actions)
    for g, w, name in zip(got, want, ("values", "log_probs", "entropy", "logits")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0, err_msg=name)


def _optax_run(cfg, grads_seq, params0):
    opt = jppo.make_optimizer(cfg)
    p = {k: jnp.asarray(v) for k, v in params0.items()}
    state = opt.init(p)
    for g in grads_seq:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, upd)
    return {k: np.asarray(v) for k, v in p.items()}


def _torch_run(cfg, grads_seq, params0):
    ps = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params0.items()}
    opt = ppo.make_optimizer(ps.values(), ppo.PPOConfig(**dataclasses.asdict(cfg)))
    lrs, norms = [], []
    for g in grads_seq:
        opt.zero_grad()
        for k, p in ps.items():
            p.grad = torch.tensor(g[k])
        lrs.append(opt.lr())
        norms.append(opt.step().item())
    return {k: p.detach().numpy() for k, p in ps.items()}, lrs, norms


@pytest.mark.parametrize("scale", [0.01, 10.0])  # global norm below and above max_grad_norm 0.5
def test_optimizer_clips_as_optax(scale):
    rng = np.random.RandomState(4)
    params0 = {"a": rng.randn(7, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (scale * rng.randn(*v.shape) / 4).astype(np.float32) for k, v in params0.items()} for _ in range(4)]
    cfg = jppo.PPOConfig(lr=1e-2, eps=1e-5, max_grad_norm=0.5)
    want = _optax_run(cfg, grads, params0)
    got, _, norms = _torch_run(cfg, grads, params0)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)
    assert all((n < 0.5) == (scale < 1) for n in norms)
    # just above the norm the optax form scales to max_norm exactly, where
    # clip_grad_norm_'s max/(‖g‖ + 1e-6) would leave it 2e-6 short
    g = torch.full((4,), 0.25 + 1e-3)
    ppo.clip_by_global_norm_([g], 0.5)
    np.testing.assert_allclose(torch.linalg.vector_norm(g).item(), 0.5, rtol=1e-7)


def test_linear_lr_decay_per_optimizer_step():
    rng = np.random.RandomState(5)
    params0 = {"w": rng.randn(6).astype(np.float32)}
    grads = [{"w": (0.1 * rng.randn(6)).astype(np.float32)} for _ in range(7)]
    cfg = jppo.PPOConfig(lr=1e-2, eps=1e-5, use_linear_lr_decay=True, lr_decay_steps=4)
    want = _optax_run(cfg, grads, params0)
    got, lrs, _ = _torch_run(cfg, grads, params0)
    sched = optax.linear_schedule(cfg.lr, 0.0, cfg.lr_decay_steps)
    np.testing.assert_allclose(lrs, [float(sched(i)) for i in range(7)], atol=1e-9, rtol=0)
    assert lrs[0] == cfg.lr and lrs[4:] == [0.0, 0.0, 0.0]  # the count before the step
    np.testing.assert_allclose(got["w"], want["w"], atol=1e-6, rtol=0)
