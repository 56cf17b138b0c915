"""The port's DD-PPO layer (``avlen_tpu_torch/parallel/``) against the JAX
package's (``avlen_tpu/parallel/``) on the CPU, the port on 2 gloo ranks
(``tests/torch_dist.py``), JAX on the conftest's virtual CPU devices:

(a) ``infer_env_specs`` gives JAX's PartitionSpecs (env axis 0, 1 or
    replicated) on one tree of env-leading, time-major, scalar and key
    leaves;
    ``shard_pytree`` keeps on rank r what JAX's ``shard_pytree`` places on
    device r;
(b) ``make_mesh``'s arithmetic over 8 ranks equals JAX's ``make_mesh`` over
    8 devices for the shapes [-1], [2], [4] and [2, -1];
(c) the all-reduced mean of per-rank gradients equals the full-batch
    gradient and JAX's ``shard_map`` + ``pmean`` on a 2-device mesh (JAX's
    ``test_pmean_grads_equal_hand_averaged``), within 1e-6;
(d) one ``ppo_update`` of the GRU (AV-Nav) stack over 2 ranks with
    ``grad_reduce`` against JAX's ``ppo_update`` under ``shard_map`` with
    ``pmean`` on 2 devices, from the port's parameters, on the same batch
    with each shard's JAX permutations: parameters and losses within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from avlen_tpu.models.policy import Policy as JaxPolicy
from avlen_tpu.models.policy import AudioNavBaselineNet as JaxNet
from avlen_tpu.parallel.ddppo import infer_env_specs as jax_infer_env_specs
from avlen_tpu.parallel.ddppo import shard_pytree as jax_shard_pytree
from avlen_tpu.parallel.mesh import make_mesh as jax_make_mesh
from avlen_tpu.rl import gae as jgae
from avlen_tpu.rl import ppo as jppo
from avlen_tpu.rl.rollout import RolloutBatch as JaxBatch
from avlen_tpu_torch.models.policy import AudioNavBaselineNet, Policy
from avlen_tpu_torch.parallel import infer_env_specs, make_mesh, shard_pytree
from avlen_tpu_torch.utils.flax_bridge import to_flax_params
from tests import torch_dist

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def _axis(spec):
    """A JAX PartitionSpec as the port writes it: the env axis or None."""
    axes = [i for i, a in enumerate(tuple(spec)) if a is not None]
    return axes[0] if axes else None


def test_infer_env_specs_matches_jax():
    b, t = 8, 4
    shapes = {"state": (b, 3), "traj": (t, b, 2), "scalar": (), "memory": (b, 5, 7), "time": (t, 3),
              "nested": {"obs": (t, b), "hidden": (b,)}}

    def build(make, key):
        def go(x):
            return {k: go(v) for k, v in x.items()} if isinstance(x, dict) else make(x)

        return {**go(shapes), "key": key}

    jtree = build(jnp.zeros, jax.random.key(0))
    ttree = build(torch.zeros, torch.Generator().manual_seed(0))
    for steps in (None, t):
        want = jax.tree.map(_axis, jax_infer_env_specs(jtree, b, num_steps=steps),
                            is_leaf=lambda x: isinstance(x, P))
        assert infer_env_specs(ttree, b, num_steps=steps) == want
    assert infer_env_specs(ttree, b, num_steps=t)["traj"] == 1
    assert infer_env_specs(ttree, b)["traj"] is None and infer_env_specs(ttree, b)["key"] is None


def test_shard_pytree_keeps_what_jax_places_on_each_device():
    b, t = 8, 3
    rng = np.random.RandomState(2)
    tree = {"state": rng.randn(b, 3).astype(np.float32), "traj": rng.randn(t, b, 2).astype(np.float32),
            "scalar": np.float32(1.5), "table": rng.randn(5, 4).astype(np.float32)}
    mesh = jax_make_mesh(("data",), (2,), jax.devices()[:2])
    placed = jax_shard_pytree(jax.tree.map(jnp.asarray, tree), jax_infer_env_specs(tree, b, num_steps=t), mesh)
    specs = infer_env_specs(tree, b, num_steps=t)
    for r in range(2):
        local = shard_pytree({k: torch.as_tensor(v) for k, v in tree.items()}, specs,
                             make_mesh(world_size=2, rank=r))
        for k, leaf in placed.items():
            shard = next(s for s in leaf.addressable_shards if s.device == jax.devices()[r])
            np.testing.assert_array_equal(np.asarray(local[k]), np.asarray(shard.data), err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("axes,shape", [(("data",), [-1]), (("data",), [2]), (("data",), [4]),
                                        (("data", "model"), [2, -1])])
def test_make_mesh_matches_jax(axes, shape):
    want = jax_make_mesh(axes, shape, jax.devices()[:8])
    got = make_mesh(axes, shape, world_size=8, rank=0)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == tuple(want.devices.shape)
    assert [d.id for d in want.devices.flat] == list(range(got.size))  # the first prod(shape) ranks
    assert {a: got.axis_size(a) for a in axes} == dict(want.shape)


def test_all_reduced_grads_equal_full_batch_and_jax_pmean(tmp_path):
    b, d = 8, 5
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(d, 3).astype(np.float32), "b": np.zeros((3,), np.float32)}
    obs = rng.randn(b, d).astype(np.float32)
    actions = rng.randint(0, 3, size=(b,)).astype(np.int32)
    adv = rng.randn(b).astype(np.float32)
    ranks = torch_dist.run_ranks(torch_dist.grads_rank, 2, tmp_path, params, obs, actions, adv)

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    lp = torch.log_softmax(torch.as_tensor(obs) @ tp["w"] + tp["b"], -1)[torch.arange(b), torch.as_tensor(actions).long()]
    (-(lp * torch.as_tensor(adv)).mean()).backward()

    def loss_fn(p, o, a, ad):
        lp = jax.nn.log_softmax(o @ p["w"] + p["b"])[jnp.arange(o.shape[0]), a]
        return -(lp * ad).mean()

    mesh = jax_make_mesh(("data",), (2,), jax.devices()[:2])
    reduced = jax.jit(jax.shard_map(
        lambda p, o, a, ad: jax.tree.map(lambda g: jax.lax.pmean(g, "data"), jax.grad(loss_fn)(p, o, a, ad)),
        mesh=mesh, in_specs=(P(), P("data"), P("data"), P("data")), out_specs=P(), check_vma=False,
    ))(jax.tree.map(jnp.asarray, params), jnp.asarray(obs), jnp.asarray(actions), jnp.asarray(adv))
    for k in params:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
        np.testing.assert_allclose(ranks[0][k], tp[k].grad.numpy(), rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(ranks[0][k], np.asarray(reduced[k]), rtol=1e-6, atol=1e-6, err_msg=k)


def test_gru_ppo_update_over_two_ranks_matches_jax_shard_map(tmp_path):
    t, b, h, hw = 6, 4, 32, (65, 26)
    rng = np.random.RandomState(3)
    net_kwargs = dict(hidden_size=h, spectrogram_hw=hw, visual_hw=None, use_depth=False)
    policy = Policy(AudioNavBaselineNet(**net_kwargs, generator=torch.Generator().manual_seed(5)), 4,
                    generator=torch.Generator().manual_seed(6))
    flax_params = to_flax_params(policy)
    batch = {
        "obs": {"spectrogram": rng.rand(t, b, *hw, 2).astype(np.float32)},
        "actions": rng.randint(0, 4, (t, b)).astype(np.int32),
        "log_probs": np.log(rng.uniform(0.1, 0.5, (t, b))).astype(np.float32),
        "values": rng.randn(t, b).astype(np.float32),
        "rewards": rng.randn(t, b).astype(np.float32),
        "masks": (rng.rand(t, b) > 0.2).astype(np.float32),
        "dones": (rng.rand(t, b) > 0.8),
        "initial_hidden": rng.randn(b, h).astype(np.float32),
        "bootstrap_value": rng.randn(b).astype(np.float32),
    }
    ppo_kwargs = dict(ppo_epoch=2, num_mini_batch=2, lr=1e-3, entropy_coef=0.05, max_grad_norm=0.5,
                      use_normalized_advantage=True)
    cfg = jppo.PPOConfig(**ppo_kwargs)
    adv, ret = jgae.compute_gae(jnp.asarray(batch["rewards"]), jnp.asarray(batch["values"]),
                                jnp.asarray(batch["bootstrap_value"]),
                                1.0 - jnp.asarray(batch["dones"], jnp.float32), cfg.gamma, cfg.tau)
    batch["adv"], batch["ret"] = np.asarray(adv), np.asarray(ret)

    # each shard's key is fold_in(key, shard), as make_sharded_superstep folds
    # it; ppo_update splits it once an epoch and permutes the shard's slots
    key = jax.random.key(9)
    perms = []
    for r in range(2):
        k = jax.random.fold_in(key, r)
        mine = []
        for _ in range(cfg.ppo_epoch):
            k, sub = jax.random.split(k)
            mine.append(np.asarray(jax.random.permutation(sub, b // 2)))
        perms.append(mine)
    ranks = torch_dist.run_ranks(torch_dist.gru_ppo_rank, 2, tmp_path, flax_params, net_kwargs,
                                 batch, perms, ppo_kwargs)

    jpol = JaxPolicy(net=JaxNet(hidden_size=h, spectrogram_hw=hw, use_depth=False), num_actions=4)
    optimizer = jppo.make_optimizer(cfg)
    params = jax.tree.map(jnp.asarray, flax_params)

    def shard_update(params, batch, adv, ret, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))

        def evaluate_actions(p, obs, h0, masks, actions):
            return jpol.apply(p, obs, h0, masks, actions, method=JaxPolicy.evaluate_actions)

        params, _, stats = jppo.ppo_update(params, optimizer.init(params), batch, adv, ret, key, evaluate_actions,
                                           optimizer, cfg, grad_reduce=lambda g: jax.lax.pmean(g, "data"))
        return params, jax.tree.map(lambda v: jax.lax.pmean(v, "data"), stats)

    jbatch = JaxBatch(obs={k: jnp.asarray(v) for k, v in batch["obs"].items()},
                      actions=jnp.asarray(batch["actions"]), log_probs=jnp.asarray(batch["log_probs"]),
                      values=jnp.asarray(batch["values"]), rewards=jnp.asarray(batch["rewards"]),
                      masks=jnp.asarray(batch["masks"]), dones=jnp.asarray(batch["dones"]), metrics={},
                      initial_hidden=jnp.asarray(batch["initial_hidden"]),
                      bootstrap_value=jnp.asarray(batch["bootstrap_value"]))
    spec = JaxBatch(obs={"spectrogram": P(None, "data")}, actions=P(None, "data"), log_probs=P(None, "data"),
                    values=P(None, "data"), rewards=P(None, "data"), masks=P(None, "data"), dones=P(None, "data"),
                    metrics={}, initial_hidden=P("data"), bootstrap_value=P("data"))
    mesh = jax_make_mesh(("data",), (2,), jax.devices()[:2])
    want_params, want_stats = jax.jit(jax.shard_map(
        shard_update, mesh=mesh, in_specs=(P(), spec, P(None, "data"), P(None, "data"), P()),
        out_specs=(P(), P()), check_vma=False,
    ))(params, jbatch, adv, ret, key)
    want_params = jax.tree.map(np.asarray, jax.block_until_ready(want_params))

    from avlen_tpu_torch.utils.flax_bridge import _flatten

    got0, got1 = (_flatten(r[0]) for r in ranks)
    want = _flatten(want_params)
    assert sorted(got0) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got0[k], got1[k], err_msg=k)
        np.testing.assert_allclose(got0[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    assert any(np.abs(want[k] - _flatten(flax_params)[k]).max() > 1e-4 for k in want)  # it trained
    for k, v in want_stats.items():
        np.testing.assert_allclose(ranks[0][1][k], float(v), rtol=0, atol=1e-5, err_msg=k)
        assert ranks[0][1][k] == ranks[1][1][k]
