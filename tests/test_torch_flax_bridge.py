"""``to_flax_params`` gives the JAX package's parameter trees, and a
checkpoint the JAX package wrote carries into the port: on a tiny savi.yaml
config the port's SMT policy and belief predictor, as Flax trees, have
exactly the paths and shapes of the JAX ``init`` trees;
``load_flax_params(to_flax_params(m))`` is the identity; and
``SaviTrainer._setup`` with ``pretrained_path`` (and the belief
predictor's) pointing to JAX-written checkpoints holds JAX's parameters
exactly, so that its act logits and values are within 2e-5 of JAX's on the
same observations and memory."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avlen_tpu.rl.trainers  # noqa: F401  (registers the JAX trainers)
from avlen_tpu.config import get_config as jax_get_config
from avlen_tpu.core.registry import registry
from avlen_tpu.models.smt_policy import SMTPolicy as JaxSMTPolicy
from avlen_tpu.utils import checkpoint as jckpt
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
from avlen_tpu_torch.utils.flax_bridge import _flatten, load_flax_params, to_flax_params, torch_arrays
from tests.test_torch_slice import OPTS, SAVI, _traced_init

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The JAX trainer (parameters filled from a seed) and the port's,
    set up from JAX-written checkpoints of its policy and belief predictor."""
    jtr = registry.get_trainer("savi")(jax_get_config(SAVI, opts=OPTS))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _traced_init(nn.Module.init, seed=3))
        jtr._setup()
    d = tmp_path_factory.mktemp("jax_ckpts")
    policy = jckpt.save_checkpoint(str(d), "ckpt.0.pth", {
        "state_dict": jtr.params, "config": jtr.config.to_dict(), "extra_state": {"step": 0}})
    belief = jckpt.save_checkpoint(str(d), "belief.pth", {"state_dict": jtr.belief_params})
    ttr = SaviTrainer(get_config(SAVI, opts=OPTS + [
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.pretrained_path", policy,
        "RL.PPO.BELIEF_PREDICTOR.pretrained_path", belief]), device="cpu")
    ttr._setup()
    return jtr, ttr


def _shapes(tree):
    return {k: np.shape(v) for k, v in _flatten(jax.tree.map(np.asarray, tree)).items()}


def test_to_flax_params_has_the_jax_paths_and_shapes(trainers):
    jtr, ttr = trainers
    for module, jparams in ((ttr.policy, jtr.params), (ttr.belief_net, jtr.belief_params)):
        tree = to_flax_params(module)
        assert list(tree) == ["params"]
        assert _shapes(tree) == _shapes(jparams)
        assert all(v.dtype == np.float32 for v in _flatten(tree).values())


def test_load_of_to_flax_params_is_the_identity(trainers):
    _, ttr = trainers
    for module in (ttr.policy, ttr.belief_net):
        before = {n: p.detach().clone() for n, p in module.named_parameters()}
        with torch.no_grad():
            for p in module.parameters():
                p.zero_()
        load_flax_params(module, to_flax_params(module, before))
        for n, p in module.named_parameters():
            assert torch.equal(p, before[n]), n


def test_setup_from_jax_checkpoints_acts_as_jax(trainers):
    jtr, ttr = trainers
    assert ttr.pretrained_counts == (len(jax.tree.leaves(jtr.params)), 0)
    for module, jparams in ((ttr.policy, jtr.params), (ttr.belief_net, jtr.belief_params)):
        own = dict(module.named_parameters())
        for name, want in torch_arrays(jax.tree.map(np.asarray, jparams)).items():
            np.testing.assert_array_equal(own[name].detach().numpy(), want, err_msg=name)

    # JAX's first observations, a ring memory half full of features
    b, m, f = jtr.carry.memory.features.shape
    rng = np.random.RandomState(0)
    feats = rng.normal(0, 1, (b, m, f)).astype(np.float32)
    valid = (np.arange(m)[None, :] < m // 2).repeat(b, 0).astype(np.float32)
    obs = {k: np.asarray(v) for k, v in jtr.carry.obs.items()}
    obs["category_belief"] = rng.dirichlet(np.ones(21), b).astype(np.float32)
    obs["location_belief"] = rng.normal(0, 2, (b, 2)).astype(np.float32)
    prev_a = np.array([1, 2, 3][:b], np.int32)

    act = jax.jit(lambda p, o, pa, mf, mv: jtr.policy.apply(
        p, o, pa, mf, mv, jax.random.key(0), True, method=JaxSMTPolicy.act))
    _, _, jvalue, _, jlogits = act(jtr.params, {k: jnp.asarray(v) for k, v in obs.items()},
                                   jnp.asarray(prev_a), jnp.asarray(feats), jnp.asarray(valid))
    with torch.no_grad():
        _, _, value, _, logits = ttr.policy.act(
            {k: torch.tensor(v) for k, v in obs.items()}, torch.tensor(prev_a).long(),
            torch.tensor(feats), torch.tensor(valid), deterministic=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=2e-5, rtol=0)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), atol=2e-5, rtol=0)
