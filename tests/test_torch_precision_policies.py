"""TPU.PRECISION bfloat16 in the SMT policies against the JAX package on the
CPU, JAX's SMT fused (``smt_fused=True``: its Pallas kernel in interpret
mode, as tests/test_pallas_smt.py runs it), as the port's SMT is always the
kernel, whose CPU path is its float32 plain version: π_g (``SMTPolicy``),
π_q (``OptionPolicy``) and π_l (``DialogPolicy`` with CLIP and the dialog
state encoder) at d_model 32 act on the same observations and memory, and
one PPO loss of π_g runs through ``evaluate_sequence_smt_batched`` with the
ring views' pool cast to bfloat16. Logits, values, the loss and every
parameter's gradient within ``2*d + 1e-3*peak`` of JAX's bfloat16 (``d``
JAX's own bfloat16-float32 distance on the same inputs; the gradients 1e-6
more, for the key biases whose exact gradient is zero and whose computed
one is rounding noise in both packages); the gradients stay float32."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from avlen_tpu.models.dialog_policy import AudioNavDialogNet as JaxDialogNet
from avlen_tpu.models.dialog_policy import DialogPolicy as JaxDialogPolicy
from avlen_tpu.models.memory import SMTMemory as JaxSMTMemory
from avlen_tpu.models.option_policy import AudioNavOptionNet as JaxOptionNet
from avlen_tpu.models.option_policy import OptionPolicy as JaxOptionPolicy
from avlen_tpu.models.smt_policy import AudioNavSMTNet as JaxSMTNet
from avlen_tpu.models.smt_policy import SMTPolicy as JaxSMTPolicy
from avlen_tpu.rl.ppo import PPOConfig as JaxPPOConfig
from avlen_tpu.rl.ppo import ppo_loss as jax_ppo_loss
from avlen_tpu.rl.rollout_smt import evaluate_sequence_smt_batched as jax_batched
from avlen_tpu_torch.models.dialog_policy import AudioNavDialogNet, DialogPolicy
from avlen_tpu_torch.models.memory import SMTMemory
from avlen_tpu_torch.models.option_policy import AudioNavOptionNet, OptionPolicy
from avlen_tpu_torch.models.smt_policy import AudioNavSMTNet, SMTPolicy
from avlen_tpu_torch.rl.ppo import PPOConfig, ppo_loss
from avlen_tpu_torch.rl.rollout_smt import evaluate_sequence_smt_batched
from avlen_tpu_torch.utils.flax_bridge import _flatten, convert_leaf
from tests.test_torch_precision import check_values, compiled, flax_params

torch.set_num_threads(1)

B, M, D, H = 3, 6, 32, 4
SPEC_HW = (65, 13)
COMMON = dict(spectrogram_hw=SPEC_HW, num_actions=4, d_model=D, nhead=H, use_rgb=False, use_depth=True)


def _obs(rng, lead=(B,)):
    return {
        "depth": rng.rand(*lead, 16, 16, 1).astype(np.float32),
        "spectrogram": rng.rand(*lead, *SPEC_HW, 2).astype(np.float32),
        "pose": np.concatenate([rng.randn(*lead, 3), rng.randint(0, 9, lead + (1,))], -1).astype(np.float32),
        "category_belief": rng.dirichlet(np.ones(21), lead).astype(np.float32),
        "location_belief": rng.randn(*lead, 2).astype(np.float32),
    }


def _t(x):
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return torch.as_tensor(np.array(x))


def _pair(port_cls, port_net, jax_cls, jax_net, **kw):
    """(port policy at bf16 with the float32 init's weights, its f32 twin,
    JAX's policy at bf16 and at float32, both with the SMT fused)."""
    t32 = port_cls(port_net(generator=torch.Generator().manual_seed(0), **COMMON, **kw),
                   generator=torch.Generator().manual_seed(1))
    tlow = port_cls(port_net(generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16, **COMMON, **kw),
                    generator=torch.Generator().manual_seed(1))
    tlow.load_state_dict(t32.state_dict())
    jnets = [jax_cls(net=jax_net(dtype=dt, smt_fused=True, **COMMON, **kw)) for dt in (jnp.bfloat16, jnp.float32)]
    return tlow, t32, jnets


def _check_act(tlow, jlow, j32, params, args, picks):
    key = jax.random.key(0)
    want = [compiled(lambda p, *a: j.apply(p, *a, key, True, method="act"), params, *args) for j in (jlow, j32)]
    with torch.no_grad():
        got = tlow.act(*[_t(a) for a in args], deterministic=True)
    check_values([got[i] for i in picks], [want[0][i] for i in picks], [want[1][i] for i in picks])
    assert all(got[i].dtype == torch.float32 for i in picks)


def test_smt_policy_act_matches_fused_jax():
    rng = np.random.RandomState(0)
    tlow, t32, (jlow, j32) = _pair(SMTPolicy, AudioNavSMTNet, JaxSMTPolicy, JaxSMTNet)
    f = t32.net.feature_size
    args = (_obs(rng), np.array([0, 2, 3], np.int32), rng.randn(B, M, f).astype(np.float32),
            (rng.rand(B, M) > 0.3).astype(np.float32))
    params = flax_params(t32, j32, *args, jax.random.key(0), method="act")
    _check_act(tlow, jlow, j32, params, args, picks=(2, 3, 4))  # value, features, logits


def test_option_and_dialog_policies_act_match_fused_jax():
    rng = np.random.RandomState(1)
    tlow, t32, (jlow, j32) = _pair(OptionPolicy, AudioNavOptionNet, JaxOptionPolicy, JaxOptionNet,
                                   query_count_emb_size=8)
    f = t32.net.feature_size
    args = (_obs(rng), np.array([1, 0, 2], np.int32), rng.randn(B, M, f).astype(np.float32),
            (rng.rand(B, M) > 0.3).astype(np.float32), rng.randn(B, 8).astype(np.float32),
            rng.randn(B, 8).astype(np.float32))
    params = flax_params(t32, j32, *args, jax.random.key(0), method="act")
    _check_act(tlow, jlow, j32, params, args, picks=(2, 3, 4, 5))  # value, x_mem, logits, uncertainty

    tlow, t32, (jlow, j32) = _pair(DialogPolicy, AudioNavDialogNet, JaxDialogPolicy, JaxDialogNet,
                                   clip_width=D, clip_layers=2)
    f = t32.net.feature_size
    tokens = rng.randint(1, 1000, (B, 77)).astype(np.int32)
    tokens[:, 0], tokens[np.arange(B), [4, 8, 12]] = 49406, 49407
    args = (_obs(rng), np.array([3, 1, 0], np.int32), rng.randn(B, 4, f).astype(np.float32),
            (rng.rand(B, 4) > 0.3).astype(np.float32), rng.randn(B, 2, D).astype(np.float32),
            np.array([[1, 0], [0, 0], [1, 1]], np.float32), tokens, np.array([0, 1, 2], np.int32))
    params = flax_params(t32, j32, *args, jax.random.key(0), method="act")
    _check_act(tlow, jlow, j32, params, args, picks=(2, 3, 4, 5))  # value, features, x_att, logits


def test_ppo_loss_and_gradients_through_the_bf16_pool_match_jax():
    """π_g's PPO loss over a 6-step rollout of 3 envs, re-evaluated by the
    frozen-encoder step through the batched ring views (chunk 3) with the
    pool cast to bfloat16: loss and gradients against JAX's."""
    rng = np.random.RandomState(2)
    tlow, t32, (jlow, j32) = _pair(SMTPolicy, AudioNavSMTNet, JaxSMTPolicy, JaxSMTNet)
    t_len, f = 6, t32.net.feature_size
    obs = _obs(rng, (t_len, B))
    obs["__prev_action"] = rng.randint(0, 4, (t_len, B)).astype(np.int32)
    obs["__feature"] = rng.randn(t_len, B, f).astype(np.float32)
    masks = (rng.rand(t_len, B) > 0.2).astype(np.float32)
    mem0 = (rng.randn(B, M, f).astype(np.float32), (rng.rand(B, M) > 0.5).astype(np.float32),
            np.array([1, 4, 0], np.int32))
    actions = rng.randint(0, 4, (t_len, B)).astype(np.int32)
    old_lp, old_v, ret, adv = (rng.randn(t_len, B).astype(np.float32) * s for s in (0.5, 1.0, 1.0, 1.0))
    old_lp = old_lp - 1.4
    params = flax_params(t32, j32, {k: v[0] for k, v in obs.items() if not k.startswith("__")},
                         obs["__prev_action"][0], mem0[0], mem0[1], jax.random.key(0), method="act")

    def jax_loss_and_grads(jmod):
        def evaluate(p, o, m, ms, a):
            def step(o_, pa, mf, mv, a_):
                return jmod.apply(p, o_, pa, mf, mv, a_, method="evaluate_step_frozen")

            return jax_batched(step, o, JaxSMTMemory(*m), ms, a, chunk=3, compute_dtype=jnp.bfloat16)

        def loss(p):
            return jax_ppo_loss(p, evaluate, obs, actions, old_lp, mem0, masks, ret, adv, old_v, JaxPPOConfig())[0]

        return compiled(jax.value_and_grad(loss), params)

    (l_low, g_low), (l_32, g_32) = jax_loss_and_grads(jlow), jax_loss_and_grads(j32)
    mem = SMTMemory(*[torch.as_tensor(x) for x in mem0])

    def evaluate(o, m, ms, a):
        return evaluate_sequence_smt_batched(tlow.evaluate_step_frozen, o, m, ms, a, chunk=3,
                                             compute_dtype=torch.bfloat16)

    loss, _ = ppo_loss(evaluate, _t(obs), _t(actions).long(), _t(old_lp), mem, _t(masks), _t(ret), _t(adv),
                       _t(old_v), PPOConfig())
    loss.backward()
    check_values([loss], [l_low], [l_32])
    grads = {n: p.grad for n, p in tlow.named_parameters() if p.grad is not None}
    assert grads and all(g.dtype == torch.float32 for g in grads.values())
    low, f32 = (_flatten(jax.tree.map(np.asarray, g["params"])) for g in (g_low, g_32))
    checked = 0
    for path, want in low.items():
        name, want = convert_leaf(path, want)
        _, ref = convert_leaf(path, f32[path])
        got = grads.get(name, torch.zeros(want.shape))  # the decoder's unread q/k: zero in both
        try:
            # + 1e-6: a key bias's exact gradient is zero (it shifts all of
            # a query's logits alike), so both packages hold rounding noise
            check_values([got], [want], [ref], floor=1e-6)
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}")
        checked += 1
    assert checked >= len(grads)
