"""The port's PPO re-evaluation (avlen_tpu_torch/rl/rollout_smt.py,
models/smt_policy.py) on the CPU: the ring replay's index map equals the JAX
package's exactly and rebuilds the sequential ring's views; batched
re-evaluation equals the sequential replay (outputs and gradients, 1e-5);
the frozen-encoder step equals the recompute when the stored features are
the towers' outputs, and no gradient reaches the towers; a chunk that does
not divide T falls to the largest divisor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlen_tpu.rl.rollout_smt import reconstruct_memory_views as jax_views
from avlen_tpu_torch.models.memory import SMTMemory, init_memory, insert, reset_where
from avlen_tpu_torch.models.smt_policy import AudioNavSMTNet, SMTPolicy
from avlen_tpu_torch.rl.rollout_smt import (
    evaluate_sequence_smt,
    evaluate_sequence_smt_batched,
    reconstruct_memory_views,
)

torch.set_num_threads(1)


def _initial_memory(rng, b, m, f, warm_steps):
    """A pre-rollout ring: env i has had warm_steps[i] inserts (wraps past m)."""
    mem = init_memory(b, m, f, device="cpu")
    for s in range(max(warm_steps)):
        new = insert(mem, torch.tensor(rng.randn(b, f).astype(np.float32)))
        write = torch.tensor([s < w for w in warm_steps])
        mem = SMTMemory(
            features=torch.where(write[:, None, None], new.features, mem.features),
            valid=torch.where(write[:, None], new.valid, mem.valid),
            idx=torch.where(write, new.idx, mem.idx),
        )
    return mem


@pytest.mark.parametrize("m,t_len,warm", [(4, 11, (0, 2, 4, 7)), (6, 13, (6, 1, 0, 3))])
def test_memory_views_equal_jax_and_the_sequential_ring(m, t_len, warm):
    rng = np.random.RandomState(0)
    b, f = len(warm), 5
    mem0 = _initial_memory(rng, b, m, f, warm)
    feats = torch.tensor(rng.randn(t_len, b, f).astype(np.float32))
    masks = torch.tensor((rng.rand(t_len, b) > 0.25).astype(np.float32))

    content_idx, valid = reconstruct_memory_views(mem0, feats, masks)
    jmem0 = type("Mem", (), {k: jnp.asarray(getattr(mem0, k).numpy()) for k in ("features", "valid", "idx")})
    jidx, jvalid = jax_views(jmem0, jnp.asarray(feats.numpy()), jnp.asarray(masks.numpy()))
    np.testing.assert_array_equal(content_idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))

    # the views the sequential replay saw at each step
    want_feats, want_valid, mem = [], [], mem0
    for t in range(t_len):
        mem = reset_where(mem, masks[t] == 0)
        want_feats.append(mem.features)
        want_valid.append(mem.valid)
        mem = insert(mem, feats[t])
    pool = torch.cat([feats, mem0.features.transpose(0, 1), torch.zeros(1, b, f)], dim=0)
    got = pool[content_idx, torch.arange(b)[None, :, None]]
    assert torch.equal(got, torch.stack(want_feats)) and torch.equal(valid, torch.stack(want_valid))


def _policy_and_rollout(seed, t_len=8, b=3, m=4, true_features=False):
    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    policy = SMTPolicy(AudioNavSMTNet(spectrogram_hw=(9, 6), d_model=32, nhead=2, use_rgb=False,
                                      use_depth=False, generator=gen), generator=gen)
    f = policy.net.feature_size
    obs = {
        "spectrogram": torch.tensor(rng.randn(t_len, b, 9, 6, 2).astype(np.float32)),
        "pose": torch.tensor(rng.randn(t_len, b, 4).astype(np.float32)),
        "category_belief": torch.tensor(rng.rand(t_len, b, 21).astype(np.float32)),
        "location_belief": torch.tensor(rng.randn(t_len, b, 2).astype(np.float32)),
        "__prev_action": torch.tensor(rng.randint(0, 4, (t_len, b))),
        "__feature": torch.tensor(rng.randn(t_len, b, f).astype(np.float32)),
    }
    if true_features:
        with torch.no_grad():
            flat = {k: v.reshape((t_len * b,) + v.shape[2:]) for k, v in obs.items() if not k.startswith("__")}
            obs["__feature"] = policy.net.get_features(flat, obs["__prev_action"].reshape(-1)).reshape(t_len, b, f)
    masks = torch.tensor((rng.rand(t_len, b) > 0.3).astype(np.float32))
    actions = torch.tensor(rng.randint(0, 4, (t_len, b)))
    mem0 = _initial_memory(rng, b, m, f, (2, 0, 5)[:b])
    return policy, obs, mem0, masks, actions


def _grads(policy, outs):
    policy.zero_grad(set_to_none=True)
    v, lp, ent, _ = outs
    ((v.sum() + lp.sum()) * 1e-2 + ent.mean()).backward()
    return {n: p.grad.clone() for n, p in policy.named_parameters() if p.grad is not None}


def test_batched_equals_sequential_replay():
    policy, obs, mem0, masks, actions = _policy_and_rollout(1, t_len=10)
    seq = evaluate_sequence_smt(policy.evaluate_step, obs, mem0, masks, actions)
    g_seq = _grads(policy, seq)
    bat = evaluate_sequence_smt_batched(policy.evaluate_step, obs, mem0, masks, actions, chunk=5)
    g_bat = _grads(policy, bat)
    for a, w in zip(bat, seq):
        np.testing.assert_allclose(a.detach().numpy(), w.detach().numpy(), atol=1e-5, rtol=0)
    assert g_bat.keys() == g_seq.keys() and len(g_seq) > 20
    for n in g_seq:
        np.testing.assert_allclose(g_bat[n].numpy(), g_seq[n].numpy(), atol=1e-5, rtol=1e-4, err_msg=n)


def test_frozen_equals_recompute_and_leaves_the_towers():
    policy, obs, mem0, masks, actions = _policy_and_rollout(7, true_features=True)
    rec = evaluate_sequence_smt_batched(policy.evaluate_step, obs, mem0, masks, actions, chunk=4)
    frz = evaluate_sequence_smt_batched(policy.evaluate_step_frozen, obs, mem0, masks, actions, chunk=4)
    for a, w in zip(frz, rec):
        np.testing.assert_allclose(a.detach().numpy(), w.detach().numpy(), atol=1e-5, rtol=0)
    grads = _grads(policy, frz)
    towers = ("net.goal_encoder.", "net.action_encoder.")
    assert any(n.startswith(towers) for n, _ in policy.named_parameters())
    assert not any(n.startswith(towers) for n in grads)  # no gradient reaches a tower
    assert any(n.startswith("net.smt.") for n in grads) and any(n.startswith("action_head.") for n in grads)


def test_chunk_not_dividing_t_takes_the_largest_divisor():
    policy, obs, mem0, masks, actions = _policy_and_rollout(3, t_len=9, b=2)
    rows = []
    step = policy.evaluate_step_frozen

    def counting_step(o, pa, mf, mv, a):
        rows.append(pa.shape[0])
        return step(o, pa, mf, mv, a)

    with torch.no_grad():
        got = evaluate_sequence_smt_batched(counting_step, obs, mem0, masks, actions, chunk=6)
        want = evaluate_sequence_smt(step, obs, mem0, masks, actions)
    assert rows == [3 * 2] * 3  # 9 % 6 != 0: chunk 3, three calls of 3 steps x 2 envs
    assert got[0].shape == (9, 2) and got[3].shape == (9, 2, 4)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-5, rtol=0)
