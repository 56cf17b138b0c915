"""The port's AVLEN updates (avlen_tpu_torch/rl/ppo_interactive.py) against
the JAX package's on the CPU, with the stub closures of
tests/test_ppo_interactive.py made to read their ring memories: a whole
``ppo_update_interactive`` handed JAX's permutations, sequential and
batched (parameters 1e-6, stats 1e-5); ``rl_mask`` 0 blocks the policy
gradient; ``dialog_supervised_update``'s loss and parameters (1e-6), with
and without the stored CLIP embeddings, including a trajectory whose
weights sum below 1 (where ``F.cross_entropy(weight=...)`` would differ);
and the batched option and dialog re-evaluations equal the sequential
ones."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from avlen_tpu.models.memory import SMTMemory as JaxMemory
from avlen_tpu.rl import ppo as jppo
from avlen_tpu.rl import ppo_interactive as jpi
from avlen_tpu.rl.gae import compute_gae as jax_gae
from avlen_tpu_torch.models.memory import SMTMemory
from avlen_tpu_torch.rl import ppo
from avlen_tpu_torch.rl import ppo_interactive as pi
from avlen_tpu_torch.rl.gae import compute_gae

torch.set_num_threads(1)

T, B, F_, QC, D, M, MV, CW = 6, 4, 8, 16, 12, 4, 3, 5
CFG = jppo.PPOConfig(ppo_epoch=2, num_mini_batch=2, lr=1e-2, entropy_coef=0.05, max_grad_norm=0.5)


def _run_jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_llvm_disable_expensive_passes": True})(*args)


def _memory(rng, capacity, width):
    valid = (rng.rand(B, capacity) > 0.4).astype(np.float32)
    feats = (rng.randn(B, capacity, width) * valid[..., None]).astype(np.float32)
    return feats, valid, rng.randint(0, capacity, (B,)).astype(np.int32)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and len(tree) == 3 and not isinstance(tree[0], tuple):
        return JaxMemory(*(jnp.asarray(x) for x in tree))
    if isinstance(tree, tuple):
        return tuple(_to_jax(v) for v in tree)
    return jnp.asarray(tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and len(tree) == 3 and not isinstance(tree[0], tuple):
        f, v, i = tree
        return SMTMemory(torch.tensor(f), torch.tensor(v), torch.tensor(i).long())
    if isinstance(tree, tuple):
        return tuple(_to_torch(v) for v in tree)
    return torch.tensor(tree)


def _traj(seed, rl_zero=False):
    rng = np.random.RandomState(seed)
    params = {k: (0.3 * rng.randn(*s)).astype(np.float32) for k, s in
              (("w", (F_ + QC, 2)), ("v", (F_ + QC,)), ("u", (F_ + QC, 2)), ("m", (F_ + QC, 2)))}
    traj = {
        "obs": {"x": rng.randn(T, B, F_).astype(np.float32), "__prev_action": np.zeros((T, B), np.int32)},
        "feat_option": rng.randn(T, B, F_ + QC).astype(np.float32),
        "query_state": rng.randn(T, B, QC).astype(np.float32),
        "last_query_info": rng.randn(T, B, QC).astype(np.float32),
        "masks": (rng.rand(T, B) > 0.25).astype(np.float32),
        "actions_option": rng.randint(0, 2, (T, B)).astype(np.int32),
        "log_probs_option": (-np.abs(rng.randn(T, B)) - 0.3).astype(np.float32),
        "values_option": rng.randn(T, B).astype(np.float32),
        "rewards": rng.randn(T, B).astype(np.float32),
        "dones": rng.rand(T, B) > 0.8,
        "bootstrap_value": rng.randn(B).astype(np.float32),
        "rl_mask": np.zeros((T, B), np.float32) if rl_zero else (rng.rand(T, B) > 0.3).astype(np.float32),
        "ucnt_gt": rng.randint(0, 2, (T, B)).astype(np.int32),
        "initial_memories": (_memory(rng, M, F_), _memory(rng, M, F_ + QC), _memory(rng, MV, F_),
                             _memory(rng, MV, D)),
    }
    return params, traj


def _jax_option_step(p, obs, pa, mf, mv, qs, lqi, actions):
    feat = jnp.concatenate([obs["x"], qs], -1)
    mem = (mf * mv[..., None]).sum(1)
    logits = feat @ p["w"] + mem @ p["m"]
    logp = jax.nn.log_softmax(logits)
    lp = jnp.take_along_axis(logp, actions[:, None], 1)[:, 0]
    ent = -(jnp.exp(logp) * logp).sum(-1)
    return feat @ p["v"], lp, ent, logits, feat @ p["u"] + 0.1 * mem @ p["m"], feat


def _torch_option_step(p):
    def step(obs, pa, mf, mv, qs, lqi, actions):
        feat = torch.cat([obs["x"], qs], -1)
        mem = (mf * mv[..., None]).sum(1)
        logits = feat @ p["w"] + mem @ p["m"]
        logp = F.log_softmax(logits, -1)
        lp = logp.gather(1, actions[:, None].long())[:, 0]
        ent = -(logp.exp() * logp).sum(-1)
        return feat @ p["v"], lp, ent, logits, feat @ p["u"] + 0.1 * mem @ p["m"], feat

    return step


def _jax_perms(key, b, epochs):
    perms = []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        perms.append(np.array(jax.random.permutation(sub, b)))
    return perms


def _torch_params(params):
    return {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}


@pytest.mark.parametrize("chunk", [0, 3])
def test_ppo_update_interactive_matches_jax_with_its_permutations(chunk):
    params, traj = _traj(0)
    jtraj = _to_jax(traj)
    adv, ret = jax_gae(jtraj["rewards"], jtraj["values_option"], jtraj["bootstrap_value"],
                       1.0 - jtraj["dones"].astype(jnp.float32), CFG.gamma, CFG.tau)
    key = jax.random.key(5)
    opt = jppo.make_optimizer(CFG)
    jp, _, jstats = _run_jit(lambda p, t: jpi.ppo_update_interactive(
        p, opt.init(p), t, adv, ret, key, _jax_option_step, opt, CFG, unct_coef=0.5, batched_chunk=chunk),
        _to_jax(params), jtraj)

    ttraj = _to_torch(traj)
    tadv, tret = compute_gae(ttraj["rewards"], ttraj["values_option"], ttraj["bootstrap_value"],
                             1.0 - ttraj["dones"].float(), CFG.gamma, CFG.tau)
    tp = _torch_params(params)
    topt = ppo.make_optimizer(tp.values(), ppo.PPOConfig(**dataclasses.asdict(CFG)))
    stats = pi.ppo_update_interactive(_torch_option_step(tp), topt, ttraj, tadv, tret, topt.config,
                                      unct_coef=0.5, perms=_jax_perms(key, B, CFG.ppo_epoch), batched_chunk=chunk)
    assert topt.count == CFG.ppo_epoch * CFG.num_mini_batch
    assert set(stats) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(stats[k].item(), float(jstats[k]), atol=1e-5, rtol=0, err_msg=k)
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0, err_msg=k)
        assert not np.allclose(np.asarray(jp[k]), params[k])


def test_rl_mask_zero_blocks_policy_gradient():
    """With rl_mask all zero and no entropy or uncertainty term, the actor
    head gets no gradient (the JAX test of the same name)."""
    params, traj = _traj(1, rl_zero=True)
    ttraj = _to_torch(traj)
    tp = _torch_params(params)
    step = _torch_option_step(tp)

    def no_value_grad(obs, pa, mf, mv, qs, lqi, actions):
        v, lp, ent, logits, unct, x = step(obs, pa, mf, mv, qs, lqi, actions)
        return torch.cat([obs["x"], qs], -1) @ tp["v"], lp, ent, logits, unct, x

    cfg = ppo.PPOConfig(ppo_epoch=1, num_mini_batch=1, entropy_coef=0.0)
    tadv, tret = compute_gae(ttraj["rewards"], ttraj["values_option"], ttraj["bootstrap_value"],
                             1.0 - ttraj["dones"].float())
    opt = torch.optim.SGD(tp.values(), lr=1e-2)
    pi.ppo_update_interactive(no_value_grad, opt, ttraj, tadv, tret, cfg, unct_coef=0.0,
                              perms=[torch.arange(B)])
    for k in ("w", "m", "u"):
        np.testing.assert_array_equal(tp[k].detach().numpy(), params[k], err_msg=k)
    assert not np.allclose(tp["v"].detach().numpy(), params["v"])


def _dialog_traj(seed, sparse=False):
    rng = np.random.RandomState(seed)
    _, base = _traj(seed)
    o_action = rng.randint(0, 4, (T, B)).astype(np.int32)
    queried = rng.rand(T, B) > 0.4
    o_mask = (rng.rand(T, B) > 0.2).astype(np.float32)
    if sparse:  # two weighted steps: Σw = 2/3 < 1
        o_action[:] = 0
        o_action[1, 2] = o_action[4, 0] = 2
        queried[1, 2] = queried[4, 0] = True
        o_mask[1, 2] = o_mask[4, 0] = 1.0
    traj = {
        "obs": base["obs"],
        "feat_vln": rng.randn(T, B, F_).astype(np.float32),
        "feat_vln_dialog": rng.randn(T, B, D).astype(np.float32),
        "dialog": rng.randint(0, 9, (T, B, 77)).astype(np.int32),
        "dialog_clip": rng.randn(T, B, CW).astype(np.float32),
        "agent_step": rng.randint(0, 3, (T, B)).astype(np.int32),
        "masks_vln": (rng.rand(T, B) > 0.35).astype(np.float32),
        "o_action": o_action,
        "o_mask": o_mask,
        "queried": queried,
        "initial_memories": base["initial_memories"],
    }
    params = {k: (0.3 * rng.randn(*s)).astype(np.float32) for k, s in
              (("w", (F_, 4)), ("m", (F_, 4)), ("s", (D, 4)), ("c", (CW, 4)), ("t", (77, 4)))}
    return params, traj


def _jax_dialog_step(p, obs, pa, mf, mv, smf, smv, dialog, step, actions, dclip=None):
    logits = (obs["x"] @ p["w"] + (mf * mv[..., None]).sum(1) @ p["m"] + (smf * smv[..., None]).sum(1) @ p["s"]
              + 0.1 * step[:, None])
    # the stored embedding, else a stand-in for the tower on the tokens
    logits = logits + (dclip @ p["c"] if dclip is not None else (dialog.astype(jnp.float32) / 9) @ p["t"])
    v = logits[:, 0]
    return v, jnp.zeros_like(v), jnp.zeros_like(v), logits, obs["x"], jnp.zeros((v.shape[0], D))


def _torch_dialog_step(p):
    def step_fn(obs, pa, mf, mv, smf, smv, dialog, step, actions, dclip=None):
        logits = (obs["x"] @ p["w"] + (mf * mv[..., None]).sum(1) @ p["m"] + (smf * smv[..., None]).sum(1) @ p["s"]
                  + 0.1 * step[:, None])
        logits = logits + (dclip @ p["c"] if dclip is not None else (dialog.float() / 9) @ p["t"])
        v = logits[:, 0]
        return v, torch.zeros_like(v), torch.zeros_like(v), logits, obs["x"], torch.zeros(v.shape[0], D)

    return step_fn


@pytest.mark.parametrize("case", ["replay", "replay_sparse", "all_steps", "no_clip_batched"])
def test_dialog_supervised_update_matches_jax(case):
    params, traj = _dialog_traj(2, sparse=case == "replay_sparse")
    if case == "no_clip_batched":
        traj["dialog_clip"] = np.zeros((T, B, 0), np.float32)  # width 0: no stored embedding
    replay_only = case != "all_steps"
    chunk = 3 if case == "no_clip_batched" else 0
    opt = optax.adam(1e-2, eps=1e-5)
    jp, _, jloss = _run_jit(lambda p, t: jpi.dialog_supervised_update(
        p, opt.init(p), t, _jax_dialog_step, opt, replay_only=replay_only, batched_chunk=chunk),
        _to_jax(params), _to_jax(traj))
    tp = _torch_params(params)
    topt = torch.optim.Adam(tp.values(), lr=1e-2, eps=1e-5)
    loss = pi.dialog_supervised_update(_torch_dialog_step(tp), topt, _to_torch(traj), replay_only=replay_only,
                                       batched_chunk=chunk)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-6, rtol=0)
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0, err_msg=k)
    unused = "c" if case == "no_clip_batched" else "t"
    np.testing.assert_array_equal(tp[unused].detach().numpy(), params[unused])
    if case == "replay_sparse":
        # Σw = 2/3: the floor at 1 makes the loss 2/3 of the weighted mean
        t = _to_torch(traj)
        with torch.no_grad():
            logits = pi.evaluate_dialog_sequence(_torch_dialog_step(_torch_params(params)), t["obs"], t["feat_vln"],
                                                 t["feat_vln_dialog"], t["dialog"], t["agent_step"], t["masks_vln"],
                                                 t["o_action"], *t["initial_memories"][2:],
                                                 dialog_clip=t["dialog_clip"])
        w = torch.tensor(pi.DIALOG_CLASS_WEIGHTS)[t["o_action"].long()] * t["o_mask"] * t["queried"].float()
        assert abs(w.sum().item() - 2 / 3) < 1e-6
        weighted_mean = F.cross_entropy(logits.reshape(-1, 4), t["o_action"].reshape(-1).long(),
                                        weight=torch.tensor(pi.DIALOG_CLASS_WEIGHTS), reduction="none")
        weighted_mean = (weighted_mean * (t["o_mask"] * t["queried"].float()).reshape(-1)).sum() / w.sum()
        np.testing.assert_allclose(float(jloss), 2 / 3 * weighted_mean.item(), rtol=1e-5)


def test_batched_sequences_equal_sequential():
    params, traj = _traj(3)
    t = _to_torch(traj)
    step = _torch_option_step(_torch_params(params))
    args = (t["obs"], t["feat_option"], t["query_state"], t["last_query_info"], t["masks"], t["actions_option"],
            t["initial_memories"][1])
    with torch.no_grad():
        seq = pi.evaluate_option_sequence(step, *args)
        for chunk in (1, 2, 3, 6):
            for s, b in zip(seq, pi.evaluate_option_sequence_batched(step, *args, chunk=chunk)):
                torch.testing.assert_close(b, s, rtol=0, atol=1e-6)

    dparams, dtraj = _dialog_traj(4)
    d = _to_torch(dtraj)
    dstep = _torch_dialog_step(_torch_params(dparams))
    dargs = (d["obs"], d["feat_vln"], d["feat_vln_dialog"], d["dialog"], d["agent_step"], d["masks_vln"],
             d["o_action"], *d["initial_memories"][2:])
    with torch.no_grad():
        for clip in (d["dialog_clip"], torch.zeros(T, B, 0), None):
            seq = pi.evaluate_dialog_sequence(dstep, *dargs, dialog_clip=clip)
            for chunk in (2, 3):
                torch.testing.assert_close(pi.evaluate_dialog_sequence_batched(dstep, *dargs, chunk=chunk,
                                                                               dialog_clip=clip),
                                           seq, rtol=0, atol=1e-6)
